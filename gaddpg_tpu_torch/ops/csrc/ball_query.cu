// K2: ball query (first nsample in-radius points of each centre).
//
// Replaces the Pallas kernel `_ball_group_kernel` / `ball_query_pallas`
// (gaddpg_tpu/ops/pallas_kernels.py:119-182). Semantics: the first
// nsample points with |c - p|^2 <= r^2, in index order; slots left over
// (also when nsample > n, as at SA2) repeat the first hit; a centre with
// no hit gets its nearest point (lowest index on ties) in every slot.
//
// What bounds it on H100: latency and the scan, not bytes or FLOPs (a
// 1024-point cloud is 12 KB, ~8 FLOPs per point). The TPU kernel builds
// the whole (S, N) distance matrix and extracts the first k by repeated
// min; here one warp serves one centre and scans the points 32 at a time
// in index order: __ballot_sync marks the hits, __popc of the lower lanes
// gives each hit its slot, so order is kept without sorting, and the
// warp stops as soon as nsample hits are found. Each lane tracks its own
// nearest point on the way, reduced across the warp only for a centre
// with no hit. Distances round exactly like the plain version.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void ball_query_kernel(const float* __restrict__ centers,
                                  const float* __restrict__ xyz, int total,
                                  int s, int n, float r2, int nsample,
                                  int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int cid = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cid >= total) return;  // uniform across the warp
  const float* p = xyz + static_cast<size_t>(cid / s) * n * 3;
  const float cx = centers[3 * cid], cy = centers[3 * cid + 1], cz = centers[3 * cid + 2];
  int* o = out + static_cast<size_t>(cid) * nsample;

  int count = 0;  // hits so far, uniform across the warp
  int first = 0;
  float dmin = __int_as_float(0x7f800000);  // +inf
  int imin = n;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < n) {
      const float d2 = gaddpg::sq_dist(cx, cy, cz, p[3 * j], p[3 * j + 1], p[3 * j + 2]);
      hit = d2 <= r2;
      if (d2 < dmin) {
        dmin = d2;
        imin = j;
      }
    }
    const unsigned mask = __ballot_sync(gaddpg::kFullMask, hit);
    if (mask != 0u) {
      if (count == 0) first = base + __ffs(mask) - 1;
      const int slot = count + __popc(mask & ((1u << lane) - 1u));
      if (hit && slot < nsample) o[slot] = j;
      count += __popc(mask);
      if (count >= nsample) break;
    }
  }
  if (count == 0) {
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(gaddpg::kFullMask, dmin, off);
      const int k = __shfl_down_sync(gaddpg::kFullMask, imin, off);
      if (v < dmin || (v == dmin && k < imin)) {
        dmin = v;
        imin = k;
      }
    }
    first = __shfl_sync(gaddpg::kFullMask, imin, 0);
  }
  for (int k = min(count, nsample) + lane; k < nsample; k += 32) o[k] = first;
}

}  // namespace

// centers (b, s, 3), xyz (b, n, 3) float32 contiguous -> out (b, s, nsample)
// int32. r2 is the squared radius, already rounded to float32.
extern "C" int gaddpg_ball_query(const void* centers, const void* xyz, int b, int s,
                                 int n, float r2, int nsample, void* out,
                                 void* stream) {
  const int total = b * s;
  const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const float*>(xyz), total, s, n,
      r2, nsample, static_cast<int*>(out));
  return cudaGetLastError();
}
