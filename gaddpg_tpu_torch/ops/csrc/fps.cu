// K1: furthest point sampling.
//
// Replaces the Pallas kernel `_fps_kernel` / `fps_pallas`
// (gaddpg_tpu/ops/pallas_kernels.py:62-111). Semantics: start at index
// 0, keep a running min-distance register initialised to 1e10, and at
// each of npoint-1 steps pick the point with the largest register value,
// ties to the lowest index.
//
// What bounds it on H100: neither bytes (a 1024-point cloud is 12 KB) nor
// FLOPs (~9 per point per step), but latency: npoint-1 dependent steps,
// each a block-wide argmax. The design keeps the whole cloud and its
// distance register in shared memory for the full chain (one block per
// cloud, the batch spread over the SMs) and pays two block barriers per
// step; a 32-point cloud (SA2) is a single warp. Distances are rounded
// exactly like the plain version (gaddpg::sq_dist), so indices match.

#include "common.cuh"

namespace {

__global__ void fps_kernel(const float* __restrict__ xyz, int n, int npoint,
                           int* __restrict__ out) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = smem + n;
  float* pz = smem + 2 * n;
  float* dist = smem + 3 * n;
  __shared__ float red_val[32];
  __shared__ int red_idx[32];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;

  for (int j = tid; j < n; j += blockDim.x) {
    px[j] = p[3 * j];
    py[j] = p[3 * j + 1];
    pz[j] = p[3 * j + 2];
    dist[j] = 1e10f;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int i = 1; i < npoint; ++i) {
    const float lx = px[last], ly = py[last], lz = pz[last];
    float best = -1.0f;
    int best_idx = n;
    // each thread owns the points j = tid (mod blockDim), visited in
    // increasing order, so a strict > keeps its lowest index on ties
    for (int j = tid; j < n; j += blockDim.x) {
      const float d = fminf(dist[j], gaddpg::sq_dist(px[j], py[j], pz[j], lx, ly, lz));
      dist[j] = d;
      if (d > best) {
        best = d;
        best_idx = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(gaddpg::kFullMask, best, off);
      const int k = __shfl_down_sync(gaddpg::kFullMask, best_idx, off);
      if (v > best || (v == best && k < best_idx)) {
        best = v;
        best_idx = k;
      }
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = best_idx;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_val[lane] : -1.0f;
      best_idx = lane < nwarps ? red_idx[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(gaddpg::kFullMask, best, off);
        const int k = __shfl_down_sync(gaddpg::kFullMask, best_idx, off);
        if (v > best || (v == best && k < best_idx)) {
          best = v;
          best_idx = k;
        }
      }
      if (lane == 0) {
        s_last = best_idx;
        o[i] = best_idx;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

// xyz (b, n, 3) float32 contiguous -> out (b, npoint) int32.
extern "C" int gaddpg_fps(const void* xyz, int b, int n, int npoint, void* out,
                          void* stream) {
  const int warps = (n + 31) / 32;
  const int threads = 32 * (warps < 32 ? warps : 32);
  const size_t smem = static_cast<size_t>(4) * n * sizeof(float);
  cudaError_t err = gaddpg::allow_smem(fps_kernel, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, npoint, static_cast<int*>(out));
  return cudaGetLastError();
}
