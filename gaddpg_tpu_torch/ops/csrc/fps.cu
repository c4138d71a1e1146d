// K1: furthest point sampling, one warp per cloud.
//
// Replaces the Pallas kernel `_fps_kernel` / `fps_pallas`
// (gaddpg_tpu/ops/pallas_kernels.py:62-111). Semantics: start at index
// 0, keep a running min-distance register initialised to 1e10, and at
// each of npoint-1 steps pick the point with the largest register value,
// ties to the lowest index.
//
// What bounds it on H100: neither bytes (a 1024-point cloud is 12 KB) nor
// FLOPs (~9 per point per step), but latency: npoint-1 dependent steps,
// each an argmax over the cloud. A block per cloud (the earlier design)
// paid two block barriers and a two-level reduction per step, for one or
// two points a thread, in 4 waves at B = 1024.
//
// Design: one warp owns one cloud, so a step needs no barrier. Lane l
// owns points l, l + 32, ... and visits them in increasing order, so a
// strict > keeps its lowest index on ties; one __shfl_xor_sync butterfly
// over (distance, index), ties to the lower index, leaves every lane with
// the winner. The cloud and its distance register live in the warp's own
// shared memory as one float4 per point (x, y, z, distance): a lane reads
// a point in one 16-byte load, the warp's 32 adjacent points without bank
// conflicts, and every lane reads the winner's coordinates in one
// broadcast load. Shared memory and not registers, so that no
// compile-time maximum bounds N: 16 bytes per point, up to 14,528 points
// per cloud with one warp per block (ops/sampling.py checks it). A block
// packs ceil(B / SMs) clouds, up to 8 (16 KB each at N = 1024: 128 KB),
// so B = 256 and B = 1024 alike are one wave of 128 blocks on the 132
// SMs. Distances are rounded exactly like the plain version
// (gaddpg::sq_dist), so the indices match.

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;         // clouds per block
constexpr int kSmemLimit = 232448;   // shared memory one block may use on H100

__global__ void fps_kernel(const float* __restrict__ xyz, int b, int n, int npoint,
                           int* __restrict__ out) {
  extern __shared__ float4 pts_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cloud = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cloud >= b) return;  // warp-uniform; no block barrier follows
  float4* pts = pts_smem + static_cast<size_t>(warp) * n;
  const float* p = xyz + static_cast<size_t>(cloud) * n * 3;
  int* o = out + static_cast<size_t>(cloud) * npoint;
  for (int j = lane; j < n; j += 32) {
    pts[j] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], 1e10f);
  }
  if (lane == 0) o[0] = 0;
  __syncwarp();

  int last = 0;
  for (int i = 1; i < npoint; ++i) {
    const float4 l = pts[last];
    float best = -1.0f;
    int best_idx = n;
#pragma unroll 4  // four points' loads in flight
    for (int j = lane; j < n; j += 32) {
      float4 q = pts[j];
      q.w = fminf(q.w, gaddpg::sq_dist(q.x, q.y, q.z, l.x, l.y, l.z));
      pts[j].w = q.w;
      if (q.w > best) {
        best = q.w;
        best_idx = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(gaddpg::kFullMask, best, off);
      const int k = __shfl_xor_sync(gaddpg::kFullMask, best_idx, off);
      if (v > best || (v == best && k < best_idx)) {
        best = v;
        best_idx = k;
      }
    }
    last = best_idx;
    if (lane == 0) o[i] = last;
    __syncwarp();  // this step's distance writes before the next step's reads
  }
}

}  // namespace

// xyz (b, n, 3) float32 contiguous -> out (b, npoint) int32. Returns
// cudaErrorInvalidValue when one cloud's 16 * n bytes exceed shared
// memory.
extern "C" int gaddpg_fps(const void* xyz, int b, int n, int npoint, void* out,
                          void* stream) {
  const size_t per_cloud = static_cast<size_t>(n) * sizeof(float4);
  if (n < 1 || npoint < 1 || per_cloud > kSmemLimit) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  // clouds per block: enough to put the batch in one wave of blocks over
  // the SMs, as far as shared memory and kMaxWarps allow
  const int sms = gaddpg::sm_count();
  int warps = (b + sms - 1) / sms;
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const int fit = static_cast<int>(kSmemLimit / per_cloud);
  warps = warps < fit ? warps : fit;
  const size_t smem = warps * per_cloud;
  cudaError_t err = gaddpg::allow_smem(fps_kernel, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<<<(b + warps - 1) / warps, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), b, n, npoint, static_cast<int*>(out));
  return cudaGetLastError();
}
