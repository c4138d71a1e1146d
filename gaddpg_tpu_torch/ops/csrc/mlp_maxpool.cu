// K4: eval group-all set-abstraction level (3x folded Dense+ReLU -> max).
//
// Replaces the Pallas kernel `_mlp_maxpool_kernel` / `mlp_maxpool`
// (gaddpg_tpu/ops/pallas_sa.py:109-163): every row of a cloud's (N, C_in)
// table goes through three Dense layers with BatchNorm folded in, each
// followed by ReLU, and the block max-reduces over the N rows.
//
// What bounds it on H100: FLOPs. At SA3 (N=32, 259->256->256->512) one
// cloud is 2*32*262,912 = 16.8 MFLOP against 33 KB of input; the 1.05 MB
// of folded weights do not fit in shared memory and are read from global
// memory, where they stay in L2 across blocks.
// Design: one block per cloud, the input tile and hidden activations in
// shared memory (66 KB, dynamic), the same 8x4 register-tiled
// dense+ReLU as K3 (common.cuh) with the last layer max-reduced into a
// shared row.
// At batch 1 this is a single block on one SM: latency, not throughput,
// is what a later PR would attack (split the output columns over blocks).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) mlp_maxpool_kernel(
    const float* __restrict__ full, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, float* __restrict__ out, int n, int cin,
    int c1, int c2, int c3) {
  extern __shared__ float smem[];
  const float* table = full + static_cast<size_t>(blockIdx.x) * n * cin;
  for (int e = threadIdx.x; e < n * cin; e += blockDim.x) smem[e] = table[e];
  __syncthreads();
  const float* pool = gaddpg::mlp3_maxpool(smem, n, cin, w1, b1, c1, w2, b2, c2, w3, b3, c3);
  float* o = out + static_cast<size_t>(blockIdx.x) * c3;
  for (int c = threadIdx.x; c < c3; c += blockDim.x) o[c] = pool[c];
}

}  // namespace

// full (b, n, cin); w_i (c_{i-1}, c_i) row-major and b_i (c_i,) with
// BatchNorm folded in; out (b, c3). All float32 contiguous.
extern "C" int gaddpg_mlp_maxpool(const void* full, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* b3, void* out, int b, int n, int cin,
                                  int c1, int c2, int c3, void* stream) {
  const size_t smem = gaddpg::mlp_smem_floats(n, cin, c1, c2, c3) * sizeof(float);
  cudaError_t err = gaddpg::allow_smem(mlp_maxpool_kernel, smem);
  if (err != cudaSuccess) return err;
  mlp_maxpool_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(full), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), n, cin, c1, c2, c3);
  return cudaGetLastError();
}
