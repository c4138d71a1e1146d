// K3: eval set-abstraction level (gather -> 3x folded Dense+ReLU -> max).
//
// Replaces the Pallas kernel `_sa_gather_mlp_kernel` / `sa_gather_mlp`
// (gaddpg_tpu/ops/pallas_sa.py:71-143). For each centre: gather its K
// group members' rows of the (N, C_in) point table, subtract the centre
// row (xyz in cols 0:3, zero elsewhere), run three Dense layers with
// BatchNorm folded in, each followed by ReLU, and max over the K rows.
//
// What bounds it on H100: FLOPs. At SA2 (K=128, 131->128->128->256) one
// centre is 2*128*65,920 = 16.9 MFLOP against ~70 KB of input rows, far
// above the card's ~20 FLOP/byte fp32 balance point; the weights (263 KB
// at SA2) are read by every block but stay resident in L2.
// Design: one block per (cloud, centre). The gather is an indexed load
// (never the TPU's one-hot matmul, whose rounding caused the round-5
// train drift) straight into shared memory; the three layers run on that
// tile with the activations in shared memory (SA2: 131 KB, hence the
// dynamic shared memory opt-in, and one block per SM), each thread
// holding an 8-row x 4-column register tile so that one float4 of w and
// 8 shared loads feed 32 FMAs; 512 threads per block keep 16 warps in
// flight on the SM. The last layer max-reduces into a shared row instead
// of storing. Plain fp32 FMA on the CUDA cores: no tensor cores yet.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) sa_gather_mlp_kernel(
    const int* __restrict__ idx, const float* __restrict__ full,
    const float* __restrict__ cpad, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, float* __restrict__ out, int s, int k, int n,
    int cin, int c1, int c2, int c3) {
  extern __shared__ float smem[];
  const int centre = blockIdx.x;  // b * s + centre within the cloud
  const float* table = full + static_cast<size_t>(centre / s) * n * cin;
  const int* group = idx + static_cast<size_t>(centre) * k;
  const float* offset = cpad + static_cast<size_t>(centre) * cin;

  for (int e = threadIdx.x; e < k * cin; e += blockDim.x) {
    const int r = e / cin;
    const int j = e - r * cin;
    const int row = group[r];
    // an index outside [0, n) reads a zero row, as the one-hot gather did
    const float v = (row >= 0 && row < n) ? table[static_cast<size_t>(row) * cin + j] : 0.0f;
    smem[e] = v - offset[j];
  }
  __syncthreads();
  const float* pool = gaddpg::mlp3_maxpool(smem, k, cin, w1, b1, c1, w2, b2, c2, w3, b3, c3);
  float* o = out + static_cast<size_t>(centre) * c3;
  for (int c = threadIdx.x; c < c3; c += blockDim.x) o[c] = pool[c];
}

}  // namespace

// idx (b, s, k) int32; full (b, n, cin); cpad (b, s, cin); w_i (c_{i-1}, c_i)
// row-major and b_i (c_i,) with BatchNorm folded in; out (b, s, c3).
// All float32 contiguous.
extern "C" int gaddpg_sa_gather_mlp(const void* idx, const void* full, const void* cpad,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* w3, const void* b3,
                                    void* out, int b, int s, int k, int n, int cin,
                                    int c1, int c2, int c3, void* stream) {
  const size_t smem = gaddpg::mlp_smem_floats(k, cin, c1, c2, c3) * sizeof(float);
  cudaError_t err = gaddpg::allow_smem(sa_gather_mlp_kernel, smem);
  if (err != cudaSuccess) return err;
  sa_gather_mlp_kernel<<<b * s, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(full),
      static_cast<const float*>(cpad), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), s, k, n, cin, c1, c2, c3);
  return cudaGetLastError();
}
