// K5/K6: batch statistics of a train-mode set-abstraction level, one
// layer per pass.
//
// Replaces the stats half of the Pallas kernels `sa_train_fused`
// (`_stats_kernel` and `_run_stats`, gaddpg_tpu/ops/pallas_sa_train.py:
// 138-177, 207-232) and `groupall_train_fused` (`_groupall_stats_kernel`
// and `_pallas_groupall_train`, :367-386, 399-427). Pass `upto` (1, 2, 3)
// gathers each centre's K group members' rows of the (N, C_in) point
// table, subtracts the centre row (xyz in cols 0:3, zero elsewhere),
// recomputes layers 1..upto-1 with the BatchNorm affine of the earlier
// passes' batch statistics, runs layer `upto` up to its pre-BatchNorm
// output z, and accumulates per-channel sum and sum of squares of z over
// all B*S*K rows; then mean = sum/count and var = sumsq/count - mean^2.
// The group-all level (K6) is the same pass with an identity gather and
// no centring: idx and cpad null, one "centre" per cloud (S = 1) whose K
// = N rows are the whole table. The level's final forward is K3
// (sa_gather_mlp.cu) or K4 (mlp_maxpool.cu) on weights folded with the
// three batch-stat affines, launched by the wrapper (ops/sa_train.py).
//
// What bounds it on H100: FLOPs. The function needs each layer once per
// row; the three passes recompute layers 1..upto-1, so at SA2 (K=128,
// 131->128->128->256) they do 2*128*(16,768 + 33,152 + 65,920) = 29.7
// MFLOP per centre, 1.76x the function's 16.9 MFLOP, against ~70 KB of
// input rows; the activations never leave shared memory.
// Design: one block per (cloud, centre), as K3: the gather is an indexed
// load (never the TPU's one-hot matmul, whose rounding caused the
// round-5 train drift) into shared memory, and the layers run with K3's
// 8x4 register-tiled dense layer (common.cuh). The TPU kernel carried
// its sums across the sequential grid; here each block writes its own
// partial sums, and a second kernel adds the partials per channel in a
// fixed order (train_stats.cuh), so there are no float atomics and two
// runs give the same bits. Plain fp32 FMA on the CUDA cores.

#include <cstdint>
#include <initializer_list>

#include "train_stats.cuh"

namespace {

constexpr int kThreads = 512;
// group-all blocks: at N = 32 rows and 256-wide layers, 256 threads make
// 4 row groups of 8 rows, all busy; 512 would leave half of them idle
constexpr int kGroupAllThreads = 256;

__global__ void __launch_bounds__(kThreads) sa_train_stats_kernel(
    const int* __restrict__ idx, const float* __restrict__ full,
    const float* __restrict__ cpad, gaddpg::TrainMlp mlp, float* __restrict__ partial,
    int s, int k, int n, int upto) {
  extern __shared__ float smem[];
  const int cin = mlp.width[0];
  const int centre = blockIdx.x;  // b * s + centre within the cloud
  const float* table = full + static_cast<size_t>(centre / s) * n * cin;
  const int* group = idx == nullptr ? nullptr : idx + static_cast<size_t>(centre) * k;
  const float* offset = cpad == nullptr ? nullptr : cpad + static_cast<size_t>(centre) * cin;
  for (int e = threadIdx.x; e < k * cin; e += blockDim.x) {
    const int r = e / cin;
    const int j = e - r * cin;
    const int row = group == nullptr ? r : group[r];
    // an index outside [0, n) reads a zero row, as in K3
    const float v = (row >= 0 && row < n) ? table[static_cast<size_t>(row) * cin + j] : 0.0f;
    smem[e] = offset == nullptr ? v : v - offset[j];
  }
  __syncthreads();
  const int cout = mlp.width[upto];
  gaddpg::mlp_stats(smem, k, mlp, upto, partial + static_cast<size_t>(centre) * 2 * cout);
}

}  // namespace

// idx (b, s, k) int32, or null for the group-all level (s = 1, k = n,
// row r of the block is row r of its cloud); full (b, n, cin); cpad (b,
// s, cin), or null for no centring; w_i (c_{i-1}, c_i) row-major, 16-byte
// aligned, and b_i (c_i,) the raw Dense parameters; g_i, o_i (c_i,) the
// BatchNorm affine of layer i (read for i < upto, may be null
// otherwise); partial (b*s, 2, c_upto) scratch; mean, var (c_upto,) the
// outputs. All float32 contiguous. Returns cudaErrorInvalidValue for a
// layer width that is not a multiple of 4, unaligned weights, or (from
// allow_smem) a tile that does not fit in shared memory.
extern "C" int gaddpg_sa_train_stats(
    const void* idx, const void* full, const void* cpad, const void* w1, const void* b1,
    const void* g1, const void* o1, const void* w2, const void* b2, const void* g2,
    const void* o2, const void* w3, const void* b3, void* partial, void* mean, void* var,
    int b, int s, int k, int n, int cin, int c1, int c2, int c3, int upto, void* stream) {
  if (upto < 1 || upto > 3) return cudaErrorInvalidValue;
  for (const int c : {c1, c2, c3}) {
    if (c % gaddpg::kTileCols) return cudaErrorInvalidValue;
  }
  for (const void* w : {w1, w2, w3}) {
    if (reinterpret_cast<uintptr_t>(w) % 16) return cudaErrorInvalidValue;
  }
  const gaddpg::TrainMlp mlp =
      gaddpg::train_mlp(w1, b1, g1, o1, w2, b2, g2, o2, w3, b3, cin, c1, c2, c3);
  const int threads = idx == nullptr ? kGroupAllThreads : kThreads;
  const size_t smem = gaddpg::stats_smem_floats(k, mlp.width, upto, threads) * sizeof(float);
  cudaError_t err = gaddpg::allow_smem(sa_train_stats_kernel, smem);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sa_train_stats_kernel<<<b * s, threads, smem, st>>>(
      static_cast<const int*>(idx), static_cast<const float*>(full),
      static_cast<const float*>(cpad), mlp, static_cast<float*>(partial), s, k, n, upto);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gaddpg::launch_reduce_stats(static_cast<const float*>(partial), b * s, mlp.width[upto],
                                     static_cast<double>(b) * s * k, static_cast<float*>(mean),
                                     static_cast<float*>(var), st);
}
