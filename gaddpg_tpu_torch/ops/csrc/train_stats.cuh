// Pieces of the train-mode set-abstraction kernels (sa_train_stats.cu):
// the group-all stats pass of K6 over a block's rows, and the
// fixed-order reduction of per-block (K6) or per-tile (K5) partial sums
// into the batch mean and variance.
#pragma once

#include "common.cuh"

namespace gaddpg {

// The three Dense layers of a train SA level and the BatchNorm affine
// (gain a, offset c with bn(z) = z*a + c) of the layers before the one
// whose statistics a pass computes. width = {C_in, C1, C2, C3}.
struct TrainMlp {
  const float* w[3];
  const float* b[3];
  const float* gain[2];
  const float* offset[2];
  int width[4];
};

// Shared memory of one stats block: the input tile (rows x max(C_in,
// C2)), reused for the second hidden layer, the first hidden layer, and
// the per-row-group partial sums of layer `upto`.
__host__ __device__ inline size_t stats_smem_floats(int rows, const int* width, int upto,
                                                    int threads) {
  const int a = width[0] > width[2] ? width[0] : width[2];
  const int cout = width[upto];
  return static_cast<size_t>(rows) * a + static_cast<size_t>(rows) * width[1] +
         2 * static_cast<size_t>(dense_groups(cout, threads)) * cout;
}

// On the tile already in smem[0 : rows*C_in] (the caller synchronises
// after loading it): layers 1..upto-1 as relu((h@w + b)*a + c), then
// layer `upto` as z = h@w + b, and writes the block's sum of z over its
// rows to partial[0:cout] and its sum of z*z to partial[cout:2*cout].
// Every sum runs in a fixed order, so equal inputs give equal bits.
__device__ __forceinline__ void mlp_stats(float* smem, int rows, const TrainMlp& p, int upto,
                                          float* __restrict__ partial) {
  const int a = p.width[0] > p.width[2] ? p.width[0] : p.width[2];
  float* x = smem;                      // rows x C_in, then rows x C2
  float* h1 = smem + rows * a;          // rows x C1
  float* sums = h1 + rows * p.width[1]; // [groups][2][cout]
  float* hidden[2] = {h1, x};
  const float* in = x;
  for (int l = 0; l + 1 < upto; ++l) {
    dense_layer<Epilogue::kStore>(in, rows, p.width[l], p.w[l], p.b[l], p.gain[l],
                                  p.offset[l], p.width[l + 1], hidden[l]);
    __syncthreads();
    in = hidden[l];
  }
  const int cout = p.width[upto];
  dense_layer<Epilogue::kStats>(in, rows, p.width[upto - 1], p.w[upto - 1], p.b[upto - 1],
                                nullptr, nullptr, cout, sums);
  __syncthreads();
  const int groups = dense_groups(cout, blockDim.x);
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    for (int g = 0; g < groups; ++g) {
      s += sums[(2 * g) * cout + c];
      q += sums[(2 * g + 1) * cout + c];
    }
    partial[c] = s;
    partial[cout + c] = q;
  }
}

constexpr int kReduceCols = 32;  // channels per block, one per lane
constexpr int kReduceRows = 16;  // partials summed side by side

// mean[c] = sum / count and var[c] = sumsq / count - mean^2 (no clamp,
// as pallas_sa_train.py:229-231 computes them) from partial (parts, 2, cout).
// With `rows` (a count on the device, K5's compacted rows) the partials
// are those of its ceil(rows / row_tile) tiles instead of `parts`.
// Thread (x, y) sums partials y, y + kReduceRows, ... of channel x in
// double, then row 0 adds the kReduceRows sums in order: no atomics, so
// two runs give the same bits; a warp reads 32 adjacent channels.
__global__ void __launch_bounds__(kReduceCols * kReduceRows) reduce_stats_kernel(
    const float* __restrict__ partial, int parts, const int* __restrict__ rows, int row_tile,
    int cout, double count, float* __restrict__ mean, float* __restrict__ var) {
  __shared__ double s_sum[kReduceRows][kReduceCols];
  __shared__ double s_sq[kReduceRows][kReduceCols];
  if (rows != nullptr) parts = (*rows + row_tile - 1) / row_tile;
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  double s = 0.0, q = 0.0;
  if (c < cout) {
    for (int p = threadIdx.y; p < parts; p += kReduceRows) {
      s += partial[(2 * static_cast<size_t>(p)) * cout + c];
      q += partial[(2 * static_cast<size_t>(p) + 1) * cout + c];
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = s;
  s_sq[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < cout) {
    for (int r = 1; r < kReduceRows; ++r) {
      s += s_sum[r][threadIdx.x];
      q += s_sq[r][threadIdx.x];
    }
    const double m = s / count;
    mean[c] = static_cast<float>(m);
    var[c] = static_cast<float>(q / count - m * m);
  }
}

inline cudaError_t launch_reduce_stats(const float* partial, int parts, const int* rows,
                                       int row_tile, int cout, double count, float* mean,
                                       float* var, cudaStream_t stream) {
  const dim3 block(kReduceCols, kReduceRows);
  reduce_stats_kernel<<<(cout + kReduceCols - 1) / kReduceCols, block, 0, stream>>>(
      partial, parts, rows, row_tile, cout, count, mean, var);
  return cudaGetLastError();
}

// TrainMlp from the C entry's pointers (unused layers' pointers may be
// null: a pass reads layers 1..upto and the affine of layers 1..upto-1).
inline TrainMlp train_mlp(const void* w1, const void* b1, const void* g1, const void* o1,
                          const void* w2, const void* b2, const void* g2, const void* o2,
                          const void* w3, const void* b3, int cin, int c1, int c2, int c3) {
  TrainMlp p;
  p.w[0] = static_cast<const float*>(w1);
  p.w[1] = static_cast<const float*>(w2);
  p.w[2] = static_cast<const float*>(w3);
  p.b[0] = static_cast<const float*>(b1);
  p.b[1] = static_cast<const float*>(b2);
  p.b[2] = static_cast<const float*>(b3);
  p.gain[0] = static_cast<const float*>(g1);
  p.gain[1] = static_cast<const float*>(g2);
  p.offset[0] = static_cast<const float*>(o1);
  p.offset[1] = static_cast<const float*>(o2);
  p.width[0] = cin;
  p.width[1] = c1;
  p.width[2] = c2;
  p.width[3] = c3;
  return p;
}

}  // namespace gaddpg
