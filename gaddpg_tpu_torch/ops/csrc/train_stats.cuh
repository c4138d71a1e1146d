// The fixed-order reduction of the train-mode set-abstraction kernels'
// per-tile partial sums (K5, sa_train_stats.cu; K6, groupall_layer.cu)
// into the batch mean and variance, and the BatchNorm affine of those.
#pragma once

#include "common.cuh"

namespace gaddpg {

constexpr int kReduceCols = 32;  // channels per block, one per lane
constexpr int kReduceRows = 16;  // partials summed side by side
constexpr float kBnEps = 1e-5f;  // ops/sa_train.py BN_EPS

// The BatchNorm of one layer: its parameters and the affine (a, c) with
// bn(z) = z * a + c that the reduction writes.
struct BnAffine {
  const float* scale;
  const float* bias;
  float* a;
  float* c;
};

// mean = sum / count and var = sumsq / count - mean^2 (no clamp, as
// pallas_sa_train.py:229-231 computes them) of channel c, and bn.a =
// scale / sqrt(var + eps), bn.c = bias - mean * a in float32, each
// operation rounded as the plain version's (ops/sa_train.py `bn_affine`).
__device__ __forceinline__ void write_stats(double s, double q, double count, int c,
                                            float* __restrict__ mean, float* __restrict__ var,
                                            const BnAffine& bn) {
  const double m = s / count;
  const float mf = static_cast<float>(m);
  const float vf = static_cast<float>(q / count - m * m);
  mean[c] = mf;
  var[c] = vf;
  const float a = __fdiv_rn(bn.scale[c], __fsqrt_rn(__fadd_rn(vf, kBnEps)));
  bn.a[c] = a;
  bn.c[c] = __fsub_rn(bn.bias[c], __fmul_rn(mf, a));
}

// The statistics of partial (parts, 2, cout) over `count` rows: with
// `sums` null, mean, var and the affine (write_stats); with `sums` (2 *
// cout + 1 doubles), the sums of z and z^2 of each channel and, last, the
// row count, for a reduction across ranks whose result
// bn_from_sums_kernel turns into the same statistics (the split at the
// reduction of a data-parallel update).
// With `rows` (a count on the device, K5's compacted rows) the partials
// are those of its ceil(rows / row_tile) tiles instead of `parts`.
// Thread (x, y) sums partials y, y + kReduceRows, ... of channel x in
// double, then row 0 adds the kReduceRows sums in order: no atomics, so
// two runs give the same bits; a warp reads 32 adjacent channels.
__global__ void __launch_bounds__(kReduceCols * kReduceRows) reduce_stats_kernel(
    const float* __restrict__ partial, int parts, const int* __restrict__ rows, int row_tile,
    int cout, double count, float* __restrict__ mean, float* __restrict__ var, BnAffine bn,
    double* __restrict__ sums) {
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
    if (sums != nullptr) {
      sums[c] = s;
      sums[cout + c] = q;
      if (c == 0) sums[2 * cout] = count;
    } else {
      write_stats(s, q, count, c, mean, var, bn);
    }
  }
}

// The statistics and affine of sums (2 * cout + 1 doubles: the sums of z
// and of z^2 over every rank's rows, then their count), as
// reduce_stats_kernel writes them from one rank's partials.
__global__ void bn_from_sums_kernel(const double* __restrict__ sums, int cout,
                                    float* __restrict__ mean, float* __restrict__ var,
                                    BnAffine bn) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < cout) write_stats(sums[c], sums[cout + c], sums[2 * cout], c, mean, var, bn);
}

inline cudaError_t launch_reduce_stats(const float* partial, int parts, const int* rows,
                                       int row_tile, int cout, double count, float* mean,
                                       float* var, const BnAffine& bn, double* sums,
                                       cudaStream_t stream) {
  const dim3 block(kReduceCols, kReduceRows);
  reduce_stats_kernel<<<(cout + kReduceCols - 1) / kReduceCols, block, 0, stream>>>(
      partial, parts, rows, row_tile, cout, count, mean, var, bn, sums);
  return cudaGetLastError();
}

}  // namespace gaddpg
