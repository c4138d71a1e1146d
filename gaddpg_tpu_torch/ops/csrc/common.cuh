// Shared pieces of the port's kernels: the error-string export every
// library carries, exact squared distances, the TF32 split of the 3xTF32
// products, and the register-tiled fp32 dense layer of the group-all
// train statistics (K6; K3/K5 run on the tensor cores, sa_tile.cuh, and
// K4 on wgmma, mlp_maxpool.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

extern "C" const char* gaddpg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace gaddpg {

constexpr unsigned kFullMask = 0xffffffffu;

// (a - b)^2 summed as dx*dx + dy*dy + dz*dz with every operation rounded
// on its own (no FMA contraction), the order of the Pallas kernels and of
// the plain PyTorch versions, so selected indices agree bit for bit.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The TF32 value nearest x, ties away from zero (its low 13 bits zero).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 x), hi and lo TF32: the operands of a 3xTF32
// product (ops/sa.py `tf32_split` is the same split in PyTorch)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A thread's register tile in dense_layer: kTileRows rows x kTileCols
// adjacent output columns.
constexpr int kTileRows = 8;
constexpr int kTileCols = 4;
static_assert(kTileCols == 4, "dense_layer loads one float4 of w per input channel");

// What dense_layer does with z = in @ w + b:
//  kStore:   out[k][c] = relu(z * gain[c] + offset[c]) (no affine when
//            gain is null), rows x cout in shared memory;
//  kStats:   per-channel sum and sum of squares of z itself (no affine,
//            no ReLU) over the rows, one partial per row group: out is
//            [groups][2][cout] in shared memory (dense_groups).
enum class Epilogue { kStore, kStats };

// Row groups dense_layer splits `threads` into for `cout` columns: when
// there are fewer column groups than threads, the spare threads split
// the rows.
__host__ __device__ inline int dense_groups(int cout, int threads) {
  const int quads = cout / kTileCols;
  const int lanes = quads < threads ? quads : threads;
  return threads / lanes;
}

// One dense layer over `rows` rows of `in` (rows x cin, row-major, in
// shared memory); w (cin x cout, row-major, 16-byte aligned, cout a
// multiple of kTileCols), b, gain and offset stay in global memory,
// where the block's repeated reads hit L1/L2.
//
// Thread layout: consecutive threads take consecutive groups of
// kTileCols columns, so a warp's float4 loads of w are coalesced and its
// loads of `in` are broadcasts; when there are fewer column groups than
// threads, the spare threads split the rows. Per input channel j a
// thread loads one float4 of w and kTileRows values of `in` and does
// kTileRows * kTileCols FMAs, which keeps shared-memory traffic well
// under the FMA rate. Every sum a thread keeps runs over its rows in a
// fixed order, so the result does not depend on scheduling. The caller
// synchronises the block before and after.
template <Epilogue kMode>
__device__ __forceinline__ void dense_layer(
    const float* __restrict__ in, int rows, int cin,
    const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ gain, const float* __restrict__ offset, int cout,
    float* __restrict__ out) {
  const int quads = cout / kTileCols;
  const int lanes = min(quads, static_cast<int>(blockDim.x));
  const int groups = blockDim.x / lanes;
  const int g = threadIdx.x / lanes;
  if (g >= groups) return;
  for (int q = threadIdx.x % lanes; q < quads; q += lanes) {
    const int c = q * kTileCols;
    float bias[kTileCols], mul[kTileCols], add[kTileCols], red[kTileCols], sq[kTileCols];
#pragma unroll
    for (int t = 0; t < kTileCols; ++t) {
      bias[t] = b[c + t];
      mul[t] = gain != nullptr ? gain[c + t] : 1.0f;
      add[t] = gain != nullptr ? offset[c + t] : 0.0f;
      red[t] = 0.0f;
      sq[t] = 0.0f;
    }
    for (int k0 = g * kTileRows; k0 < rows; k0 += groups * kTileRows) {
      const float* row[kTileRows];
      float acc[kTileRows][kTileCols];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        row[r] = in + min(k0 + r, rows - 1) * cin;
#pragma unroll
        for (int t = 0; t < kTileCols; ++t) acc[r][t] = 0.0f;
      }
      for (int j = 0; j < cin; ++j) {
        const float4 wj = __ldg(reinterpret_cast<const float4*>(w + static_cast<size_t>(j) * cout + c));
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          const float x = row[r][j];
          acc[r][0] = fmaf(x, wj.x, acc[r][0]);
          acc[r][1] = fmaf(x, wj.y, acc[r][1]);
          acc[r][2] = fmaf(x, wj.z, acc[r][2]);
          acc[r][3] = fmaf(x, wj.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        if (k0 + r < rows) {
#pragma unroll
          for (int t = 0; t < kTileCols; ++t) {
            const float z = acc[r][t] + bias[t];
            if (kMode == Epilogue::kStats) {
              red[t] += z;
              sq[t] = fmaf(z, z, sq[t]);
            } else {
              out[(k0 + r) * cout + c + t] =
                  fmaxf(gain != nullptr ? z * mul[t] + add[t] : z, 0.0f);
            }
          }
        }
      }
    }
    if (kMode == Epilogue::kStats) {
#pragma unroll
      for (int t = 0; t < kTileCols; ++t) {
        out[(2 * g) * cout + c + t] = red[t];
        out[(2 * g + 1) * cout + c + t] = sq[t];
      }
    }
  }
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gaddpg
