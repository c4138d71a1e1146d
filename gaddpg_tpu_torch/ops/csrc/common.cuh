// Shared pieces of the port's kernels: the error-string export every
// library carries, exact squared distances, and the dense+ReLU tile
// used by both eval set-abstraction kernels.
#pragma once

#include <cuda_runtime.h>

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

// A thread's register tile in dense_relu: kTileRows rows x kTileCols
// adjacent output columns.
constexpr int kTileRows = 8;
constexpr int kTileCols = 4;
static_assert(kTileCols == 4, "dense_relu loads one float4 of w per input channel");

// out[k][c] = relu(sum_j in[k][j] * w[j][c] + b[c]) for k < rows, c < cout.
// `in` (rows x cin) and `out` (rows x cout) are row-major in shared
// memory; w (cin x cout, row-major, 16-byte aligned, cout a multiple of
// kTileCols) and b stay in global memory, where the block's repeated
// reads hit L1/L2. With pool != nullptr nothing is stored and pool[c]
// (shared, zero-initialised) becomes the max over k instead: ReLU
// outputs are >= 0, so 0 is the identity of that max and the
// non-negative floats order like their bit patterns as ints.
//
// Thread layout: consecutive threads take consecutive groups of
// kTileCols columns, so a warp's float4 loads of w are coalesced and its
// loads of `in` are broadcasts; when there are fewer column groups than
// threads, the spare threads split the rows. Per input channel j a
// thread loads one float4 of w and kTileRows values of `in` and does
// kTileRows * kTileCols FMAs, which keeps shared-memory traffic well
// under the FMA rate. The caller synchronises the block before and after.
__device__ __forceinline__ void dense_relu(
    const float* __restrict__ in, int rows, int cin,
    const float* __restrict__ w, const float* __restrict__ b, int cout,
    float* __restrict__ out, float* __restrict__ pool) {
  const int quads = cout / kTileCols;
  const int lanes = min(quads, static_cast<int>(blockDim.x));
  const int groups = blockDim.x / lanes;
  const int g = threadIdx.x / lanes;
  if (g >= groups) return;
  for (int q = threadIdx.x % lanes; q < quads; q += lanes) {
    const int c = q * kTileCols;
    float bias[kTileCols], vmax[kTileCols];
#pragma unroll
    for (int t = 0; t < kTileCols; ++t) {
      bias[t] = b[c + t];
      vmax[t] = 0.0f;
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
            const float v = fmaxf(acc[r][t] + bias[t], 0.0f);
            if (pool != nullptr) {
              vmax[t] = fmaxf(vmax[t], v);
            } else {
              out[(k0 + r) * cout + c + t] = v;
            }
          }
        }
      }
    }
    if (pool != nullptr) {
#pragma unroll
      for (int t = 0; t < kTileCols; ++t) {
        atomicMax(reinterpret_cast<int*>(pool + c + t), __float_as_int(vmax[t]));
      }
    }
  }
}

// Shared memory of one eval-SA block: the input tile (rows x cin), reused
// for the second hidden layer, the first hidden layer, and the pool row.
__host__ __device__ inline size_t mlp_smem_floats(int rows, int cin, int c1, int c2, int c3) {
  const int a = cin > c2 ? cin : c2;
  return static_cast<size_t>(rows) * a + static_cast<size_t>(rows) * c1 + c3;
}

// Runs the three dense+ReLU layers and the max-pool on the tile already
// loaded into smem[0 : rows*cin] (the caller synchronises after loading
// it); leaves the pooled row in the returned pointer (shared memory, c3
// floats). Ends with a block barrier.
__device__ __forceinline__ float* mlp3_maxpool(
    float* smem, int rows, int cin,
    const float* __restrict__ w1, const float* __restrict__ b1, int c1,
    const float* __restrict__ w2, const float* __restrict__ b2, int c2,
    const float* __restrict__ w3, const float* __restrict__ b3, int c3) {
  const int a = cin > c2 ? cin : c2;
  float* x = smem;              // rows x cin, then rows x c2
  float* h1 = smem + rows * a;  // rows x c1
  float* pool = h1 + rows * c1; // c3
  for (int c = threadIdx.x; c < c3; c += blockDim.x) pool[c] = 0.0f;
  dense_relu(x, rows, cin, w1, b1, c1, h1, nullptr);
  __syncthreads();
  dense_relu(h1, rows, c1, w2, b2, c2, x, nullptr);
  __syncthreads();
  dense_relu(x, rows, c2, w3, b3, c3, nullptr, pool);
  __syncthreads();
  return pool;
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gaddpg
