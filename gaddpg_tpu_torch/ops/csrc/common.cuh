// Shared pieces of the port's kernels: the error-string export every
// library carries, exact squared distances, the TF32 split of the 3xTF32
// products, the cached SM count, and the opt-in to large dynamic shared
// memory.
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

// The current device's SM count, queried once per device and cached: a
// launcher sizes its grid by it on every call.
inline int sm_count() {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  if (dev < kDevices && cached[dev] > 0) return cached[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kDevices) cached[dev] = sms;
  return sms;
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gaddpg
