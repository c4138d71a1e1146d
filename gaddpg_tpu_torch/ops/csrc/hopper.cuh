// Hopper (sm_90a) building blocks of K4 (mlp_maxpool.cu) and K6
// (groupall_layer.cu): mbarriers, TMA bulk copies into shared memory, the
// TF32 warpgroup product wgmma.m64n128k8 with A in registers and B in
// shared memory, and on them a warpgroup's pass over a weight stream in
// 3xTF32.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace gaddpg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrives and adds `bytes` to the transfers the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of the given parity has completed. A fresh
// barrier is in phase 0, and parity 1 counts as completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory; completes a transfer of `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// -- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes (8 x 4 TF32), stored as 128
// contiguous bytes; `lbo` bytes between the two core matrices of a k8
// step (the K direction), `sbo` bytes between 8-row groups (the M or N
// direction).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving or reusing a register across an
// asynchronous product that reads or writes it.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (64 x 128 per warpgroup) += a (64 x 8, TF32, registers) * b (8 x 128,
// TF32, shared memory at desc_b). Register layouts (warp w of the
// warpgroup, g = lane / 4, t = lane % 4): a = {A[16w+g][t],
// A[16w+g+8][t], A[16w+g][t+4], A[16w+g+8][t+4]}; d[4j + {0, 1, 2, 3}] =
// D[16w+g][8j+2t], D[16w+g][8j+2t+1], D[16w+g+8][8j+2t], D[16w+g+8][8j+2t+1].
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// -- the weight stream and a warpgroup's pass --------------------------------

// A pass: kPass output columns of a layer over a warpgroup's 64 rows. The
// weights stream through shared memory as k8 steps, each the TF32 hi and
// then lo part of an (8 inputs x kPass columns) block of w laid out K-major
// in wgmma's core matrices (ops/sa.py `layer_weight_pack`).
constexpr int kPass = 256;                       // output columns of a pass
constexpr int kSub = kPass / 128;                // n128 products per pass
constexpr int kStepFloats = kPass * 8;           // one TF32 part of a k8 step
constexpr int kStageBytes = 2 * kStepFloats * 4; // hi and lo: 16 KB
constexpr int kStages = 5;

using PassAcc = float[kSub][64];
using Frag = uint32_t[4];

// The ring of weight stages and the block's walk over the weight stream:
// stream step q (q = 0, 1, ... over all the block's tiles) is k8 step
// q % per_tile of the pack and lands in stage q % kStages. Thread 0
// issues each step's TMA bulk copy kAhead steps before the consumers
// reach it; a stage is refilled once every consumer warp has released
// its previous step.
struct Ring {
  float* stages;       // kStages x [hi, lo] steps
  uint64_t* full_bar;  // a stage's copy has landed
  uint64_t* empty_bar; // every consumer warp is done with a stage
  const float* wpack;
  int per_tile;        // stream steps of one tile
  uint32_t total;      // stream steps of the block's walk

  __device__ __forceinline__ void issue(uint32_t q) const {
    if (q >= total) return;
    const int st = q % kStages;
    mbar_wait(&empty_bar[st], ((q / kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(&full_bar[st], kStageBytes);
    bulk_copy_g2s(stages + st * 2 * kStepFloats,
                  wpack + static_cast<size_t>(q % per_tile) * 2 * kStepFloats, kStageBytes,
                  &full_bar[st]);
  }
};

// Steps issued ahead of the one the consumers work on: a step's stage is
// released one step late (after the next step's products are issued), so
// the stage refilled at step q held step q - 2.
constexpr int kAhead = kStages - 2;

// One k8 step of a pass: acc += the warpgroup's rows (this warp's 16 at
// `rows`, columns 8 k ..) @ stream step `it`, in 3xTF32, with the A
// fragment split into `hi`, `lo`. The step's products stay in flight;
// the previous step's (whose fragment is `prev_hi`, `prev_lo`) are
// waited for, and its stage released, when `has_prev`.
__device__ __forceinline__ void pass_step(PassAcc& acc, Frag& hi, Frag& lo, Frag& prev_hi,
                                          Frag& prev_lo, bool has_prev, const float* rows,
                                          int as, int k, uint32_t& it, const Ring& ring,
                                          int lane) {
  if (threadIdx.x == 0) ring.issue(it + kAhead);
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
  const float* a = rows + g * as + 8 * k + t;
  split_tf32(a[0], hi[0], lo[0]);
  split_tf32(a[8 * as], hi[1], lo[1]);
  split_tf32(a[4], hi[2], lo[2]);
  split_tf32(a[8 * as + 4], hi[3], lo[3]);
  const int st = it % kStages;
  mbar_wait(&ring.full_bar[st], (it / kStages) & 1);
  const float* b_hi = ring.stages + st * 2 * kStepFloats;
  const float* b_lo = b_hi + kStepFloats;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    // columns 128 s ..: 16 core matrices 128 bytes apart; the k8 step's
    // two halves kPass * 16 bytes apart
    const uint64_t d_hi = smem_desc(b_hi + s * 128 * 4, kPass * 16, 128);
    const uint64_t d_lo = smem_desc(b_lo + s * 128 * 4, kPass * 16, 128);
    wgmma_tf32_m64n128k8(acc[s], lo, d_hi);
    wgmma_tf32_m64n128k8(acc[s], hi, d_lo);
    wgmma_tf32_m64n128k8(acc[s], hi, d_hi);
  }
  wgmma_commit();
  wgmma_wait<1>();  // the previous step's products are done
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fence_reg(prev_hi[i]);
    fence_reg(prev_lo[i]);
  }
  __syncwarp();
  if (has_prev && lane == 0) mbar_arrive(&ring.empty_bar[(it - 1) % kStages]);
  ++it;
}

// acc += the warpgroup's 64 rows (this warp's 16 at `rows`, stride as) @
// the next `steps` k8 steps of the weight stream, all products done on
// return (so the caller may then overwrite the rows). `it` counts the
// stream's steps across the block's whole walk.
__device__ __forceinline__ void accumulate_pass(PassAcc& acc, const float* rows, int as,
                                                int steps, uint32_t& it, const Ring& ring,
                                                int lane) {
  Frag hi0, lo0, hi1, lo1;  // two fragments: one in flight, one loading
  int k = 0;
  for (; k + 1 < steps; k += 2) {
    pass_step(acc, hi0, lo0, hi1, lo1, k > 0, rows, as, k, it, ring, lane);
    pass_step(acc, hi1, lo1, hi0, lo0, true, rows, as, k + 1, it, ring, lane);
  }
  if (k < steps) pass_step(acc, hi0, lo0, hi1, lo1, k > 0, rows, as, k, it, ring, lane);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fence_reg(hi0[i]);
    fence_reg(lo0[i]);
    fence_reg(hi1[i]);
    fence_reg(lo1[i]);
  }
#pragma unroll
  for (int s = 0; s < kSub; ++s)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(acc[s][i]);
  __syncwarp();
  if (lane == 0) mbar_arrive(&ring.empty_bar[(it - 1) % kStages]);
}

// acc = the warpgroup's 64 rows @ the next `steps` k8 steps of the
// weight stream (accumulate_pass from zero).
__device__ __forceinline__ void run_pass(PassAcc& acc, const float* rows, int as, int steps,
                                         uint32_t& it, const Ring& ring, int lane) {
#pragma unroll
  for (int s = 0; s < kSub; ++s)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[s][i] = 0.0f;
  accumulate_pass(acc, rows, as, steps, it, ring, lane);
}

}  // namespace gaddpg
