// The row-tile engine of the grouped set-abstraction kernels, eval K3
// (sa_gather_mlp.cu) and train K5 (sa_train_stats.cu): each group
// compacted to its distinct slots, tiles of 64 rows of the compacted
// list, dense layers on the tensor cores in 3xTF32, and the pooled max
// by segment.
//
// Widths. A tile's accumulators hold kMaxWidth = 256 output columns. The
// hidden layers (and so every layer input but the first) are at most 256
// wide, which the model's widths are at scale 1 and 2; a wider output (the
// last layer's 512 at SA2, scale 2) runs as column passes of up to 256
// over the same row tile, each into a buffer of its own (TileSmem::out),
// so the layer's input stays in act for the next pass.
//
// Distinct slots. Ball query (K2) fills a group with its in-radius hits
// in index order and pads the rest with the first hit, so at SA2 (128
// slots over 32 points) most slots repeat slot 0. A slot whose index
// equals slot 0's gives slot 0's row bit for bit: after ReLU it adds
// nothing to the pooled max (max is idempotent), and to the batch sums
// it adds slot 0's z once more. So a group keeps slot 0, standing for
// every slot equal to it (its multiplicity), and each slot k >= 1 whose
// index differs from slot 0's, standing for itself (ops/sa.py
// `distinct_slots`). The rule is exact for any index: an out-of-range
// index reads the zero row wherever it stands, and a repeat that differs
// from slot 0 is simply computed twice.
//
// The compacted list is laid out by three small kernels (count, one
// fixed-order prefix sum, fill) without a host synchronisation: buffers
// and grids are sized for every slot, and the tile kernels read the row
// count from the device and stop at the list's end. The list's order is
// fixed by the prefix sum, so two calls build the same list.
#pragma once

#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace gaddpg {

constexpr int kRowTile = 64;       // rows of the compacted list per tile
constexpr int kTileThreads = 256;  // 8 warps: 2 row halves x 4 column stripes
constexpr int kMaxWidth = 256;     // widest pass of a layer's output
constexpr int kWeightChunk = 16;   // rows of w per cp.async stage
constexpr int kWarpTiles = kMaxWidth / 8 / 4;  // 8-column mma tiles per warp

// The compacted row list, in one int32 scratch buffer of
// 2 * groups + 1 + 3 * groups * k ints (ops/sa.py `row_list_ints`).
struct RowList {
  int* count;   // [groups] distinct slots of each group
  int* start;   // [groups + 1] exclusive prefix sum of count; start[groups] = rows
  int* group;   // [groups * k] the group (b * s + centre) of each row
  int* member;  // [groups * k] the point index of each row
  int* mult;    // [groups * k] the slots each row stands for
};

inline RowList row_list(void* scratch, int groups, int k) {
  int* p = static_cast<int*>(scratch);
  const size_t slots = static_cast<size_t>(groups) * k;
  return {p, p + groups, p + 2 * groups + 1, p + 2 * groups + 1 + slots,
          p + 2 * groups + 1 + 2 * slots};
}

// -- compaction ------------------------------------------------------------

// One warp per group: the number of slots kept.
__global__ void count_distinct_kernel(const int* __restrict__ idx, int groups, int k,
                                      int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  for (int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; g < groups; g += warps) {
    const int* slots = idx + static_cast<size_t>(g) * k;
    const int first = slots[0];
    int kept = 0;
    for (int k0 = 0; k0 < k; k0 += 32) {
      const int kk = k0 + lane;
      kept += __popc(__ballot_sync(kFullMask, kk < k && (kk == 0 || slots[kk] != first)));
    }
    if (lane == 0) count[g] = kept;
  }
}

constexpr int kScanThreads = 1024;

// One block: start[g] = count[0] + ... + count[g - 1]. Thread i adds a
// run of consecutive groups, the block scans the runs' sums, and each
// thread writes its run: a fixed order, so two calls give the same list.
__global__ void __launch_bounds__(kScanThreads) scan_counts_kernel(
    const int* __restrict__ count, int groups, int* __restrict__ start) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int per = (groups + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, groups);
  const int hi = min(lo + per, groups);
  int sum = 0;
  for (int g = lo; g < hi; ++g) sum += count[g];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += v;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int g = lo; g < hi; ++g) {
    start[g] = run;
    run += count[g];
  }
  if (threadIdx.x == kScanThreads - 1) start[groups] = run;
}

// One warp per group: writes its kept slots, in slot order, from
// start[g] on.
__global__ void fill_rows_kernel(const int* __restrict__ idx, int groups, int k, RowList list) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  for (int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; g < groups; g += warps) {
    const int* slots = idx + static_cast<size_t>(g) * k;
    const int first = slots[0];
    const int base = list.start[g];
    const int first_mult = k - list.count[g] + 1;
    int pos = 0;
    for (int k0 = 0; k0 < k; k0 += 32) {
      const int kk = k0 + lane;
      const int m = kk < k ? slots[kk] : 0;
      const bool keep = kk < k && (kk == 0 || m != first);
      const unsigned ballot = __ballot_sync(kFullMask, keep);
      if (keep) {
        const int at = base + pos + __popc(ballot & ((1u << lane) - 1u));
        list.group[at] = g;
        list.member[at] = m;
        list.mult[at] = kk == 0 ? first_mult : 1;
      }
      pos += __popc(ballot);
    }
  }
}

// Lays out `list` for idx (groups, k): three launches on `stream`.
inline cudaError_t compact_groups(const int* idx, int groups, int k, const RowList& list,
                                  cudaStream_t stream) {
  const int threads = 256;
  const int blocks = std::max(1, std::min((groups + 7) / 8, 16 * sm_count()));
  count_distinct_kernel<<<blocks, threads, 0, stream>>>(idx, groups, k, list.count);
  scan_counts_kernel<<<1, kScanThreads, 0, stream>>>(list.count, groups, list.start);
  fill_rows_kernel<<<blocks, threads, 0, stream>>>(idx, groups, k, list);
  return cudaGetLastError();
}

// -- the tile ----------------------------------------------------------------

__host__ __device__ inline int pad8(int c) { return (c + 7) & ~7; }

// Row stride of an activation tile of width c: a multiple of 8 plus 4,
// so that the eight rows a warp's A fragment reads fall in distinct banks.
__host__ __device__ inline int act_stride(int c) { return pad8(c) + 4; }

// Row stride of a staged weight chunk of width c (a multiple of 8): 8 or
// 24 modulo 32, so that the four rows a warp's B fragment reads fall in
// distinct banks.
__host__ __device__ inline int weight_stride(int c) { return c % 16 == 8 ? c : c + 8; }

// Dynamic shared memory of a tile block: the double-buffered weight
// chunks of the widest pass, the activation tile of the widest layer
// input or pass, with `passes` an output buffer for a pass, and the rows'
// groups, members and multiplicities.
__host__ __device__ inline size_t tile_smem_bytes(int widest_out, int widest_act,
                                                  bool passes = false) {
  return sizeof(float) * (2 * static_cast<size_t>(kWeightChunk) * weight_stride(widest_out) +
                          static_cast<size_t>(kRowTile) * act_stride(widest_act) +
                          (passes ? static_cast<size_t>(kRowTile) * act_stride(kMaxWidth) : 0)) +
         3 * sizeof(int) * kRowTile;
}

struct TileSmem {
  float* wbuf;  // 2 x kWeightChunk x weight_stride(widest_out)
  float* act;   // kRowTile x act_stride(widest_act)
  float* out;   // kRowTile x act_stride(kMaxWidth) with `passes`, else act
  int* group;   // kRowTile
  int* member;  // kRowTile
  int* mult;    // kRowTile
};

__device__ __forceinline__ TileSmem tile_smem(float* smem, int widest_out, int widest_act,
                                              bool passes = false) {
  TileSmem t;
  t.wbuf = smem;
  t.act = smem + 2 * kWeightChunk * weight_stride(widest_out);
  t.out = passes ? t.act + kRowTile * act_stride(widest_act) : t.act;
  t.group = reinterpret_cast<int*>(t.out + kRowTile * act_stride(passes ? kMaxWidth
                                                                         : widest_act));
  t.member = t.group + kRowTile;
  t.mult = t.member + kRowTile;
  return t;
}

// Tiles of the list on the device and the grid that walks them: one
// block per tile up to the blocks the card holds at once; each block
// then takes every gridDim.x-th tile.
template <typename Kernel>
inline cudaError_t tile_grid(Kernel kernel, size_t smem, int slots, int* grid) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTileThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int tiles = (slots + kRowTile - 1) / kRowTile;
  *grid = std::max(1, std::min(tiles, per_sm * sm_count()));
  return cudaSuccess;
}

// Rows [row0, row0 + rows) of the list into the tile's groups, members
// and multiplicities (-1, -1, 0 past `rows`). Ends with a block barrier.
__device__ __forceinline__ void load_rows(const RowList& list, int row0, int rows,
                                          const TileSmem& t) {
  for (int r = threadIdx.x; r < kRowTile; r += blockDim.x) {
    const bool live = r < rows;
    t.group[r] = live ? list.group[row0 + r] : -1;
    t.member[r] = live ? list.member[row0 + r] : -1;
    t.mult[r] = live ? list.mult[row0 + r] : 0;
  }
  __syncthreads();
}

// Elements a thread loads before it stores any: their loads are in
// flight together, not one round trip each.
constexpr int kLoadBatch = 8;

// The rows of load_rows, gathered from `full` (b, n, cin) with the centre
// row subtracted, into the activation tile (columns cin up to pad8(cin)
// and rows past `rows` zero). An index outside [0, n) reads a zero row.
__device__ __forceinline__ void gather_tile(int rows, const float* __restrict__ full,
                                            const float* __restrict__ cpad, int s, int n,
                                            int cin, const TileSmem& t) {
  const int kin = pad8(cin);
  const int stride = act_stride(cin);
  const int total = kRowTile * kin;
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoadBatch * blockDim.x) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e / kin;
      const int j = e - r * kin;
      v[u] = 0.0f;
      if (e < total && r < rows && j < cin) {
        const int g = t.group[r];
        const int m = t.member[r];
        const float x = (m >= 0 && m < n)
                            ? __ldg(full + (static_cast<size_t>(g / s) * n + m) * cin + j)
                            : 0.0f;
        v[u] = x - __ldg(cpad + static_cast<size_t>(g) * cin + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) t.act[(e / kin) * stride + e % kin] = v[u];
    }
  }
}

// relu(z * a + c) of rows [row0, row0 + rows) of z (rows x cin, cin a
// multiple of 8: an earlier layer's output) into the activation tile
// (rows past `rows` zero).
__device__ __forceinline__ void affine_tile(const float* __restrict__ z,
                                            const float* __restrict__ a,
                                            const float* __restrict__ c, int row0, int rows,
                                            int cin, const TileSmem& t) {
  const int stride = act_stride(cin);
  const int total = kRowTile * cin;
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoadBatch * blockDim.x) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e / cin;
      const int j = e - r * cin;
      v[u] = (e < total && r < rows)
                 ? fmaxf(__fadd_rn(__fmul_rn(__ldg(z + static_cast<size_t>(row0) * cin + e),
                                             __ldg(a + j)),
                                   __ldg(c + j)),
                         0.0f)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) t.act[(e / cin) * stride + e % cin] = v[u];
    }
  }
}

// -- dense layers on the tensor cores in 3xTF32 -------------------------------

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows [chunk * kWeightChunk, +kWeightChunk) of w (cin x cout, row stride
// ldw, rows 16-byte aligned) into dst with cp.async; rows past cin are
// zero-filled.
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, int ldw, int cin,
                                              int cout, int chunk, float* dst) {
  const int quads = cout >> 2;
  const int ws = weight_stride(cout);
  for (int e = threadIdx.x; e < kWeightChunk * quads; e += blockDim.x) {
    const int r = e / quads;
    const int q = e - r * quads;
    const int row = chunk * kWeightChunk + r;
    const bool live = row < cin;
    const float* src = w + static_cast<size_t>(live ? row : 0) * ldw + 4 * q;
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ws + 4 * q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
                 "r"(live ? 16 : 0));
  }
  cp_async_commit();
}

// The warp's accumulators of a tile layer: acc[m][j][.] holds rows
// 32 * (warp / 4) + 16 m + {g, g + 8} and columns 8 (4 j + warp % 4) +
// 2 t + {0, 1}, with g = lane / 4, t = lane % 4 (the m16n8k8 C layout).
using TileAcc = float[2][kWarpTiles][4];

// acc = act (kRowTile x cin, stride act_stride(cin), columns up to
// pad8(cin) zero) @ w (cin x cout, row stride ldw: a pass of columns of a
// wider layer; cout a multiple of 8, at most kMaxWidth), in 3xTF32: both operands split into TF32 hi + lo, and each
// product summed as lo*hi + hi*lo + hi*hi in fp32 (the lo*lo term,
// 2^-22 relative, dropped). The weights stream through two shared-memory
// chunks by cp.async, the next chunk in flight while the tensor cores run
// on this one. Starts and ends with a block barrier, so the caller may
// overwrite act once it returns.
__device__ __forceinline__ void dense_tf32x3(const float* act, int cin,
                                             const float* __restrict__ w, int ldw, int cout,
                                             float* wbuf, TileAcc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = cout >> 3;
  const int ws = weight_stride(cout);
  const int as = act_stride(cin);
  const int kin = pad8(cin);
  const int chunks = (kin + kWeightChunk - 1) / kWeightChunk;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
  __syncthreads();  // the previous user of wbuf is done, and act is written
  stage_weights(w, ldw, cin, cout, 0, wbuf);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage_weights(w, ldw, cin, cout, ch + 1, wbuf + ((ch + 1) & 1) * kWeightChunk * ws);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wb = wbuf + (ch & 1) * kWeightChunk * ws;
#pragma unroll
    for (int kk = 0; kk < kWeightChunk; kk += 8) {
      const int k0 = ch * kWeightChunk + kk;
      if (k0 < kin) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* a = act + (wr * 32 + 16 * m + g) * as + k0 + t;
          split_tf32(a[0], ahi[m][0], alo[m][0]);
          split_tf32(a[8 * as], ahi[m][1], alo[m][1]);
          split_tf32(a[4], ahi[m][2], alo[m][2]);
          split_tf32(a[8 * as + 4], ahi[m][3], alo[m][3]);
        }
        // four column tiles at a time: their B splits in registers, then
        // the three products of all eight accumulators pass by pass
        // (small terms first), so that no product waits on the one before
#pragma unroll
        for (int j0 = 0; j0 < kWarpTiles; j0 += 4) {
          if (4 * j0 + wc < ntiles) {
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const bool on = 4 * (j0 + u) + wc < ntiles;
              const float* b = wb + (kk + t) * ws + 8 * (4 * (j0 + u) + wc) + g;
              split_tf32(on ? b[0] : 0.0f, bh[u][0], bl[u][0]);
              split_tf32(on ? b[4 * ws] : 0.0f, bh[u][1], bl[u][1]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (4 * (j0 + u) + wc < ntiles) {
                mma_tf32(acc[0][j0 + u], alo[0], bh[u][0], bh[u][1]);
                mma_tf32(acc[1][j0 + u], alo[1], bh[u][0], bh[u][1]);
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (4 * (j0 + u) + wc < ntiles) {
                mma_tf32(acc[0][j0 + u], ahi[0], bl[u][0], bl[u][1]);
                mma_tf32(acc[1][j0 + u], ahi[1], bl[u][0], bl[u][1]);
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (4 * (j0 + u) + wc < ntiles) {
                mma_tf32(acc[0][j0 + u], ahi[0], bh[u][0], bh[u][1]);
                mma_tf32(acc[1][j0 + u], ahi[1], bh[u][0], bh[u][1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this chunk before it is refilled
  }
}

// act (kRowTile x cout, stride act_stride(cout)) = acc + b, through a
// ReLU when `relu`. The caller synchronises before act is read.
__device__ __forceinline__ void store_tile(const TileAcc& acc, const float* __restrict__ b,
                                           int cout, bool relu, float* act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = cout >> 3;
  const int as = act_stride(cout);
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) {
    if (4 * j + wc < ntiles) {
      const int col = 8 * (4 * j + wc) + 2 * t;
      const float b0 = b[col], b1 = b[col + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = wr * 32 + 16 * m + g;
        float2 lo = make_float2(acc[m][j][0] + b0, acc[m][j][1] + b1);
        float2 hi = make_float2(acc[m][j][2] + b0, acc[m][j][3] + b1);
        if (relu) {
          lo = make_float2(fmaxf(lo.x, 0.0f), fmaxf(lo.y, 0.0f));
          hi = make_float2(fmaxf(hi.x, 0.0f), fmaxf(hi.y, 0.0f));
        }
        *reinterpret_cast<float2*>(act + r * as + col) = lo;
        *reinterpret_cast<float2*>(act + (r + 8) * as + col) = hi;
      }
    }
  }
}

// out[group][c] = max(out[group][c], max of column c over the tile's rows
// of that group), c < cout, out's rows ldo apart, for ReLU outputs v(r,
// c) >= 0: one thread per column
// walks the rows (sorted by group) and flushes each group's run with an
// atomicMax on the int bits, which order like the non-negative floats;
// out starts at zero, the identity of the max. Max does not depend on
// the order, so two launches agree bit for bit.
template <typename Value>
__device__ __forceinline__ void pool_rows(int rows, const int* group, int cout, int ldo,
                                          float* __restrict__ out, Value v) {
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    int g = group[0];
    float run = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const int gr = group[r];
      if (gr != g) {
        atomicMax(reinterpret_cast<int*>(out + static_cast<size_t>(g) * ldo + c),
                  __float_as_int(run));
        g = gr;
        run = 0.0f;
      }
      run = fmaxf(run, v(r, c));
    }
    atomicMax(reinterpret_cast<int*>(out + static_cast<size_t>(g) * ldo + c),
              __float_as_int(run));
  }
}

}  // namespace gaddpg
