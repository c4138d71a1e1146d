// K3: eval set-abstraction level (gather -> 3x folded Dense+ReLU -> max).
//
// Replaces the Pallas kernel `_sa_gather_mlp_kernel` / `sa_gather_mlp`
// (gaddpg_tpu/ops/pallas_sa.py:71-143). For each centre: gather its K
// group members' rows of the (N, C_in) point table, subtract the centre
// row (xyz in cols 0:3, zero elsewhere), run three Dense layers with
// BatchNorm folded in, each followed by ReLU, and max over the K rows.
//
// What bounds it on H100: FLOPs, counted over the rows the function
// needs: the distinct slots of each group (sa_tile.cuh). At SA2 (K=128,
// 131->128->128->256) a row is 2 * 65,920 FLOP against 0.5 KB of input,
// and only 3-7% of the slots are distinct on real clouds.
// Design (sa_tile.cuh): compact every group to its distinct slots, then
// walk the compacted list in 64-row tiles that span several centres, so
// that B=1 and B=1024 alike fill the card whatever the share of distinct
// rows. A tile gathers its rows with indexed loads (never the TPU's
// one-hot matmul, whose rounding caused the round-5 train drift) into
// shared memory, runs the three layers there on the tensor cores in
// 3xTF32 (fp32 accuracy; weights streamed in by cp.async), and max-pools
// its rows per centre into the zeroed output with atomicMax.

#include "sa_tile.cuh"

namespace {

using namespace gaddpg;

__global__ void __launch_bounds__(kTileThreads, 2) sa_gather_mlp_kernel(
    RowList list, int groups, const float* __restrict__ full,
    const float* __restrict__ cpad, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, float* __restrict__ out, int s, int n, int cin, int c1,
    int c2, int c3, int widest_out, int widest_act) {
  extern __shared__ float4 smem4[];
  const bool passes = c3 > kMaxWidth;
  const TileSmem t = tile_smem(reinterpret_cast<float*>(smem4), widest_out, widest_act, passes);
  const int total = list.start[groups];
  const int tiles = (total + kRowTile - 1) / kRowTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRowTile;
    const int rows = min(kRowTile, total - row0);
    __syncthreads();  // the previous tile's pool has read act and group
    load_rows(list, row0, rows, t);
    gather_tile(rows, full, cpad, s, n, cin, t);
    TileAcc acc;
    dense_tf32x3(t.act, cin, w1, c1, c1, t.wbuf, acc);
    store_tile(acc, b1, c1, true, t.act);
    dense_tf32x3(t.act, c1, w2, c2, c2, t.wbuf, acc);
    store_tile(acc, b2, c2, true, t.act);
    // the last layer in column passes of up to kMaxWidth, each pooling its
    // own columns; one pass writes over its input
    for (int p0 = 0; p0 < c3; p0 += kMaxWidth) {
      const int pw = min(kMaxWidth, c3 - p0);
      dense_tf32x3(t.act, c2, w3 + p0, c3, pw, t.wbuf, acc);
      store_tile(acc, b3 + p0, pw, true, t.out);
      __syncthreads();
      const int as = act_stride(pw);
      const float* h = t.out;
      pool_rows(rows, t.group, pw, c3, out + p0, [=](int r, int c) { return h[r * as + c]; });
    }
  }
}

}  // namespace

// idx (b, s, k) int32; full (b, n, cin); cpad (b, s, cin); w_i (c_{i-1}, c_i)
// row-major, 16-byte aligned, and b_i (c_i,) with BatchNorm folded in;
// out (b, s, c3), zero on entry; rows an int32 scratch of
// 2*b*s + 1 + 3*b*s*k ints (the compacted row list). All float32
// contiguous. Returns cudaErrorInvalidValue for a layer width that is not
// a multiple of 8, a hidden width (c1, c2) above 256, or unaligned
// weights; c3 may be wider (column passes).
extern "C" int gaddpg_sa_gather_mlp(const void* idx, const void* full, const void* cpad,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* w3, const void* b3,
                                    void* out, void* rows, int b, int s, int k, int n,
                                    int cin, int c1, int c2, int c3, void* stream) {
  if (c1 % 8 || c2 % 8 || c3 % 8 || c1 > kMaxWidth || c2 > kMaxWidth) {
    return cudaErrorInvalidValue;
  }
  for (const void* w : {w1, w2, w3}) {
    if (reinterpret_cast<uintptr_t>(w) % 16) return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = b * s;
  const RowList list = row_list(rows, groups, k);
  cudaError_t err = compact_groups(static_cast<const int*>(idx), groups, k, list, st);
  if (err != cudaSuccess) return err;
  const int widest_out = std::max({c1, c2, std::min(c3, kMaxWidth)});
  const int widest_act = std::max(cin, widest_out);
  const size_t smem = tile_smem_bytes(widest_out, widest_act, c3 > kMaxWidth);
  int grid = 0;
  err = tile_grid(sa_gather_mlp_kernel, smem, groups * k, &grid);
  if (err != cudaSuccess) return err;
  sa_gather_mlp_kernel<<<grid, kTileThreads, smem, st>>>(
      list, groups, static_cast<const float*>(full), static_cast<const float*>(cpad),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3), static_cast<float*>(out),
      s, n, cin, c1, c2, c3, widest_out, widest_act);
  return cudaGetLastError();
}
