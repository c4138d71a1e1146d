// K5: the train-mode grouped set-abstraction level, batch statistics and
// pooled output (K6, the group-all level, is groupall_layer.cu).
//
// K5 replaces the Pallas kernel `sa_train_fused` (`_stats_kernel`,
// `_forward_kernel`, `_run_stats` and `_pallas_sa_train_forward`,
// gaddpg_tpu/ops/pallas_sa_train.py:138-290). Per layer i of the three,
// z_i = h_{i-1} @ w_i + b_i over every slot of every group, its batch
// mean and variance over all B*S*K slots (var = E[z^2] - mean^2), then
// h_i = relu(z_i * a_i + c_i) with the BatchNorm affine of those
// statistics; h_0 is the gathered row minus the centre row (xyz in cols
// 0:3, zero elsewhere); pooled = max of h_3 over the K slots.
// What bounds it on H100: FLOPs, each layer once over the distinct slots
// of each group (sa_tile.cuh), 2 * 65,920 FLOP per row at SA2.
// Design: the TPU kernel streams through VMEM and so recomputes layers
// 1..i-1 in stats pass i, then all three in the final forward (2.76x the
// function's FLOPs). Here each layer runs once, on the row tiles of the
// compacted list (sa_tile.cuh): pass 1 gathers (indexed loads, never the
// TPU's one-hot matmul, whose rounding caused the round-5 drift) and
// computes z_1; pass i > 1 reads z_{i-1} back from a scratch tensor and
// applies its affine and ReLU. Each pass writes z_i to scratch and each
// tile's per-channel sums of m*z and m*z^2 (m: the slots the row stands
// for) to its own partial, which a second kernel adds in a fixed order
// in double (train_stats.cuh): no float atomics, so two calls give the
// same bits. The dense layers run on the tensor cores in 3xTF32. The
// final pass applies the last affine and ReLU to z_3 and max-pools by
// segment; there is no final forward.
// A layer wider than 256 (the last layer at SA2, scale 2: 512) runs in
// column passes of 256 over the same row tile (sa_tile.cuh), each writing
// its columns of z and of the partial sums.

#include "sa_tile.cuh"
#include "train_stats.cuh"

namespace {

using namespace gaddpg;

// K5 pass `layer` (1, 2, 3) over the compacted list: z = h @ w + b of
// each row to zout (rows x cout) and the tile's sums of m*z and m*z^2 to
// partial[tile] (2 x cout); h is the gathered row (layer 1) or
// relu(zin * a + c) of the previous pass's output zin (rows x cin).
__global__ void __launch_bounds__(kTileThreads, 2) sa_train_layer_kernel(
    RowList list, int groups, const float* __restrict__ full, const float* __restrict__ cpad,
    const float* __restrict__ zin, const float* __restrict__ a, const float* __restrict__ c,
    const float* __restrict__ w, const float* __restrict__ b, float* __restrict__ zout,
    float* __restrict__ partial, int s, int n, int cin, int cout, int layer) {
  extern __shared__ float4 smem4[];
  const bool passes = cout > kMaxWidth;
  const int widest_out = min(cout, kMaxWidth);
  const TileSmem t = tile_smem(reinterpret_cast<float*>(smem4), widest_out,
                               max(cin, widest_out), passes);
  const int total = list.start[groups];
  const int tiles = (total + kRowTile - 1) / kRowTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRowTile;
    const int rows = min(kRowTile, total - row0);
    __syncthreads();  // the previous tile's sums have read act and mult
    load_rows(list, row0, rows, t);
    if (layer == 1) {
      gather_tile(rows, full, cpad, s, n, cin, t);
    } else {
      affine_tile(zin, a, c, row0, rows, cin, t);
    }
    float* part = partial + static_cast<size_t>(tile) * 2 * cout;
    // column passes of up to kMaxWidth; one pass writes over its input
    for (int p0 = 0; p0 < cout; p0 += kMaxWidth) {
      const int pw = min(kMaxWidth, cout - p0);
      const int as = act_stride(pw);
      TileAcc acc;
      dense_tf32x3(t.act, cin, w + p0, cout, pw, t.wbuf, acc);
      store_tile(acc, b + p0, pw, false, t.out);
      __syncthreads();
      for (int col = threadIdx.x; col < pw; col += blockDim.x) {
        float sum = 0.0f, sq = 0.0f;
        for (int r = 0; r < rows; ++r) {
          const float z = t.out[r * as + col];
          const float mz = static_cast<float>(t.mult[r]) * z;
          sum += mz;
          sq = fmaf(mz, z, sq);
          zout[static_cast<size_t>(row0 + r) * cout + p0 + col] = z;
        }
        part[p0 + col] = sum;
        part[cout + p0 + col] = sq;
      }
    }
  }
}

// K5's pooled output: max over each group's rows of relu(z * a + c), by
// segment into the zeroed out (groups x cout), a tile of z at a time
// through shared memory.
__global__ void __launch_bounds__(kTileThreads) sa_train_pool_kernel(
    RowList list, int groups, const float* __restrict__ z, const float* __restrict__ a,
    const float* __restrict__ c, float* __restrict__ out, int cout) {
  extern __shared__ float4 smem4[];
  const TileSmem t = tile_smem(reinterpret_cast<float*>(smem4), 0, cout);  // no weights
  const int total = list.start[groups];
  const int tiles = (total + kRowTile - 1) / kRowTile;
  const int as = act_stride(cout);
  const float* act = t.act;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRowTile;
    const int rows = min(kRowTile, total - row0);
    __syncthreads();  // the previous tile's pool has read act and group
    load_rows(list, row0, rows, t);
    affine_tile(z, a, c, row0, rows, cout, t);
    __syncthreads();
    pool_rows(rows, t.group, cout, cout, out,
              [=](int r, int col) { return act[r * as + col]; });
  }
}

}  // namespace

// K5 pass `layer` of a grouped level. idx (b, s, k) int32; full (b, n,
// cin0); cpad (b, s, cin0); zin (rows, cin) the previous pass's z and a,
// c (cin,) its BatchNorm affine (layers 2, 3; null for layer 1, where cin
// = cin0); w (cin, cout) row-major, 16-byte aligned, b (cout,); zout a
// scratch of b*s*k*cout floats; partial a scratch of
// ceil(b*s*k / 64) * 2 * cout floats; rows the int32 row-list scratch of
// 2*b*s + 1 + 3*b*s*k ints, laid out by the layer-1 pass and read by the
// later ones; mean, var (cout,) the outputs, over all b*s*k slots, and
// ga, gc (cout,) their BatchNorm affine for the BatchNorm's bn_scale,
// bn_bias (cout,). With `sums` (2 * cout + 1 doubles) the reduction
// writes this call's sums of z and z^2 and its slot count there instead
// of mean, var, ga and gc, for a reduction across ranks that
// gaddpg_bn_from_sums finishes. All float32 contiguous. Returns cudaErrorInvalidValue for a width that is
// not a multiple of 8, an input (layers 2, 3) wider than 256, or
// unaligned weights; cout may be wider (column passes).
extern "C" int gaddpg_sa_train_layer(const void* idx, const void* full, const void* cpad,
                                     const void* zin, const void* a, const void* c,
                                     const void* w, const void* b, void* zout, void* partial,
                                     void* rows, void* mean, void* var, const void* bn_scale,
                                     const void* bn_bias, void* ga, void* gc, void* sums,
                                     int batch, int s, int k, int n, int cin, int cout, int layer,
                                     void* stream) {
  if (layer < 1 || layer > 3 || cout % 8 || (layer > 1 && (cin % 8 || cin > kMaxWidth)) ||
      reinterpret_cast<uintptr_t>(w) % 16) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = batch * s;
  const RowList list = row_list(rows, groups, k);
  cudaError_t err;
  if (layer == 1) {
    err = compact_groups(static_cast<const int*>(idx), groups, k, list, st);
    if (err != cudaSuccess) return err;
  }
  const int widest_out = std::min(cout, kMaxWidth);
  const size_t smem = tile_smem_bytes(widest_out, std::max(cin, widest_out), cout > kMaxWidth);
  int grid = 0;
  err = tile_grid(sa_train_layer_kernel, smem, groups * k, &grid);
  if (err != cudaSuccess) return err;
  sa_train_layer_kernel<<<grid, kTileThreads, smem, st>>>(
      list, groups, static_cast<const float*>(full), static_cast<const float*>(cpad),
      static_cast<const float*>(zin), static_cast<const float*>(a),
      static_cast<const float*>(c), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(zout), static_cast<float*>(partial),
      s, n, cin, cout, layer);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const BnAffine bn{static_cast<const float*>(bn_scale), static_cast<const float*>(bn_bias),
                    static_cast<float*>(ga), static_cast<float*>(gc)};
  return launch_reduce_stats(static_cast<const float*>(partial), 0, list.start + groups,
                             kRowTile, cout, static_cast<double>(groups) * k,
                             static_cast<float*>(mean), static_cast<float*>(var), bn,
                             static_cast<double*>(sums), st);
}

// The second half of a layer split at the reduction (K5 and K6 under a
// data-parallel mesh): sums (2 * cout + 1 doubles, the sums of z and z^2
// over every rank's rows and their count, reduced across the ranks) ->
// mean, var (cout,) and the BatchNorm affine ga, gc (cout,) for bn_scale,
// bn_bias (cout,), with the arithmetic of the unsplit reduction.
extern "C" int gaddpg_bn_from_sums(const void* sums, const void* bn_scale, const void* bn_bias,
                                   void* mean, void* var, void* ga, void* gc, int cout,
                                   void* stream) {
  if (cout < 1) return cudaErrorInvalidValue;
  const BnAffine bn{static_cast<const float*>(bn_scale), static_cast<const float*>(bn_bias),
                    static_cast<float*>(ga), static_cast<float*>(gc)};
  constexpr int kThreads = 256;
  bn_from_sums_kernel<<<(cout + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(sums), cout, static_cast<float*>(mean),
      static_cast<float*>(var), bn);
  return cudaGetLastError();
}

// K5's final pass: z (rows, cout) the layer-3 pass's z, a, c (cout,) its
// BatchNorm affine, rows the row list of the layer-1 pass; out (b, s,
// cout), zero on entry.
extern "C" int gaddpg_sa_train_pool(const void* rows, const void* z, const void* a,
                                    const void* c, void* out, int batch, int s, int k,
                                    int cout, void* stream) {
  const int groups = batch * s;
  const RowList list = row_list(const_cast<void*>(rows), groups, k);
  const size_t smem = tile_smem_bytes(0, cout);
  int grid = 0;
  cudaError_t err = tile_grid(sa_train_pool_kernel, smem, groups * k, &grid);
  if (err != cudaSuccess) return err;
  sa_train_pool_kernel<<<grid, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      list, groups, static_cast<const float*>(z), static_cast<const float*>(a),
      static_cast<const float*>(c), static_cast<float*>(out), cout);
  return cudaGetLastError();
}
