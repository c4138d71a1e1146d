// K6: train group-all set-abstraction level, one launch per layer on
// wgmma, then a pooling pass; also K4's engine for the widths its fused
// kernel cannot hold (ops/sa.py `mlp_maxpool`).
//
// Replaces the Pallas kernels of `groupall_train_fused`
// (gaddpg_tpu/ops/pallas_sa_train.py:346-455: `_groupall_stats_kernel`
// :367, `_groupall_forward_kernel` :389, `_pallas_groupall_train` :399).
// Three Dense layers with batch-statistics BatchNorm and ReLU over every
// row of `full` (B, N, C_in), not centred: per layer i, z_i = h_{i-1} @
// w_i + b_i over all B * N rows, its per-channel mean and E[z^2] - mean^2
// (unclamped), h_i = relu(z_i * a_i + c_i) with the BatchNorm affine of
// those statistics; pooled = max over N of h_3.
//
// What bounds it on H100: operations. On the main path (B = 256, N = 32,
// 259 -> 256 -> 256 -> 512) the 8,192 rows are 2 * 8,192 * 262,912 = 4.3
// GFLOP, 0.026 ms at the 3xTF32 rate; z_1 .. z_3 are 32 MB of scratch,
// written and read once (0.02 ms at 3.35 TB/s).
//
// Design. The TPU kernel streams through VMEM, so its stats pass i
// recomputes layers 1..i-1 and its final forward all three. Here each
// layer is one launch over the B * N rows as a row-tiled GEMM on wgmma
// (m64n128k8, TF32) in 3xTF32 (hopper.cuh `run_pass`, K4's pass): a
// block takes 128 rows (two consumer warpgroups of 64) and one 256-column
// pass of the output (grid: row tiles x passes). A pack kernel
// (`weight_pack_kernel` below, ops/sa.py `layer_weight_pack`) splits the
// layer's weights into TF32 hi and lo parts and lays each k8 step out in
// wgmma's K-major core matrices, K4's layout one layer at a time with the
// columns padded to a multiple of 256, once per forward: the weights
// change every update, so nothing is cached, and a split inside the layer
// kernel would redo it in every block and leave its inner loop unlike
// K4's. Thread 0 streams the pass's steps by TMA through five 16 KB
// stages.
//
// A warp copies its 16 rows into shared memory as fp32 by 4-byte
// cp.async (layer 1's rows are C_in = 259 floats, 1,036 bytes apart: no
// TMA, no vector copies), zero past C_in and past the last row; layers 2
// and 3 read z_{i-1} from scratch and apply relu(z * a + c) of the
// previous layer's statistics once the copies have landed. The rows are held in
// chunks of kChunk = 264 input columns: shared memory holds the 80 KB
// weight ring and 128 rows x 268 floats (137 KB) of a chunk, 214 KB of
// the 227 KB. One chunk takes every input of the main path (259, 256);
// at scale 2 (515 -> 512 -> 512 -> 1024) a warp reloads its rows once per
// pass, after the first chunk's products are done.
// Holding 128 rows of 520 columns whole would take 268 KB.
//
// The epilogue adds the bias, stores z_i to scratch (z_1 and z_3 share a
// buffer, z_2 has its own: the wrapper's) and writes the tile's per-column
// sums of z and z^2 over its rows to its own slot of a (tiles, 2, C_out)
// partial buffer: each warp's butterfly over its 16 rows, then the eight
// warps in order. `reduce_stats_kernel` (train_stats.cuh) adds the tiles
// in a fixed order in double and writes the statistics and the
// BatchNorm affine the next layer loads through. No float atomics, so two
// calls give the same bits. The pooling pass (one thread per cloud and column, the N
// rows in order) applies the last affine. There is no final forward.
//
// K4's wide widths run the same layers with the folded weights, no
// statistics and no affine: layers 2 and 3 load relu(z) and the pooling
// pass takes the max of relu(z) (the `relu` flag with null a, c).

#include "hopper.cuh"
#include "train_stats.cuh"

namespace {

using namespace gaddpg;

constexpr int kRows = 64;                  // rows of a warpgroup's tile (wgmma M)
constexpr int kConsumers = 2;              // consumer warpgroups of a block
constexpr int kBlockRows = kRows * kConsumers;
constexpr int kThreads = 128 * kConsumers;
constexpr int kChunk = 264;                // input columns held at a time: 33 k8 steps
constexpr int kActStride = kChunk + 4;     // 4 mod 8: conflict-free A fragment reads
constexpr int kPoolThreads = 256;
static_assert(2 * kPass <= 16 * kActStride, "a warp's sums fit in its rows");

constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kStageBytes +
                              sizeof(float) * kBlockRows * kActStride +
                              2 * kStages * sizeof(uint64_t);

__host__ __device__ inline int pad8(int c) { return (c + 7) & ~7; }

struct LayerArgs {
  const float* x;      // (rows, cin): full (layer 1) or z_{i-1}
  const float* a;      // (cin,) affine of x's statistics, or null
  const float* c;
  const float* wpack;  // (passes, steps, 2, kStepFloats), layer_weight_pack
  const float* bias;   // (cout,)
  float* z;            // (rows, cout)
  float* partial;      // (tiles, 2, cout), null for no statistics
  int rows, cin, cout;
  int relu;            // load relu(x * a + c), or relu(x) for null a; else x
};

// 4 bytes from global to shared memory by cp.async, zero-filled when
// `bytes` is 0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Columns [k0, k0 + kw) of the warp's 16 rows [row0, row0 + 16) of x into
// dst (stride kActStride), then relu(x * a + c) (relu(x) for null a) in
// place when p.relu is set; zero past cin and past p.rows. Lane l copies
// columns l, l + 32, ... of every row by cp.async, all in flight at once
// with no registers held (register loads of a few rows at a time cost
// more than the layer's k8 steps: ablate_sa_tiles.py, variant
// k6_regload), and applies the affine to its own columns once they have
// landed.
__device__ __forceinline__ void load_chunk(const LayerArgs& p, int row0, int k0, int kw,
                                           float* dst, int lane) {
  for (int r = 0; r < 16; ++r) {
    const bool row_in = row0 + r < p.rows;
    const float* src = p.x + static_cast<size_t>(row_in ? row0 + r : 0) * p.cin;
    for (int j = lane; j < kw; j += 32) {
      const bool live = row_in && k0 + j < p.cin;
      cp_async4(dst + r * kActStride + j, src + (live ? k0 + j : 0), live ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!p.relu) return;
  for (int j = lane; j < kw && k0 + j < p.cin; j += 32) {
    // relu(x * 1 + 0) = relu(x) exactly
    const float a = p.a == nullptr ? 1.0f : __ldg(p.a + k0 + j);
    const float c = p.a == nullptr ? 0.0f : __ldg(p.c + k0 + j);
    for (int r = 0; r < 16 && row0 + r < p.rows; ++r) {
      float* v = dst + r * kActStride + j;
      *v = fmaxf(__fadd_rn(__fmul_rn(*v, a), c), 0.0f);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) groupall_layer_kernel(LayerArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  float* act = stages + kStages * 2 * kStepFloats;  // kBlockRows x kActStride
  uint64_t* full_bar = reinterpret_cast<uint64_t*>(act + kBlockRows * kActStride);
  uint64_t* empty_bar = full_bar + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x, pass = blockIdx.y;
  const int kin = pad8(p.cin);
  const int steps = kin / 8;
  const Ring ring{stages, full_bar, empty_bar,
                  p.wpack + static_cast<size_t>(pass) * steps * 2 * kStepFloats, steps,
                  static_cast<uint32_t>(steps)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * kConsumers);  // one arrival per warp
    }
    mbar_fence_init();
    for (int q = 0; q < kAhead; ++q) ring.issue(q);
  }
  __syncthreads();

  float* rows = act + warp * 16 * kActStride;  // this warp's 16 rows
  const int row0 = tile * kBlockRows + warp * 16;
  load_chunk(p, row0, 0, min(kChunk, kin), rows, lane);
  __syncwarp();
  PassAcc acc;
  uint32_t it = 0;
  run_pass(acc, rows, kActStride, min(kChunk, kin) / 8, it, ring, lane);
#pragma unroll 1
  for (int k0 = kChunk; k0 < kin; k0 += kChunk) {  // the rows' later chunks
    const int kw = min(kChunk, kin - k0);
    load_chunk(p, row0, k0, kw, rows, lane);
    __syncwarp();
    accumulate_pass(acc, rows, kActStride, kw / 8, it, ring, lane);
  }

  // z = acc + bias to scratch, and the warp's column sums of z and z^2
  // over its rows into its own rows' space: [2][kPass]
  const int g = lane >> 2, t = lane & 3;
  const int top = row0 + g, bot = row0 + g + 8;
  const bool top_in = top < p.rows, bot_in = bot < p.rows;
  const int col0 = pass * kPass;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int lc = s * 128 + 8 * j + 2 * t;  // column in the pass
      float sum[2], sq[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + lc + h;
        const bool live = col < p.cout;
        const float b = live ? __ldg(p.bias + col) : 0.0f;
        const float zt = acc[s][4 * j + h] + b;
        const float zb = acc[s][4 * j + 2 + h] + b;
        if (live && top_in) p.z[static_cast<size_t>(top) * p.cout + col] = zt;
        if (live && bot_in) p.z[static_cast<size_t>(bot) * p.cout + col] = zb;
        const float vt = top_in ? zt : 0.0f, vb = bot_in ? zb : 0.0f;
        sum[h] = vt + vb;
        sq[h] = vt * vt + vb * vb;
      }
      if (p.partial != nullptr) {  // block-uniform
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sum[h] += __shfl_xor_sync(kFullMask, sum[h], off);
            sq[h] += __shfl_xor_sync(kFullMask, sq[h], off);
          }
        }
        if (g == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rows[lc + h] = sum[h];
            rows[kPass + lc + h] = sq[h];
          }
        }
      }
    }
  }
  if (p.partial == nullptr) return;
  __syncthreads();
  // the tile's sums: the warps' in order, a thread per column
  float* part = p.partial + static_cast<size_t>(tile) * 2 * p.cout;
  for (int lc = threadIdx.x; lc < kPass && col0 + lc < p.cout; lc += kThreads) {
    float sum = 0.0f, sq = 0.0f;
    for (int w = 0; w < 4 * kConsumers; ++w) {
      sum += act[w * 16 * kActStride + lc];
      sq += act[w * 16 * kActStride + kPass + lc];
    }
    part[col0 + lc] = sum;
    part[p.cout + col0 + lc] = sq;
  }
}

// The weight stream of one layer, w (cin, cout) row-major -> out
// (passes, steps, [hi, lo], kStepFloats): element (h, c, q) of a step's
// part is w[8 step + 4 h + q][kPass pass + c], zero past cin and cout, split
// into TF32 hi and lo as split_tf32 does (ops/sa.py
// `layer_weight_pack_reference` is the same layout in PyTorch). One
// thread per element of the hi parts, in the stream's order.
__global__ void weight_pack_kernel(const float* __restrict__ w, int cin, int cout, int steps,
                                   float* __restrict__ out, size_t total) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int in_step = static_cast<int>(e % kStepFloats);
  const size_t block = e / kStepFloats;  // pass * steps + step
  const int q = in_step & 3, c = (in_step >> 2) % kPass, h = in_step / (4 * kPass);
  const int row = 8 * static_cast<int>(block % steps) + 4 * h + q;
  const int col = kPass * static_cast<int>(block / steps) + c;
  const float x = row < cin && col < cout ? __ldg(w + static_cast<size_t>(row) * cout + col) : 0.0f;
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  float* o = out + block * 2 * kStepFloats + in_step;
  o[0] = __uint_as_float(hi);
  o[kStepFloats] = __uint_as_float(lo);
}

// pooled[cloud][col] = max over the cloud's n rows of relu(z * a + c)
// (relu(z) for null a), the rows in order; one thread per (cloud,
// column), a warp on adjacent columns.
__global__ void __launch_bounds__(kPoolThreads) groupall_pool_kernel(
    const float* __restrict__ z, const float* __restrict__ a, const float* __restrict__ c,
    float* __restrict__ out, int clouds, int n, int cout) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(clouds) * cout) return;
  const int col = static_cast<int>(e % cout);
  const float* zc = z + (e / cout) * n * cout + col;
  const float ac = a == nullptr ? 1.0f : __ldg(a + col);
  const float cc = a == nullptr ? 0.0f : __ldg(c + col);
  float m = 0.0f;
#pragma unroll 8  // eight rows' loads in flight
  for (int r = 0; r < n; ++r) {
    m = fmaxf(m, fmaxf(__fadd_rn(__fmul_rn(__ldg(zc + static_cast<size_t>(r) * cout), ac), cc),
                       0.0f));
  }
  out[e] = m;
}

}  // namespace

// One layer over `rows` rows: x (rows, cin) taken as it is for relu 0
// (layer 1), else loaded as relu(x * a + c) with a, c (cin,) the
// BatchNorm affine of x's statistics, or as relu(x) for null a, c;
// wpack the layer's hi/lo weight steps of ops/sa.py `layer_weight_pack`
// (16-byte aligned): ceil(cout / 256) passes of pad8(cin) / 8 steps; bias (cout,); z (rows, cout) the output; partial
// a scratch of ceil(rows / 128) * 2 * cout floats, or null for no
// statistics; with partial, mean, var (cout,) the statistics over the
// rows, and ga, gc (cout,) their BatchNorm affine for the BatchNorm's
// bn_scale, bn_bias (cout,); or, with `sums` (2 * cout + 1 doubles), the
// sums of z and z^2 and the row count there instead, for a reduction
// across ranks that gaddpg_bn_from_sums (sa_train_stats.cu) finishes. All
// float32 contiguous.
extern "C" int gaddpg_groupall_layer(const void* x, const void* a, const void* c,
                                     const void* wpack, const void* bias, void* z,
                                     void* partial, void* mean, void* var, const void* bn_scale,
                                     const void* bn_bias, void* ga, void* gc, void* sums,
                                     int rows, int cin, int cout, int relu, void* stream) {
  if (rows < 0 || cin < 1 || cout < 1 || (a == nullptr) != (c == nullptr) ||
      (a != nullptr && !relu) ||
      reinterpret_cast<uintptr_t>(wpack) % 16) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return cudaSuccess;
  cudaError_t err = allow_smem(groupall_layer_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  LayerArgs p;
  p.x = static_cast<const float*>(x);
  p.a = static_cast<const float*>(a);
  p.c = static_cast<const float*>(c);
  p.wpack = static_cast<const float*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.z = static_cast<float*>(z);
  p.partial = static_cast<float*>(partial);
  p.rows = rows;
  p.cin = cin;
  p.cout = cout;
  p.relu = relu;
  const int tiles = (rows + kBlockRows - 1) / kBlockRows;
  const dim3 grid(tiles, (cout + kPass - 1) / kPass);
  groupall_layer_kernel<<<grid, kThreads, kSmemBytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const BnAffine bn{static_cast<const float*>(bn_scale), static_cast<const float*>(bn_bias),
                    static_cast<float*>(ga), static_cast<float*>(gc)};
  return launch_reduce_stats(p.partial, tiles, nullptr, 1, cout, static_cast<double>(rows),
                             static_cast<float*>(mean), static_cast<float*>(var), bn,
                             static_cast<double*>(sums), st);
}

// w (cin, cout) float32 row-major -> out, the layer's weight stream:
// ceil(cout / 256) * pad8(cin) / 8 steps of 2 * 2048 floats.
extern "C" int gaddpg_weight_pack(const void* w, int cin, int cout, void* out, void* stream) {
  if (cin < 1 || cout < 1) return cudaErrorInvalidValue;
  const int steps = pad8(cin) / 8;
  const size_t total =
      static_cast<size_t>((cout + kPass - 1) / kPass) * steps * kStepFloats;
  constexpr int kPackThreads = 256;
  weight_pack_kernel<<<static_cast<unsigned>((total + kPackThreads - 1) / kPackThreads),
                       kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), cin, cout, steps, static_cast<float*>(out), total);
  return cudaGetLastError();
}

// pooled (clouds, cout) = max over each cloud's n rows of relu(z * a +
// c): z (clouds * n, cout) the last layer's output, a, c (cout,), or
// both null for relu(z).
extern "C" int gaddpg_groupall_pool(const void* z, const void* a, const void* c, void* out,
                                    int clouds, int n, int cout, void* stream) {
  if (clouds < 0 || n < 1 || cout < 1) return cudaErrorInvalidValue;
  const size_t total = static_cast<size_t>(clouds) * cout;
  if (total == 0) return cudaSuccess;
  groupall_pool_kernel<<<static_cast<unsigned>((total + kPoolThreads - 1) / kPoolThreads),
                         kPoolThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(a), static_cast<const float*>(c),
      static_cast<float*>(out), clouds, n, cout);
  return cudaGetLastError();
}
