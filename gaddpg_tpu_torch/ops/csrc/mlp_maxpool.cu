// K4: eval group-all set-abstraction level (3x folded Dense+ReLU -> max).
//
// Replaces the Pallas kernel `_mlp_maxpool_kernel` / `mlp_maxpool`
// (gaddpg_tpu/ops/pallas_sa.py:109-163): every row of a cloud's (N, C_in)
// table goes through three Dense layers with BatchNorm folded in, each
// followed by ReLU, and the rows are max-reduced per cloud.
//
// What bounds it on H100: operations. At SA3 (N = 32, 259 -> 256 -> 256
// -> 512) a cloud is 2 * 32 * 262,912 = 16.8 MFLOP against 33 KB of
// input; in fp32 on the tensor cores (3xTF32) that is 0.10 ms at B =
// 1024. The 1.06 MB of folded weights fit in L2, not in shared memory.
//
// Design: the B * N rows form one row-tiled GEMM chain. A block holds two
// 64-row tiles (two clouds each at N = 32), one per consumer warpgroup,
// and walks the tiles persistently. The products run on `wgmma`
// (m64n128k8, TF32) in 3xTF32: x * w = lo(x) hi(w) + hi(x) lo(w) +
// hi(x) hi(w), small terms first, the lo * lo term (2^-22 relative)
// dropped. The wrapper splits the weights once per call into TF32 hi
// and lo parts and lays each k8 step of each 256-column pass out as the
// K-major core-matrix tiles wgmma reads (ops/sa.py `k4_weight_pack`), so
// one thread streams them with TMA bulk copies (16 KB a step) through a
// ring of five shared-memory stages, three steps ahead, guarded by
// full/empty mbarriers; both warpgroups read every stage. A step's
// products stay in flight while the next step's A fragment is loaded and
// its products issued. The accumulators of a pass (64 x 256 per
// warpgroup, 128 registers a thread) stay in registers: eight warps, so
// a thread may hold 255. Activations live in shared
// memory as fp32; each warp owns 16 rows, reads them as wgmma's A
// operand from registers (split into hi and lo once per pass as it loads
// them) and writes its layer outputs back over them, so the warps of a
// warpgroup never wait on each other. The last layer is max-pooled by
// cloud in the epilogue: a warp whose 16 rows lie in one cloud reduces
// them with shuffles and does one atomicMax per column on the output
// (zeroed by the wrapper; ReLU outputs are >= 0, so their int bits order
// like the floats and max does not depend on order: two launches agree
// bit for bit); other warps do one per element.
//
// The first layer's input rows are C_in = 259 floats, 1,036 bytes apart:
// not 16-byte aligned, so neither TMA nor vector loads take them as they
// are. Each warp loads its 16 rows with plain coalesced loads (the rows
// are contiguous in memory) and zero-fills columns C_in .. pad8(C_in) and
// the rows past B * N; that is 33 KB per cloud against 2 MB of weight
// traffic per tile, so a padded copy of the table would buy nothing.
//
// Widths: C_in up to kMaxIn, the two hidden layers 256, the output a
// multiple of 256 (ops/sa.py `_check_kernel_layout`).

#include "hopper.cuh"

namespace {

using namespace gaddpg;

constexpr int kRows = 64;                        // rows of a warpgroup's tile (wgmma M)
constexpr int kConsumers = 2;                    // consumer warpgroups of a block
constexpr int kBlockRows = kRows * kConsumers;
constexpr int kThreads = 128 * kConsumers;    // 8 warps: up to 255 registers
constexpr int kHidden = 256;                     // width of both hidden layers
constexpr int kMaxIn = 288;                      // widest input the tiles hold
constexpr int kLoadBatch = 44;  // loads a lane keeps in flight: 3 round trips at C_in = 259

__host__ __device__ inline int pad8(int c) { return (c + 7) & ~7; }

// Row stride of the activation tile: 4 mod 8 floats, so the eight rows a
// warp's A fragment reads fall in distinct banks.
__host__ __device__ inline int act_stride(int cin) {
  return pad8(cin > kHidden ? cin : kHidden) + 4;
}

size_t smem_bytes(int cin) {
  return static_cast<size_t>(kStages) * kStageBytes +
         sizeof(float) * kBlockRows * static_cast<size_t>(act_stride(cin)) +
         2 * kStages * sizeof(uint64_t);
}

struct Args {
  const float* full;   // (rows, cin)
  const float* wpack;  // (steps, 2, kStepFloats), k4_weight_pack
  const float* bias[3];
  float* out;          // (b, c3), zeroed
  int rows, n, cin, c3;
};

// The warp's 16 rows [row0, row0 + 16) of `full` into dst (stride as),
// columns cin .. kin and rows past `rows` zero.
__device__ __forceinline__ void load_rows(const Args& a, int row0, int kin, float* dst, int as,
                                          int lane) {
  const int total = 16 * kin;
  for (int e0 = lane; e0 < total; e0 += 32 * kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + 32 * u;
      const int r = e / kin;
      const int k = e - r * kin;
      v[u] = (e < total && k < a.cin && row0 + r < a.rows)
                 ? __ldg(a.full + static_cast<size_t>(row0 + r) * a.cin + k)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + 32 * u;
      if (e < total) dst[(e / kin) * as + e % kin] = v[u];
    }
  }
}

// relu(acc + bias) of the warp's 16 rows into `rows` (columns 0 .. kPass).
__device__ __forceinline__ void store_pass(const PassAcc& acc, const float* __restrict__ bias,
                                           float* rows, int as, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = s * 128 + 8 * j + 2 * t;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
      *reinterpret_cast<float2*>(rows + g * as + col) =
          make_float2(fmaxf(acc[s][4 * j] + b0, 0.0f), fmaxf(acc[s][4 * j + 1] + b1, 0.0f));
      *reinterpret_cast<float2*>(rows + (g + 8) * as + col) =
          make_float2(fmaxf(acc[s][4 * j + 2] + b0, 0.0f), fmaxf(acc[s][4 * j + 3] + b1, 0.0f));
    }
  }
}

__device__ __forceinline__ void pool_max(float* p, float v) {
  atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
}

// out[cloud][col0 + c] = max over the warp's rows of that cloud of
// relu(acc + bias), rows past a.rows left out.
__device__ __forceinline__ void pool_pass(const PassAcc& acc, const float* __restrict__ bias,
                                          const Args& a, int row0, int col0, int lane) {
  if (row0 >= a.rows) return;
  const int g = lane >> 2, t = lane & 3;
  const int top = row0 + g, bot = row0 + g + 8;
  const bool top_in = top < a.rows, bot_in = bot < a.rows;
  const int seg = row0 / a.n;
  const bool one_cloud = min(row0 + 15, a.rows - 1) / a.n == seg;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + s * 128 + 8 * j + 2 * t;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
      const float v0 = top_in ? fmaxf(acc[s][4 * j] + b0, 0.0f) : 0.0f;
      const float v1 = top_in ? fmaxf(acc[s][4 * j + 1] + b1, 0.0f) : 0.0f;
      const float v2 = bot_in ? fmaxf(acc[s][4 * j + 2] + b0, 0.0f) : 0.0f;
      const float v3 = bot_in ? fmaxf(acc[s][4 * j + 3] + b1, 0.0f) : 0.0f;
      if (one_cloud) {  // warp-uniform
        float m0 = fmaxf(v0, v2), m1 = fmaxf(v1, v3);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(gaddpg::kFullMask, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(gaddpg::kFullMask, m1, off));
        }
        if (g == 0) {
          pool_max(a.out + static_cast<size_t>(seg) * a.c3 + col, m0);
          pool_max(a.out + static_cast<size_t>(seg) * a.c3 + col + 1, m1);
        }
      } else {
        if (top_in) {
          pool_max(a.out + static_cast<size_t>(top / a.n) * a.c3 + col, v0);
          pool_max(a.out + static_cast<size_t>(top / a.n) * a.c3 + col + 1, v1);
        }
        if (bot_in) {
          pool_max(a.out + static_cast<size_t>(bot / a.n) * a.c3 + col, v2);
          pool_max(a.out + static_cast<size_t>(bot / a.n) * a.c3 + col + 1, v3);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) mlp_maxpool_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int as = act_stride(a.cin);
  float* stages = reinterpret_cast<float*>(smem_raw);
  float* act = stages + kStages * 2 * kStepFloats;  // kBlockRows x as
  uint64_t* full_bar = reinterpret_cast<uint64_t*>(act + kBlockRows * as);
  uint64_t* empty_bar = full_bar + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kin = pad8(a.cin);
  const int passes = a.c3 / kPass;
  const int tiles = (a.rows + kBlockRows - 1) / kBlockRows;
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int per_tile = kin / 8 + kHidden / 8 + passes * (kHidden / 8);
  const Ring ring{stages, full_bar, empty_bar, a.wpack, per_tile,
                  static_cast<uint32_t>(my_tiles * per_tile)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gaddpg::mbar_init(&full_bar[s], 1);
      gaddpg::mbar_init(&empty_bar[s], 4 * kConsumers);  // one arrival per warp
    }
    gaddpg::mbar_fence_init();
    for (int q = 0; q < kAhead; ++q) ring.issue(q);
  }
  __syncthreads();

  const int wg = warp >> 2, wq = warp & 3;
  float* rows = act + (wg * kRows + wq * 16) * as;  // this warp's 16 rows
  uint32_t it = 0;
  PassAcc acc;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kBlockRows + wg * kRows + wq * 16;
    load_rows(a, row0, kin, rows, as, lane);
    __syncwarp();
    run_pass(acc, rows, as, kin / 8, it, ring, lane);
    store_pass(acc, a.bias[0], rows, as, lane);
    __syncwarp();
    run_pass(acc, rows, as, kHidden / 8, it, ring, lane);
    store_pass(acc, a.bias[1], rows, as, lane);
    __syncwarp();
    for (int p = 0; p < passes; ++p) {
      run_pass(acc, rows, as, kHidden / 8, it, ring, lane);
      pool_pass(acc, a.bias[2], a, row0, p * kPass, lane);
    }
    __syncwarp();  // the rows are reloaded for the next tile
  }
}

}  // namespace

// full (b, n, cin); wpack: the hi/lo weight stages of ops/sa.py
// k4_weight_pack (16-byte aligned); b1 (256,), b2 (256,), b3 (c3,) with
// BatchNorm folded in; out (b, c3), zeroed. All float32 contiguous.
// cin <= kMaxIn, c3 a multiple of 256.
extern "C" int gaddpg_mlp_maxpool(const void* full, const void* wpack, const void* b1,
                                  const void* b2, const void* b3, void* out, int b, int n,
                                  int cin, int c3, void* stream) {
  if (b < 0 || n < 1 || cin < 1 || cin > kMaxIn || c3 < kPass || c3 % kPass ||
      reinterpret_cast<uintptr_t>(wpack) % 16) {
    return cudaErrorInvalidValue;
  }
  if (b == 0) return cudaSuccess;
  const size_t smem = smem_bytes(cin);
  cudaError_t err = gaddpg::allow_smem(mlp_maxpool_kernel, smem);
  if (err != cudaSuccess) return err;
  const int sms = gaddpg::sm_count();
  Args a;
  a.full = static_cast<const float*>(full);
  a.wpack = static_cast<const float*>(wpack);
  a.bias[0] = static_cast<const float*>(b1);
  a.bias[1] = static_cast<const float*>(b2);
  a.bias[2] = static_cast<const float*>(b3);
  a.out = static_cast<float*>(out);
  a.rows = b * n;
  a.n = n;
  a.cin = cin;
  a.c3 = c3;
  const int tiles = (a.rows + kBlockRows - 1) / kBlockRows;
  mlp_maxpool_kernel<<<tiles < sms ? tiles : sms, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
