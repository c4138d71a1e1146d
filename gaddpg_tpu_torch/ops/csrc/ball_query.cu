// K2: ball query (first nsample in-radius points of each centre).
//
// Replaces the Pallas kernel `_ball_group_kernel` / `ball_query_pallas`
// (gaddpg_tpu/ops/pallas_kernels.py:119-182). Semantics: the first
// nsample points with |c - p|^2 <= r^2, in index order; slots left over
// (also when nsample > n, as at SA2) repeat the first hit; a centre with
// no hit gets its nearest point (lowest index on ties) in every slot.
//
// What bounds it on H100: bytes, in the function's count. Each cloud is
// read once and each row written once: at B=1024 on the serving path
// 21.4 MB at SA1 and 17.6 MB at SA2, whose 128-slot rows over 32 points
// are mostly padding, 11.6 us at 3.35 TB/s. The full scan this kernel
// makes costs more than those bytes: at SA1, 33.5M (centre, point) pairs
// of 8 rounded operations, about 11.5 warp instructions a 32 pairs with
// the shared-memory load and the bit (PERF.md, section 6, says what holds
// it). What the design does about each cost of the kernel before it, a
// warp per centre scanning its cloud from device memory until nsample
// hits:
//  - Each cloud was read by each of its 32 centres' warps. A block now
//    reads its cloud once, with 16-byte loads where its offset allows,
//    into shared memory as a float4 a point, and takes all its centres,
//    or a group of them where few clouds would leave SMs idle
//    (ops/sampling.py `ball_query_layout` chooses from B, S, N and the
//    card's SM count).
//  - Each 32-point step waited on its own loads and ended in a
//    data-dependent break. Hit masks are now made with no serial chain:
//    for a cloud of several 32-point chunks, lane i of a warp holds
//    centre i and tests one chunk's points in order, each a broadcast
//    from shared memory, setting bit p for a hit of point p; with fewer
//    than 16 centres to a block (B=1) a ballot over a lane per point
//    gives one mask. The scan does not stop at nsample hits.
//  - Every lane tracked its nearest point at every step. The nearest
//    point is now looked for only by a centre with no hit, in a
//    warp-uniform branch that the main path, whose centres are points of
//    their cloud, never takes.
//  - Hits were scattered 4-byte stores, and SA2's rows four stores a
//    lane. Slots now come from a prefix count: a half warp per centre,
//    lane l holds masks 2l and 2l + 1, an exclusive scan of the popcounts
//    over the half gives its first slot and it writes its set bits,
//    lowest first, into the half's row in shared memory below nsample
//    (more than 32 chunks loop with the count carried; a one-chunk cloud's
//    mask is one ballot and lane l writes points 2l and 2l + 1). Two
//    centres a warp keep two such chains in flight. The row goes out in
//    16-byte stores, consecutive lanes on consecutive addresses, slots
//    from the hit count on taking the first hit as they are stored.
// No atomics: launches are deterministic. Distances round exactly like
// the plain version (gaddpg::sq_dist), so the indices agree bit for bit.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // ops/sampling.py BALL_QUERY_WARPS
constexpr int kThreads = 32 * kWarps;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared memory of one block, in 4-byte words: the cloud's points (a
// float4 each); a float4 per centre of the block; its hit masks
// (`mstride`: the chunk count, made odd so that 32 centres' masks of one
// chunk lie in 32 banks); and a row of nsample slots for each half warp. ops/sampling.py `ball_query_smem_bytes` is the same sum.
struct Layout {
  int point, centre, mask, row, mstride;
  __host__ __device__ Layout(int centres, int n, int nsample) {
    mstride = ((n + 31) >> 5) | 1;
    point = 4 * n;
    centre = 4 * centres;
    mask = round4(centres * mstride);
    row = round4(nsample);
  }
  __host__ __device__ size_t bytes() const {
    return 4 * static_cast<size_t>(point + centre + mask + 2 * kWarps * row);
  }
};

// A block takes one cloud and its centres [s0, s0 + centres), a group of
// them (blockIdx.x = cloud * groups + group): nc centres, numbered r.
__global__ void __launch_bounds__(kThreads, 8)
    ball_query_kernel(const float* __restrict__ centers, const float* __restrict__ xyz,
                      int s, int n, float r2, int nsample, int centres, bool vec,
                      int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(centres, n, nsample);
  float4* pts = reinterpret_cast<float4*>(smem);
  float4* ctr = reinterpret_cast<float4*>(smem + lay.point);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + lay.point + lay.centre);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* rows = reinterpret_cast<int*>(smem + lay.point + lay.centre + lay.mask);

  const int groups = (s + centres - 1) / centres;
  const int b0 = blockIdx.x / groups;
  const int s0 = blockIdx.x % groups * centres;
  const int nc = min(centres, s - s0);  // centres of this block
  const int nchunks = (n + 31) >> 5;

  // The cloud, read once: 16 bytes a thread where it starts on a 16-byte
  // boundary, each float put in its point's float4; then the centres.
  {
    const float* src = xyz + static_cast<size_t>(b0) * n * 3;
    float* dst = smem;
    const int len = n * 3;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int i = tid; i < (len >> 2); i += kThreads) {
        const float4 v = __ldg(src4 + i);
        const int e = i << 2;
        dst[(e / 3) * 4 + e % 3] = v.x;
        dst[((e + 1) / 3) * 4 + (e + 1) % 3] = v.y;
        dst[((e + 2) / 3) * 4 + (e + 2) % 3] = v.z;
        dst[((e + 3) / 3) * 4 + (e + 3) % 3] = v.w;
      }
      head = len & ~3;
    }
    for (int e = head + tid; e < len; e += kThreads) dst[(e / 3) * 4 + e % 3] = __ldg(src + e);
    for (int r = tid; r < nc; r += kThreads) {
      const float* p = centers + (static_cast<size_t>(b0) * s + s0 + r) * 3;
      ctr[r] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.0f);
    }
  }
  __syncthreads();

  // Hit masks, bit l of mask (r, k) for point 32 k + l, for clouds of more
  // than one chunk (a one-chunk mask is made where its row is). With at
  // least 16 centres to a block, a unit is (chunk, up to 32 centres):
  // lane i holds centre i and tests the chunk's points in order, each read
  // once for the warp (a broadcast), no lane waiting on another.
  // With fewer, a unit is (centre, chunk): lane l holds point l and one
  // ballot gives the mask.
  if (nchunks > 1) {
    const int cgroups = (nc + 31) >> 5;
    if (nc >= 16) {
      for (int u = warp; u < nchunks * cgroups; u += kWarps) {
        const int cg = u % cgroups, k = u / cgroups;
        const int j = (cg << 5) + lane;
        const float4 cc = ctr[min(j, nc - 1)];
        const float4* pk = pts + (k << 5);
        const int lim = min(32, n - (k << 5));
        unsigned word = 0u;
        if (lim == 32) {
#pragma unroll
          for (int p = 0; p < 32; ++p) {
            const float4 q = pk[p];
            if (gaddpg::sq_dist(cc.x, cc.y, cc.z, q.x, q.y, q.z) <= r2) word |= 1u << p;
          }
        } else {
          for (int p = 0; p < lim; ++p) {
            const float4 q = pk[p];
            if (gaddpg::sq_dist(cc.x, cc.y, cc.z, q.x, q.y, q.z) <= r2) word |= 1u << p;
          }
        }
        if (j < nc) masks[j * lay.mstride + k] = word;
      }
    } else {
      for (int u = warp; u < nc * nchunks; u += kWarps) {
        const int r = u / nchunks, k = u - r * nchunks;
        const int p = (k << 5) + lane;
        const float4 cc = ctr[r];
        const float4 q = pts[min(p, n - 1)];
        const bool hit = p < n && gaddpg::sq_dist(cc.x, cc.y, cc.z, q.x, q.y, q.z) <= r2;
        const unsigned word = __ballot_sync(gaddpg::kFullMask, hit);
        if (lane == 0) masks[r * lay.mstride + k] = word;
      }
    }
    __syncthreads();
  }

  // Rows: a half warp per centre, two centres a warp (lanes 16 h to
  // 16 h + 15 take centre r0 + h), each built in the half's row and
  // written out.
  const int h = lane >> 4, hl = lane & 15;
  int* row = rows + (2 * warp + h) * lay.row;
  for (int r0 = 2 * warp; r0 < nc; r0 += 2 * kWarps) {
    const int r = r0 + h;
    const bool live = r < nc;
    int count = 0;   // hits so far, the same in the half's lanes
    int first = -1;  // the first hit
    if (nchunks == 1) {  // a ballot a centre; lane l writes points 2l, 2l + 1 if hits
      unsigned w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 cc = ctr[min(r0 + i, nc - 1)], q = pts[min(lane, n - 1)];
        w[i] = __ballot_sync(gaddpg::kFullMask,
                             lane < n && gaddpg::sq_dist(cc.x, cc.y, cc.z, q.x, q.y, q.z) <= r2);
      }
      const unsigned wh = live ? w[h] : 0u;
      count = __popc(wh);
      first = __ffs(wh) - 1;
#pragma unroll
      for (int j = 2 * hl; j < 2 * hl + 2; ++j) {
        const int slot = __popc(wh & ((1u << j) - 1u));
        if (((wh >> j) & 1u) && slot < nsample) row[slot] = j;
      }
    } else {  // lane l writes the hits of masks 2l and 2l + 1 from its first slot on
      const unsigned* mrow = masks + min(r, nc - 1) * lay.mstride;
      for (int k0 = 0; k0 < nchunks; k0 += 32) {
        const int k = k0 + 2 * hl;
        unsigned w0 = live && k < nchunks ? mrow[k] : 0u;
        unsigned w1 = live && k + 1 < nchunks ? mrow[k + 1] : 0u;
        const int pc = __popc(w0) + __popc(w1);
        int incl = pc;
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
          const int t = __shfl_up_sync(gaddpg::kFullMask, incl, off, 16);
          if (hl >= off) incl += t;
        }
        const unsigned nz = (__ballot_sync(gaddpg::kFullMask, (w0 | w1) != 0u) >> (h << 4)) & 0xffffu;
        const int fl = nz != 0u ? __ffs(nz) - 1 : 0;
        const unsigned f0 = __shfl_sync(gaddpg::kFullMask, w0, fl, 16);
        const unsigned f1 = __shfl_sync(gaddpg::kFullMask, w1, fl, 16);
        if (first < 0 && nz != 0u)
          first = f0 != 0u ? ((k0 + 2 * fl) << 5) + __ffs(f0) - 1
                           : ((k0 + 2 * fl + 1) << 5) + __ffs(f1) - 1;
        int slot = count + incl - pc;
        for (; w0 != 0u && slot < nsample; ++slot) {
          row[slot] = (k << 5) + __ffs(w0) - 1;
          w0 &= w0 - 1u;
        }
        for (; w1 != 0u && slot < nsample; ++slot) {
          row[slot] = ((k + 1) << 5) + __ffs(w1) - 1;
          w1 &= w1 - 1u;
        }
        count += __shfl_sync(gaddpg::kFullMask, incl, 15, 16);
        if (__all_sync(gaddpg::kFullMask, count >= nsample || !live)) break;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a centre with no hit: its nearest point, lowest index on ties
      if (!__shfl_sync(gaddpg::kFullMask, live && count == 0, i << 4)) continue;
      const float4 cc = ctr[r0 + i];
      float dmin = __int_as_float(0x7f800000);  // +inf
      int imin = n;
      for (int p = lane; p < n; p += 32) {
        const float4 q = pts[p];
        const float d2 = gaddpg::sq_dist(cc.x, cc.y, cc.z, q.x, q.y, q.z);
        if (d2 < dmin || p == lane) {
          dmin = d2;
          imin = p;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(gaddpg::kFullMask, dmin, off);
        const int kk = __shfl_xor_sync(gaddpg::kFullMask, imin, off);
        if (v < dmin || (v == dmin && kk < imin)) {
          dmin = v;
          imin = kk;
        }
      }
      if (h == i) first = imin;
    }
    __syncwarp();
    // 16 bytes a lane, consecutive lanes on consecutive addresses; slots
    // from the hit count on take the first hit
    if (live) {
      const int kept = min(count, nsample);
      int* o = out + (static_cast<size_t>(b0) * s + s0 + r) * nsample;
      if (vec) {
        for (int t4 = hl; t4 < (nsample >> 2); t4 += 16) {
          const int t = t4 << 2;
          int4 v = make_int4(first, first, first, first);
          if (t < kept) {
            const int4 x = reinterpret_cast<const int4*>(row)[t4];
            v.x = x.x;
            if (t + 1 < kept) v.y = x.y;
            if (t + 2 < kept) v.z = x.z;
            if (t + 3 < kept) v.w = x.w;
          }
          reinterpret_cast<int4*>(o)[t4] = v;
        }
      } else {
        for (int t = hl; t < nsample; t += 16) o[t] = t < kept ? row[t] : first;
      }
    }
    __syncwarp();  // the rows are the next centres'
  }
}

}  // namespace

// centers (b, s, 3), xyz (b, n, 3) float32 contiguous -> out (b, s, nsample)
// int32. r2 is the squared radius, already rounded to float32. A block
// takes `centres` centres of one cloud (ops/sampling.py `ball_query_layout`).
extern "C" int gaddpg_ball_query(const void* centers, const void* xyz, int b, int s, int n,
                                 float r2, int nsample, int centres, void* out, void* stream) {
  if (b < 1 || s < 1 || n < 1 || nsample < 1 || centres < 1) return cudaErrorInvalidValue;
  const size_t smem = Layout(centres, n, nsample).bytes();
  if (smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t err = gaddpg::allow_smem(ball_query_kernel, smem);
  if (err != cudaSuccess) return err;
  const int groups = (s + centres - 1) / centres;
  const int blocks = groups * b;
  const bool vec = nsample % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  ball_query_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const float*>(xyz), s, n, r2, nsample,
      centres, vec, static_cast<int*>(out));
  return cudaGetLastError();
}
