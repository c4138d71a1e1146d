#!/usr/bin/env python3
"""Step-by-step ablation of the grouped set-abstraction kernels K3 and K5 on
one CUDA card: what each step of their redesign buys.

    python3 ablate_sa_tiles.py [--parent DIR]

Writes two variants of `gaddpg_tpu_torch` under build/ablate/ (copies of
the package with one piece of the kernels swapped), then times each
package in its own process, in the order parent, compaction, no
recompute, final, final, no recompute, compaction, parent:

  parent       the package in DIR (an unpacked earlier commit), if given:
               K3 one block per centre over every slot, K5 recomputing
               stats passes then K3 as its final forward;
  compaction   distinct slots in 64-row tiles, the dense layers as fp32
               FMA on the CUDA cores with the same tile and accumulator
               layout, K5 recomputing layers 1..i-1 in stats pass i and
               running K3 on batch-stat-folded weights as its final
               forward;
  no_recompute the same CUDA-core layers, K5 running each layer once
               (z scratch) and pooling itself;
  final        this checkout: the dense layers on the tensor cores in
               3xTF32.

Each process prints one JSON line: K3 per level at B=1024 on chip_smoke.py's
synthetic serving clouds and K5 per policy level at B=256 on its synthetic
train clouds (CUDA events, chip_smoke.cuda_ms; distinct-row share and the
largest difference from the plain version beside each), select_action at
B=1024 (host clock) and the DDPG update at B=256 x 1030 (host clock, median
of 3 after a warm-up) with its peak memory. Needs a card; the variants
build their kernels into their own build/ directories.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ablate"

# the dense layer on the CUDA cores: the tensor-core version's weight
# staging, tile and accumulator layout, one fp32 FMA per product
FMA_DENSE = r'''
__device__ __forceinline__ void dense_tf32x3(const float* act, int cin,
                                             const float* __restrict__ w, int cout,
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
  __syncthreads();
  stage_weights(w, cin, cout, 0, wbuf);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage_weights(w, cin, cout, ch + 1, wbuf + ((ch + 1) & 1) * kWeightChunk * ws);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wb = wbuf + (ch & 1) * kWeightChunk * ws;
#pragma unroll 4
    for (int kk = 0; kk < kWeightChunk; ++kk) {
      const int k = ch * kWeightChunk + kk;
      if (k < kin) {
        float a[2][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][0] = act[(wr * 32 + 16 * m + g) * as + k];
          a[m][1] = act[(wr * 32 + 16 * m + g + 8) * as + k];
        }
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) {
          if (4 * j + wc < ntiles) {
            const float2 bv =
                *reinterpret_cast<const float2*>(wb + kk * ws + 8 * (4 * j + wc) + 2 * t);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              acc[m][j][0] = fmaf(a[m][0], bv.x, acc[m][j][0]);
              acc[m][j][1] = fmaf(a[m][0], bv.y, acc[m][j][1]);
              acc[m][j][2] = fmaf(a[m][1], bv.x, acc[m][j][2]);
              acc[m][j][3] = fmaf(a[m][1], bv.y, acc[m][j][3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

'''

# K5 stats pass `upto` that gathers its rows and recomputes layers
# 1..upto-1 with the earlier passes' BatchNorm affines
RECOMPUTE_KERNEL = r'''
struct Mlp3 {
  const float* w[3];
  const float* b[3];
  const float* a[2];
  const float* c[2];
  int width[4];
};

__global__ void __launch_bounds__(kTileThreads, 2) sa_train_recompute_kernel(
    RowList list, int groups, const float* __restrict__ full, const float* __restrict__ cpad,
    Mlp3 p, float* __restrict__ partial, int s, int n, int upto, int widest, int widest_act) {
  extern __shared__ float4 smem4[];
  const TileSmem t = tile_smem(reinterpret_cast<float*>(smem4), widest, widest_act);
  const int total = list.start[groups];
  const int tiles = (total + kRowTile - 1) / kRowTile;
  const int cout = p.width[upto];
  const int as_out = act_stride(cout);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRowTile;
    const int rows = min(kRowTile, total - row0);
    __syncthreads();
    load_rows(list, row0, rows, t);
    gather_tile(rows, full, cpad, s, n, p.width[0], t);
    TileAcc acc;
    for (int l = 0; l + 1 < upto; ++l) {
      const int c = p.width[l + 1];
      dense_tf32x3(t.act, p.width[l], p.w[l], c, t.wbuf, acc);
      store_tile(acc, p.b[l], c, false, t.act);
      __syncthreads();
      const int as = act_stride(c);
      for (int e = threadIdx.x; e < kRowTile * c; e += blockDim.x) {
        const int r = e / c, j = e - r * c;
        float* v = t.act + r * as + j;
        *v = fmaxf(__fadd_rn(__fmul_rn(*v, p.a[l][j]), p.c[l][j]), 0.0f);
      }
    }
    dense_tf32x3(t.act, p.width[upto - 1], p.w[upto - 1], cout, t.wbuf, acc);
    store_tile(acc, p.b[upto - 1], cout, false, t.act);
    __syncthreads();
    float* part = partial + static_cast<size_t>(tile) * 2 * cout;
    for (int col = threadIdx.x; col < cout; col += blockDim.x) {
      float sum = 0.0f, sq = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float z = t.act[r * as_out + col];
        const float mz = static_cast<float>(t.mult[r]) * z;
        sum += mz;
        sq = fmaf(mz, z, sq);
      }
      part[col] = sum;
      part[cout + col] = sq;
    }
  }
}

}  // namespace

extern "C" int gaddpg_sa_train_recompute(
    const void* idx, const void* full, const void* cpad, const void* w1, const void* b1,
    const void* a1, const void* c1, const void* w2, const void* b2, const void* a2,
    const void* c2, const void* w3, const void* b3, void* partial, void* rows, void* mean,
    void* var, int batch, int s, int k, int n, int cin, int d1, int d2, int d3, int upto,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = batch * s;
  const RowList list = row_list(rows, groups, k);
  cudaError_t err = compact_groups(static_cast<const int*>(idx), groups, k, list, st);
  if (err != cudaSuccess) return err;
  Mlp3 p;
  const void* w[3] = {w1, w2, w3};
  const void* b[3] = {b1, b2, b3};
  for (int l = 0; l < 3; ++l) {
    p.w[l] = static_cast<const float*>(w[l]);
    p.b[l] = static_cast<const float*>(b[l]);
  }
  p.a[0] = static_cast<const float*>(a1);
  p.a[1] = static_cast<const float*>(a2);
  p.c[0] = static_cast<const float*>(c1);
  p.c[1] = static_cast<const float*>(c2);
  p.width[0] = cin;
  p.width[1] = d1;
  p.width[2] = d2;
  p.width[3] = d3;
  int widest = d1;
  for (int l = 2; l <= upto; ++l) widest = std::max(widest, p.width[l]);
  const int widest_act = std::max(cin, widest);
  const size_t smem = tile_smem_bytes(widest, widest_act);
  int grid = 0;
  err = tile_grid(sa_train_recompute_kernel, smem, groups * k, &grid);
  if (err != cudaSuccess) return err;
  sa_train_recompute_kernel<<<grid, kTileThreads, smem, st>>>(
      list, groups, static_cast<const float*>(full), static_cast<const float*>(cpad), p,
      static_cast<float*>(partial), s, n, upto, widest, widest_act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_stats(static_cast<const float*>(partial), 0, list.start + groups,
                             kRowTile, p.width[upto], static_cast<double>(groups) * k,
                             static_cast<float*>(mean), static_cast<float*>(var), st);
}

namespace {
'''

# K5's wrapper for the recomputing passes: three stats passes, then K3
RECOMPUTE_WRAPPER = '''def _sa_train_kernels(group_idx, full, cpad, dense):
    from gaddpg_tpu_torch.ops.sa import sa_gather_mlp
    b, s, k = group_idx.shape
    n, cin = full.shape[1:]
    dev = full.device
    widths = [cin] + [w.shape[1] for w, _, _, _ in dense]
    rows = torch.empty(row_list_ints(b * s, k), dtype=torch.int32, device=dev)
    tiles = -(-(b * s * k) // ROW_TILE)
    stats, affine = [], []
    for upto in (1, 2, 3):
        cout = widths[upto]
        partial = torch.empty((tiles, 2, cout), dtype=torch.float32, device=dev)
        mean = torch.empty(cout, dtype=torch.float32, device=dev)
        var = torch.empty(cout, dtype=torch.float32, device=dev)
        ptrs = []
        for i, (w, w_bias, _, _) in enumerate(dense):
            ptrs += [w.data_ptr(), w_bias.data_ptr()]
            if i < 2:
                a, c = affine[i] if i < upto - 1 else (None, None)
                ptrs += [0 if a is None else a.data_ptr(), 0 if c is None else c.data_ptr()]
        build.launch("sa_train_recompute", dev, group_idx.data_ptr(), full.data_ptr(),
                     cpad.data_ptr(), *ptrs, partial.data_ptr(), rows.data_ptr(),
                     mean.data_ptr(), var.data_ptr(), b, s, k, n, cin, *widths[1:], upto)
        _, _, scale, bias = dense[upto - 1]
        affine.append(bn_affine(mean, var, scale, bias))
        stats.append((mean, var))
    sa_train_fused.launches += 1
    return sa_gather_mlp(group_idx, full, cpad, _folded(dense, affine)), tuple(stats)


'''


def _replace(path, old, new):
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{path}: the text to swap is not there once")
    path.write_text(text.replace(old, new))


def _between(path, start, end, new):
    """Replace path's text from the line starting `start` up to `end`."""
    text = path.read_text()
    i0, i1 = text.index(start), text.index(end)
    path.write_text(text[:i0] + new + text[i1:])


def write_variants():
    """build/ablate/{no_recompute,compaction}/gaddpg_tpu_torch."""
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {}
    for name in ("no_recompute", "compaction"):
        pkg = OUT / name / "gaddpg_tpu_torch"
        shutil.copytree(ROOT / "gaddpg_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        tile = pkg / "ops" / "csrc" / "sa_tile.cuh"
        _between(tile, "__device__ __forceinline__ void dense_tf32x3(",
                 "// act (kRowTile x cout, stride act_stride(cout)) = acc + b", FMA_DENSE)
        dirs[name] = pkg.parent
    pkg = dirs["compaction"] / "gaddpg_tpu_torch"
    _replace(pkg / "ops" / "csrc" / "sa_train_stats.cu",
             "}  // namespace\n\n// K5 pass `layer`", RECOMPUTE_KERNEL + "}  // namespace\n\n// K5 pass `layer`")
    _replace(pkg / "ops" / "build.py", '    "contact_scan": ("contact_scan",',
             '    "sa_train_recompute": ("sa_train_stats", "gaddpg_sa_train_recompute",\n'
             '                           (_P,) * 17 + (_I,) * 9 + (_P,)),\n'
             '    "contact_scan": ("contact_scan",')
    _between(pkg / "ops" / "sa_train.py", "def _sa_train_kernels(",
             "def _groupall_train_kernels(", RECOMPUTE_WRAPPER)
    return dirs


def _distinct(idx):
    """Share of the slots that are distinct (ops/sa.py `distinct_slots`),
    counted here so that an earlier package without it can be timed."""
    kept = (idx[..., 1:] != idx[..., :1]).sum() + idx[..., 0].numel()
    return kept.item() / idx.numel()


def measure(tag):
    """One package's numbers (the one first on sys.path) as a dict."""
    import torch

    import chip_smoke as cs
    import gaddpg_tpu_torch
    from gaddpg_tpu_torch.agents import make_ddpg_update, make_select_action

    torch.manual_seed(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"variant": tag, "package": str(Path(gaddpg_tpu_torch.__file__).parent)}
    with torch.no_grad():
        sm = cs.Smoke()
        ps = cs.synthetic_point_state(1024, gen, sm.hand_points, sm.device)
        for label, args in sm.level_inputs(ps)["sa_gather_mlp"]:
            err = (sm.sa.sa_gather_mlp(*args) - sm.sa.sa_gather_mlp_reference(*args)).abs().max()
            out[f"K3 {label} B=1024"] = {
                "ms": cs.cuda_ms(lambda: sm.sa.sa_gather_mlp(*args)),
                "distinct": _distinct(args[0]),
                "max_abs_err": err.item()}
        for label, kernel, args in sm.train_calls(256, gen):
            if kernel != "sa_train" or not label.startswith("policy"):
                continue
            got = sm.sa_train.sa_train_fused(*args)[0]
            err = (got - sm.sa_train.sa_train_reference(*args)[0]).abs().max()
            out[f"K5 {label} B=256"] = {
                "ms": cs.cuda_ms(lambda: sm.sa_train.sa_train_fused(*args), reps=5, rounds=5),
                "distinct": _distinct(args[0]),
                "max_abs_err": err.item()}
        select = make_select_action(sm.cfg)
        remain = torch.full((1024,), 10.0, device=sm.device)
        out["select_action B=1024 ms"] = cs.host_ms(lambda: select(sm.state, ps, remain), reps=10)
    ddpg = make_ddpg_update(sm.cfg)
    batch = sm.learner_batch(cs.TRAIN_BATCH, gen)
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + cs.TIMED_UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddpg(sm.train_state, batch, gen)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    out["ddpg update ms"] = statistics.median(times)
    out["ddpg peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="an unpacked earlier commit to time first")
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # one variant, in a child process
    args = ap.parse_args()
    if args.measure:
        if Path(sys.path[0]).resolve() == ROOT:  # the package comes from PYTHONPATH
            sys.path.pop(0)
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ablate_sa_tiles: no CUDA device available", file=sys.stderr)
        return 1
    dirs = {"final": ROOT, **write_variants()}
    if args.parent:
        dirs["parent"] = args.parent.resolve()
    order = ["parent", "compaction", "no_recompute", "final"]
    order = [v for v in order if v in dirs]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tag in order + order[::-1]:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(dirs[tag]), str(ROOT)]))
        run = subprocess.run([sys.executable, __file__, "--measure", tag], cwd=ROOT, env=env,
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
