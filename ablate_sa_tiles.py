#!/usr/bin/env python3
"""Step-by-step ablation of the port's redesigned kernels on one CUDA card:
what each step of a redesign buys, each package timed in its own process,
in turns.

    python3 ablate_sa_tiles.py [--parent DIR] [--variants NAME,...] [--no-k7]
    python3 ablate_sa_tiles.py --k2-layouts

Writes variants of `gaddpg_tpu_torch` under build/ablate/ (copies of the
package with one piece of a kernel swapped), then times each package in
the order given, then in the reverse order. Variants (default: parent,
final):

  parent       the package in DIR (an unpacked earlier commit), if given;
  k7_smem      K7 with the hand trajectory staged in shared memory, one
               warp per env, IEEE division and square root;
  k7_warps     and four warps per env (one per contact body, at most 64
               registers a thread);
  k2_no_rows   this checkout's K2 with no rows built or written,
  k2_no_masks  with no hit masks made (clouds of several chunks), or
  k2_one_op    with one rounded operation a pair in the masks, not
               eight: what each phase costs (wrong indices; K1 and K2
               alone are timed);
  k6_regload   this checkout with K6's layer engine loading its rows
               through registers, four rows at a time (36 loads in flight
               a lane), instead of by cp.async;
  final        this checkout: K7 with one warp per env, the trajectory in
               shared memory, division and square root without the IEEE
               slow path (csrc/contact_scan.cu `fdiv`, `fsqrt`); K4 on
               wgmma in 3xTF32; K6 one layer-engine launch per layer on
               wgmma (csrc/groupall_layer.cu); K1 one warp per cloud;
               K2 a block per cloud with hit masks and a prefix count
               (csrc/ball_query.cu);
  k7_w2m1      the final K7 with two warps per env (128 registers);
  k7_w4m1      the final K7 with four warps per env (64 registers);
  k7_math2     the final K7 with the approximate division and square
               root alone (2 ulp).

Each process prints one JSON line: K1 and K2 per level at B = 1, 8, 256
and 1024, K3 per level at B=1024 and K5 and K6 per policy level at B=256 on
chip_smoke.py's synthetic clouds, K4 at B = 1, 256 and 1024 on the
serving shapes' SA3 input, K7 at (B, n) = (1024, 75),
(64, 75) and (1024, 200) on live rollout states (CUDA events,
chip_smoke.cuda_ms; the largest difference from the plain version beside
each; for K7 also the envs off the JAX bounds, whether each is chaotic,
their largest departures and those of one one-ulp nudge of the plain
version, the largest ratio of the two rank by rank (chip_smoke.py's K7
rule beyond 60 substeps), and a digest of the output, equal between
variants that give the same bits), select_action at B = 1 and 1024,
the DDPG and BC updates at B=256 x 1030 (median of 3 after a warm-up)
with the DDPG update's peak memory, and reset and retract_batched at
B=1024 (median of 3 after a warm-up; host clock); with --quick K4 and K7
alone, with --no-k7 no K7 and no env call. With --k2-layouts one process
times this checkout's K2 alone (`measure_k2_layouts`). Needs a card; the
variants build their kernels into their own build/ directories.

The K7 variants are this checkout's csrc/contact_scan.cu with its
division and square root swapped (K7_IEEE_MATH, K7_APPROX_MATH) or its
bodies split over several warps per env (`k7_env_warps`: each warp holds
kBodies / W of a sphere's contacts, a per-env sum adds the warps'
butterflies in warp order through shared memory behind a named barrier
of the env's threads, in two alternating slots, and every warp runs the
per-env tail).
"""

import argparse
import hashlib
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ablate"
DEFAULT_VARIANTS = ("parent", "final")
# --k2-layouts: K2 per level at these batches with each number of a
# cloud's centres a block forced, beside the wrapper's choice
K2_LAYOUT_BATCHES = (1, 8, 32, 256, 1024)
K2_LAYOUT_CENTRES = (1, 2, 4, 8, 16, 32)
K7_SHAPES = ((1024, 75), (64, 75), (1024, 200))

def _replace(path, old, new):
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{path}: the text to swap is not there once")
    path.write_text(text.replace(old, new))


# K7's division and square root (csrc/contact_scan.cu `fdiv`, `fsqrt`):
# the shipped ones, IEEE-rounded ones, and the approximation alone
K7_NEWTON_MATH = """__device__ __forceinline__ float fdiv(float a, float b) {
  const float r = rcp_approx(b);
  const float q = a * r;
  return fmaf(fmaf(-b, q, a), r, q);
}
__device__ __forceinline__ float fsqrt(float x) {
  const float y = rsqrt_approx(x);
  const float s = x * y;
  return x > 0.0f ? fmaf(fmaf(-s, s, x), 0.5f * y, s) : x;  // sqrt(0) = 0 (rsqrt gives inf)
}"""
K7_IEEE_MATH = """__device__ __forceinline__ float fdiv(float a, float b) { return a / b; }
__device__ __forceinline__ float fsqrt(float x) { return sqrtf(x); }"""
K7_APPROX_MATH = """__device__ __forceinline__ float fdiv(float a, float b) { return a * rcp_approx(b); }
__device__ __forceinline__ float fsqrt(float x) {
  const float s = x * rsqrt_approx(x);
  return x > 0.0f ? s : x;
}"""

# the per-env sum of several warps per env, and the threads of an env
K7_ENV_GROUP = """// The threads of one env: its warps, their barrier and the slots of its
// per-env sums.
struct EnvGroup {
  int warp;      // warp of the env, 0 .. kWarpsPerEnv - 1
  int lane;
  int bar;       // named barrier of the env's threads
  float* slots;  // [2][kWarpsPerEnv][kMaxSum] partials in shared memory
  int slot;      // the slot the next sum writes

  __device__ __forceinline__ void sync() const {
    if (kEnvsPerBlock == 1) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\\n" ::"r"(bar), "n"(32 * kWarpsPerEnv) : "memory");
    }
  }

  // Sums of N per-thread values over the env, every thread of the env
  // holding the same bits: butterfly in each warp, then the warps'
  // partials added in warp order.
  template <int N>
  __device__ __forceinline__ void sum(float (&v)[N]) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(gaddpg::kFullMask, v[i], off);
    }
    float* s = slots + slot * kWarpsPerEnv * kMaxSum;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[warp * kMaxSum + i] = v[i];
    }
    sync();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = s[i];
#pragma unroll
      for (int w = 1; w < kWarpsPerEnv; ++w) acc += s[w * kMaxSum + i];
      v[i] = acc;
    }
    slot ^= 1;
  }
};

"""


def k7_env_warps(text, warps):
    """contact_scan.cu's text with `warps` warps per env."""
    swaps = [
        ("constexpr int kEnvsPerBlock = 4;  // one warp each\n"
         "constexpr int kThreads = 32 * kEnvsPerBlock;\n",
         f"constexpr int kWarpsPerEnv = {warps};\n"
         "constexpr int kThreads = 128;\n"
         "constexpr int kEnvsPerBlock = kThreads / (32 * kWarpsPerEnv);\n"
         "constexpr int kPerThread = kBodies / kWarpsPerEnv;  // contacts a thread holds\n"
         "constexpr int kMaxSum = 6;  // widest per-env sum\n"),
        ("__launch_bounds__(kThreads, 1)", f"__launch_bounds__(kThreads, {2 * warps})"),
        ("  extern __shared__ float traj_smem[];  // [kEnvsPerBlock][n][kHand]\n"
         "  const int in_block = threadIdx.x >> 5;\n",
         "  extern __shared__ float traj_smem[];  // [kEnvsPerBlock][n][kHand]\n"
         "  __shared__ float sum_slots[kEnvsPerBlock][2][kWarpsPerEnv][kMaxSum];\n"
         "  const int in_block = threadIdx.x / (32 * kWarpsPerEnv);\n"),
        ("  const int lane = threadIdx.x & 31;\n",
         "  EnvGroup grp{static_cast<int>(threadIdx.x >> 5) % kWarpsPerEnv,\n"
         "               static_cast<int>(threadIdx.x & 31), 1 + in_block,\n"
         "               &sum_slots[in_block][0][0][0], 0};\n"
         "  const int lane = grp.lane;\n"),
        ("for (int e = lane; e < n * kHand; e += 32)",
         "for (int e = grp.warp * 32 + lane; e < n * kHand; e += 32 * kWarpsPerEnv)"),
        ("fncl[i] = fn_clamp[env * kBodies * kNS + i * kNS + lane]",
         "fncl[i] = fn_clamp[env * kBodies * kNS + (grp.warp * kPerThread + i) * kNS + lane]"),
        ("  __syncwarp();\n", "  grp.sync();\n"),
        ("  if (lane < 16) {", "  if (grp.warp == 0 && lane < 16) {"),
    ]
    for old, new in swaps:
        if text.count(old) != 1:
            raise RuntimeError(f"contact_scan.cu: {old!r} is not there once")
        text = text.replace(old, new)
    head = text.index("// Sums of N per-lane values over the warp")
    text = text[:head] + K7_ENV_GROUP + text[text.index("__device__ __forceinline__ void cp_async4"):]
    # a thread's contacts: bodies warp * kPerThread + i
    text = text.replace("warp_sum(", "grp.sum(").replace("[kBodies]", "[kPerThread]")
    text = text.replace("i < kBodies; ++i", "i < kPerThread; ++i")
    return re.sub(r"\bi ([=!]=) (\d)\b", r"(grp.warp * kPerThread + i) \1 \2", text)


# K6's row load through registers (csrc/groupall_layer.cu `load_chunk`)
K6_REGLOAD = r"""constexpr int kLaneCols = (kChunk + 31) / 32;  // columns of a chunk row a lane loads
constexpr int kLoadRows = 4;  // rows a warp loads at a time

__device__ __forceinline__ void load_chunk(const LayerArgs& p, int row0, int k0, int kw,
                                           float* dst, int lane) {
  for (int r0 = 0; r0 < 16; r0 += kLoadRows) {
    float v[kLoadRows][kLaneCols];
#pragma unroll
    for (int r = 0; r < kLoadRows; ++r) {
      const bool row_in = row0 + r0 + r < p.rows;
      const float* src = p.x + static_cast<size_t>(row0 + r0 + r) * p.cin;
#pragma unroll
      for (int u = 0; u < kLaneCols; ++u) {
        const int j = lane + 32 * u, k = k0 + j;
        v[r][u] = 0.0f;
        if (row_in && j < kw && k < p.cin) {
          const float x = __ldg(src + k);
          v[r][u] = !p.relu          ? x
                    : p.a == nullptr ? fmaxf(x, 0.0f)
                                     : fmaxf(__fadd_rn(__fmul_rn(x, __ldg(p.a + k)),
                                                       __ldg(p.c + k)), 0.0f);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kLoadRows; ++r) {
#pragma unroll
      for (int u = 0; u < kLaneCols; ++u) {
        const int j = lane + 32 * u;
        if (j < kw) dst[(r0 + r) * kActStride + j] = v[r][u];
      }
    }
  }
}

"""

# K2's phases, each taken out in turn (csrc/ball_query.cu), to time what
# each costs: the variants' indices are wrong on purpose
K2_VARIANTS = {
    # no rows: no warp builds or writes a row
    "k2_no_rows": ("  for (int r0 = 2 * warp; r0 < nc; r0 += 2 * kWarps) {",
                   "  for (int r0 = 2 * warp; r0 < 0; r0 += 2 * kWarps) {"),
    # no masks: the mask units of clouds of several chunks are skipped
    "k2_no_masks": ("      for (int u = warp; u < nchunks * cgroups; u += kWarps) {",
                    "      for (int u = warp; u < 0; u += kWarps) {"),
    # one rounded operation a (centre, point) pair in the masks, not eight
    "k2_one_op": ("            if (gaddpg::sq_dist(cc.x, cc.y, cc.z, q.x, q.y, q.z) <= r2) word |= 1u << p;\n"
                  "          }\n        } else {",
                  "            if (__fsub_rn(cc.x, q.x) <= r2) word |= 1u << p;\n"
                  "          }\n        } else {"),
}

# (warps per env, division and square root) of each K7 variant
K7_VARIANTS = {
    "k7_smem": (1, K7_IEEE_MATH),
    "k7_warps": (4, K7_IEEE_MATH),
    "k7_math2": (1, K7_APPROX_MATH),
    "k7_w2m1": (2, K7_NEWTON_MATH),
    "k7_w4m1": (4, K7_NEWTON_MATH),
}


def _copy_package(name):
    pkg = OUT / name / "gaddpg_tpu_torch"
    shutil.copytree(ROOT / "gaddpg_tpu_torch", pkg, ignore=shutil.ignore_patterns("__pycache__"))
    return pkg


def write_variants(names):
    """build/ablate/<name>/gaddpg_tpu_torch for each variant in `names`."""
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {}
    for name, (warps, math) in K7_VARIANTS.items():
        if name in names:
            pkg = _copy_package(name)
            src = pkg / "ops" / "csrc" / "contact_scan.cu"
            _replace(src, K7_NEWTON_MATH, math)
            if warps > 1:
                src.write_text(k7_env_warps(src.read_text(), warps))
            dirs[name] = pkg.parent
    for name, (old, new) in K2_VARIANTS.items():
        if name in names:
            pkg = _copy_package(name)
            _replace(pkg / "ops" / "csrc" / "ball_query.cu", old, new)
            dirs[name] = pkg.parent
    if "k6_regload" in names:
        pkg = _copy_package("k6_regload")
        src = pkg / "ops" / "csrc" / "groupall_layer.cu"
        text = src.read_text()
        start = text.index("// 4 bytes from global to shared memory by cp.async")
        end = text.index("__global__ void __launch_bounds__(kThreads, 1) groupall_layer_kernel(")
        src.write_text(text[:start] + K6_REGLOAD + text[end:])
        dirs["k6_regload"] = pkg.parent
    return dirs


def _distinct(idx):
    """Share of the slots that are distinct (ops/sa.py `distinct_slots`),
    counted here so that an earlier package without it can be timed."""
    kept = (idx[..., 1:] != idx[..., :1]).sum() + idx[..., 0].numel()
    return kept.item() / idx.numel()


def measure(tag, quick=False, k7=True):
    """One package's numbers (the one first on sys.path) as a dict; with
    `quick` K4 and K7 alone, without `k7` no K7 and no env call."""
    import torch

    import chip_smoke as cs
    import gaddpg_tpu_torch
    from gaddpg_tpu_torch.agents import make_bc_update, make_ddpg_update, make_select_action

    torch.manual_seed(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"variant": tag, "package": str(Path(gaddpg_tpu_torch.__file__).parent)}
    with torch.no_grad():
        sm = cs.Smoke()
        if quick:
            measure_k4_k7(sm, gen, out, env_calls=False)
            return out
        for batch in (1, 8, 256, 1024):
            fps_ps = cs.synthetic_point_state(batch, gen, sm.hand_points, sm.device)
            calls = sm.level_inputs(fps_ps)
            for label, args in calls["fps"]:
                same = torch.equal(sm.sampling.furthest_point_sampling(*args),
                                   sm.sampling.fps_reference(*args))
                out[f"K1 {label} B={batch}"] = {
                    "ms": cs.cuda_ms(lambda: sm.sampling.furthest_point_sampling(*args)),
                    "indices_equal": same}
            for label, args in calls["ball_query"]:
                same = torch.equal(sm.sampling.ball_query(*args),
                                   sm.sampling.ball_query_reference(*args))
                out[f"K2 {label} B={batch}"] = {
                    "ms": cs.cuda_ms(lambda: sm.sampling.ball_query(*args)),
                    "indices_equal": same}
        if tag in K2_VARIANTS:  # wrong indices: nothing downstream is timed
            return out
        ps = cs.synthetic_point_state(1024, gen, sm.hand_points, sm.device)
        for label, args in sm.level_inputs(ps)["sa_gather_mlp"]:
            err = (sm.sa.sa_gather_mlp(*args) - sm.sa.sa_gather_mlp_reference(*args)).abs().max()
            out[f"K3 {label} B=1024"] = {
                "ms": cs.cuda_ms(lambda: sm.sa.sa_gather_mlp(*args)),
                "distinct": _distinct(args[0]),
                "max_abs_err": err.item()}
        for label, kernel, args in sm.train_calls(256, gen):
            if kernel == "sa_train" and label.startswith("policy"):
                got = sm.sa_train.sa_train_fused(*args)[0]
                err = (got - sm.sa_train.sa_train_reference(*args)[0]).abs().max()
                out[f"K5 {label} B=256"] = {
                    "ms": cs.cuda_ms(lambda: sm.sa_train.sa_train_fused(*args), reps=5, rounds=5),
                    "distinct": _distinct(args[0]),
                    "max_abs_err": err.item()}
            elif kernel == "groupall_train" and label.startswith("policy"):
                got, stats = sm.sa_train.groupall_train_fused(*args)
                want, want_stats = sm.sa_train.groupall_train_reference(*args)
                err = max((a - b).abs().max().item() for a, b in
                          zip((got, *(t for mv in stats for t in mv)),
                              (want, *(t for mv in want_stats for t in mv))))
                out[f"K6 {label} B=256"] = {
                    "ms": cs.cuda_ms(lambda: sm.sa_train.groupall_train_fused(*args),
                                     reps=5, rounds=5),
                    "max_abs_err": err}
        select = make_select_action(sm.cfg)
        for batch in (1, 1024):
            sel_ps = ps[:batch]
            remain = torch.full((batch,), 10.0, device=sm.device)
            out[f"select_action B={batch} ms"] = cs.host_ms(
                lambda: select(sm.state, sel_ps, remain), reps=10)
    batch = sm.learner_batch(cs.TRAIN_BATCH, gen)
    torch.cuda.reset_peak_memory_stats()
    for name, update in (("ddpg", make_ddpg_update(sm.cfg)), ("bc", make_bc_update(sm.cfg))):
        times = []
        for i in range(1 + cs.TIMED_UPDATES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "ddpg":
                update(sm.train_state, batch, gen)
            else:
                update(sm.train_state, batch)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[f"{name} update ms"] = statistics.median(times)
        if name == "ddpg":
            out["ddpg peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        measure_k4_k7(sm, gen, out, k7=k7)
    return out


def measure_k4_k7(sm, gen, out, env_calls=True, k7=True):
    """K4 at B = 1, 256, 1024, and with `k7` K7 at K7_SHAPES and, with
    `env_calls`, the env's reset and retract at B=1024 into `out`."""
    import torch

    import chip_smoke as cs
    from gaddpg_tpu_torch.envs.assets import library_from_index
    from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv

    for batch in (1, 256, 1024):
        ps = cs.synthetic_point_state(batch, gen, sm.hand_points, sm.device)
        (_, args), = sm.level_inputs(ps)["mlp_maxpool"]
        err = (sm.sa.mlp_maxpool(*args) - sm.sa.mlp_maxpool_reference(*args)).abs().max()
        out[f"K4 B={batch}"] = {"ms": cs.cuda_ms(lambda: sm.sa.mlp_maxpool(*args)),
                                "max_abs_err": err.item()}
    if not k7:
        return
    env = PandaGraspEnv(EnvParams(use_planner=False), library_from_index("ycb", "train"))
    env_gen = torch.Generator(device="cuda").manual_seed(7)
    live = sm.rollout_states(env, env_gen)
    for batch, n in K7_SHAPES:
        p, args = sm.scan_args(cs.map_state(live[0], slice(0, batch)),
                               *(t[:batch] for t in live[1:]), n)
        out[f"K7 B={batch} n={n}"] = {
            "ms": cs.cuda_ms(lambda: sm.cs.contact_scan(p, n, *args), reps=5, rounds=5),
            **k7_reading(sm, p, n, args)}
    if not env_calls:
        return
    state, _ = env.reset(cs.ENV_BATCH, env_gen)
    for _ in range(8):
        state = env.step_batched(state, env.expert_action(state), env_gen)[0]
    out["reset B=1024 ms"] = cs.host_ms(lambda: env.reset(cs.ENV_BATCH, env_gen), reps=3)
    out["retract B=1024 ms"] = cs.host_ms(lambda: env.retract_batched(state), reps=3)


def k7_reading(sm, p, n, args):
    """K7 against its plain version on one batch: the largest position
    difference, the envs off the JAX bounds, whether each is chaotic (32
    one-ulp nudges move the plain version past the bounds), their largest
    departures in units of the bounds beside those of one one-ulp nudge
    of the plain version, the largest ratio of the two rank by rank
    (chip_smoke.py's K7 rule beyond 60 substeps), and a digest of the
    output (equal digests: the variant's rollout and scan gave the same
    bits)."""
    import torch

    import chip_smoke as cs

    got = sm.cs.contact_scan(p, n, *args)
    want = sm.cs.contact_scan_reference(p, n, *args)
    tol = torch.zeros(16, device=got.device)
    for sl, bound in cs.K7_BOUNDS.values():
        tol[sl] = bound
    r = ((got[:, :15] - want[:, :15]).abs() / tol[:15]).amax(dim=1)
    off = ((r > 1) | (got[:, 15] != want[:, 15])).nonzero()[:, 0]
    nudge_r, nudge_off = sm.nudged_departure(p, n, args, want, tol)
    ranked = r[off].sort(descending=True).values
    chaotic = True
    if len(off):
        spread = sm.chaotic_spread(p, n, args, off, want)
        chaotic = bool(((spread[:, :15] / tol[:15]).amax(dim=1) > 1).all())
    return {
        "max_abs_err_pos": (got - want)[:, :3].abs().max().item(),
        "envs_off_bounds": len(off),
        "nudge_envs_off": nudge_off,
        "off_all_chaotic": chaotic,
        "off_top5": [round(v, 1) for v in ranked[:5].tolist()],
        "nudge_top5": [round(v, 1) for v in nudge_r[:5].tolist()],
        "rank_ratio_max": (ranked / nudge_r[:len(off)].clamp(min=1e-30)).max().item()
                          if len(off) else 0.0,
        "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}


def measure_k2_layouts():
    """This checkout's K2 per level at each of K2_LAYOUT_BATCHES on
    chip_smoke.py's synthetic clouds, launched with each of
    K2_LAYOUT_CENTRES centres a block (indices checked against
    ball_query_reference), beside the centres `ball_query_layout` picks."""
    import torch

    import chip_smoke as cs
    from gaddpg_tpu_torch.ops import build, sampling

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = sampling.sm_count(torch.cuda.current_device())
    out = {"variant": "k2_layouts", "sms": sms}
    with torch.no_grad():
        sm = cs.Smoke()
        for batch in K2_LAYOUT_BATCHES:
            ps = cs.synthetic_point_state(batch, gen, sm.hand_points, sm.device)
            for label, (centres, xyz, radius, nsample) in sm.level_inputs(ps)["ball_query"]:
                b, s, n = centres.shape[0], centres.shape[1], xyz.shape[1]
                want = sampling.ball_query_reference(centres, xyz, radius, nsample)
                row = {"wrapper": sampling.ball_query_layout(b, s, n, nsample, sms)[0]}
                for per in K2_LAYOUT_CENTRES:
                    got = torch.empty_like(want)
                    launch = lambda: build.launch(
                        "ball_query", xyz.device, centres.data_ptr(), xyz.data_ptr(), b, s, n,
                        sampling._radius_sq(radius), nsample, per, got.data_ptr())
                    launch()
                    if not torch.equal(got, want):
                        raise AssertionError(f"K2 {label} B={batch}, {per} centres a block")
                    row[str(per)] = cs.cuda_ms(launch)
                out[f"K2 {label} B={batch}"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="an unpacked earlier commit to time first")
    ap.add_argument("--variants", default=",".join(DEFAULT_VARIANTS),
                    help="comma-separated variants, in the order to time them")
    ap.add_argument("--quick", action="store_true", help="time K4 and K7 alone")
    ap.add_argument("--no-k7", action="store_true", help="time no K7 and no env call")
    ap.add_argument("--k2-layouts", action="store_true",
                    help="time this checkout's K2 with each number of centres a block alone")
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # one variant, in a child process
    args = ap.parse_args()
    if args.measure:
        if Path(sys.path[0]).resolve() == ROOT:  # the package comes from PYTHONPATH
            sys.path.pop(0)
        # this checkout's chip_smoke.py for every package, not one unpacked
        # beside an earlier package
        spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
        sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["chip_smoke"])
        print(json.dumps(measure(args.measure, args.quick, not args.no_k7)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ablate_sa_tiles: no CUDA device available", file=sys.stderr)
        return 1
    if args.k2_layouts:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        print(json.dumps(measure_k2_layouts()), flush=True)
        return 0
    names = args.variants.split(",")
    dirs = {"final": ROOT, **write_variants(names)}
    if args.parent:
        dirs["parent"] = args.parent.resolve()
    order = [v for v in names if v in dirs]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tag in order + order[::-1]:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(dirs[tag]), str(ROOT)]))
        run = subprocess.run([sys.executable, __file__, "--measure", tag]
                             + ["--quick"] * args.quick + ["--no-k7"] * args.no_k7,
                             cwd=ROOT, env=env,
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
