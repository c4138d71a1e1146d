#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`gaddpg_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build the four CUDA kernels (K1 FPS, K2 ball query, K3 eval SA
     gather+MLP, K4 eval group-all SA) from gaddpg_tpu_torch/ops/csrc;
  2. hold each kernel against its plain PyTorch version on the card at
     the serving shapes, batches 8 and 256: indices exactly equal, floats
     within rtol = atol = 1e-4 (fp32, different summation order);
  3. drive the serving path, `make_select_action` on a full-width agent
     state from a seeded generator, at batch 1, 8 and 1024, with the
     launch counters set to 0 just before and read just after (each call
     must launch K1 2x, K2 2x, K3 2x, K4 1x), and hold its actions and
     aux predictions against the same state run on the CPU (1e-3, after
     the FPS / ball-query indices, which must be equal);
  4. drive `PolicyRunner` on synthetic depth frames through APPROACH ->
     RETRACT -> DONE;
  5. time each kernel and its plain version at the serving shapes
     (CUDA events, median), select_action per batch (host clock) and its
     device busy time and top device activities (torch.profiler).
     Phase 4 reports the runner's per-request latency.

Prints the card's name and power limit (nvidia-smi), then one JSON line
with every kernel's numbers (launches: over the phase-3 calls; ms,
plain_ms, bound_ms: summed over the kernel's levels in one forward at
B=1024), then as the last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA card is available or any phase fails.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# outside the tensor cores, the units these kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

SA_LEVELS = (  # (name, npoint, radius, nsample) of the grouped levels
    ("SA1", 32, 0.02, 64),
    ("SA2", 32, 0.04, 128),
)
REPLACES = {
    "fps": "gaddpg_tpu/ops/pallas_kernels.py:97",
    "ball_query": "gaddpg_tpu/ops/pallas_kernels.py:166",
    "sa_gather_mlp": "gaddpg_tpu/ops/pallas_sa.py:120",
    "mlp_maxpool": "gaddpg_tpu/ops/pallas_sa.py:147",
}
PER_CALL = {"fps": 2, "ball_query": 2, "sa_gather_mlp": 2, "mlp_maxpool": 1}
CHECK_BATCHES = (8, 256)      # kernels against their plain versions
MAIN_BATCHES = (1, 8, 1024)   # one robot, entry(), bench.py's env count
TIME_BATCHES = (1, 1024)      # kernel timings; the JSON line sums the last


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synthetic_point_state(batch, gen, hand_points, device):
    """(B, 4, 1030) point states: 6 flagged hand anchors, then 1024
    points on the surface of a random ellipsoid 10-20 cm ahead."""
    n = 1024
    dirs = torch.randn((batch, n, 3), generator=gen, device=device)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    radii = 0.02 + 0.04 * torch.rand((batch, 1, 3), generator=gen, device=device)
    centre = torch.rand((batch, 1, 3), generator=gen, device=device) * 0.04 - 0.02
    centre[..., 2] += 0.15
    pts = dirs * radii + centre
    ps = torch.zeros((batch, 4, 6 + n), device=device)
    ps[:, :3, :6] = torch.as_tensor(hand_points, device=device)
    ps[:, 3, :6] = 1.0
    ps[:, :3, 6:] = pts.transpose(1, 2)
    return ps


def cuda_ms(fn, reps=10, rounds=7):
    """Median over `rounds` of the mean device time of `reps` calls.

    A spin kernel queued ahead of each round keeps the card busy for
    longer than the host takes to enqueue the calls, so the calls run
    back to back and the host's launch overhead is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(min(2.0 * host_s * 2e9, 4e9))  # twice the enqueue time at <= 2 GHz
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn, calls=5, top=6):
    """(device busy ms per call, [(name, ms per call), ...] of the `top`
    device activities by time) of `fn` under torch.profiler. Busy is the
    sum over device-side events (kernels, copies), each counted once; the
    CPU ops that launched them are left out, since they would count the
    same time again. 0 when the profiler saw no device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return sum(ms for _, ms in rows), rows[:top]


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Smoke:
    def __init__(self):
        from gaddpg_tpu_torch.agents import AgentConfig, create_agent_state
        from gaddpg_tpu_torch.geometry.gripper import HAND_FINGER_POINTS
        from gaddpg_tpu_torch.ops import build, sa, sampling

        self.build, self.sa, self.sampling = build, sa, sampling
        self.hand_points = HAND_FINGER_POINTS
        self.wrappers = {
            "fps": sampling.furthest_point_sampling,
            "ball_query": sampling.ball_query,
            "sa_gather_mlp": sa.sa_gather_mlp,
            "mlp_maxpool": sa.mlp_maxpool,
        }
        self.cfg = AgentConfig()
        # the entry points at their default device="cuda", as a user calls them
        self.state = create_agent_state(self.cfg, generator=torch.Generator().manual_seed(0))
        self.device = self.state.device
        self.errors = {k: 0.0 for k in self.wrappers}
        self.launches = {}

    def counts(self):
        return {k: w.launches for k, w in self.wrappers.items()}

    def reset_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    # -- the serving shapes, level by level ---------------------------------
    def level_inputs(self, point_state):
        """Per-kernel inputs of one policy-encoder forward, computed with
        the plain versions: {kernel: [(label, args), ...]}."""
        sampling, sa = self.sampling, self.sa
        enc = self.state.feat.encoder
        pc = point_state[:, :4, 6:].transpose(1, 2)
        xyz, feats = pc[..., :3].contiguous(), pc
        calls = {k: [] for k in self.wrappers}
        for (name, npoint, radius, nsample), level in zip(SA_LEVELS, enc.sa):
            weights = sa.folded_sa_weights(level.dense, level.norms)
            calls["fps"].append((name, (xyz, npoint)))
            centers = sampling.fps_reference(xyz, npoint)
            new_xyz = sampling.gather_points(xyz, centers)
            calls["ball_query"].append((name, (new_xyz, xyz, radius, nsample)))
            idx = sampling.ball_query_reference(new_xyz, xyz, radius, nsample)
            full = torch.cat([xyz, feats], dim=-1)
            cpad = torch.nn.functional.pad(new_xyz, (0, full.shape[-1] - 3))
            calls["sa_gather_mlp"].append((name, (idx, full, cpad, weights)))
            xyz, feats = new_xyz, sa.sa_gather_mlp_reference(idx, full, cpad, weights)
        weights = sa.folded_sa_weights(enc.sa[2].dense, enc.sa[2].norms)
        calls["mlp_maxpool"].append(("SA3", (torch.cat([xyz, feats], dim=-1), weights)))
        return calls

    def reference(self, kernel):
        return {
            "fps": self.sampling.fps_reference,
            "ball_query": self.sampling.ball_query_reference,
            "sa_gather_mlp": self.sa.sa_gather_mlp_reference,
            "mlp_maxpool": self.sa.mlp_maxpool_reference,
        }[kernel]

    # -- phase 2 --------------------------------------------------------------
    def check_kernels(self, gen):
        for batch in CHECK_BATCHES:
            ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
            for kernel, calls in self.level_inputs(ps).items():
                for label, args in calls:
                    got = self.wrappers[kernel](*args)
                    torch.cuda.synchronize()
                    want = self.reference(kernel)(*args)
                    torch.cuda.synchronize()
                    if got.dtype == torch.int32:
                        if not torch.equal(got, want):
                            bad = (got != want).sum().item()
                            raise AssertionError(
                                f"{kernel} {label} B={batch}: {bad} indices differ"
                            )
                        err = 0.0
                    else:
                        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
                        err = (got - want).abs().max().item()
                    self.errors[kernel] = max(self.errors[kernel], err)
                    log(f"[check] {kernel:13s} {label} B={batch:4d} "
                        f"shape={tuple(got.shape)} max_abs_err={err:.3e} ok")

    # -- phase 3 --------------------------------------------------------------
    def main_path(self, gen):
        from gaddpg_tpu_torch.agents import make_select_action
        from gaddpg_tpu_torch.ops import sampling

        select = make_select_action(self.cfg)
        select_cpu = make_select_action(self.cfg, device="cpu")
        state_cpu = self.state.to("cpu")
        inputs = {}
        for batch in MAIN_BATCHES:
            ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
            remain = torch.full((batch,), 10.0, device=self.device)
            inputs[batch] = (ps, remain)
        outs = {}
        per_call = []
        self.reset_counts()
        for batch, (ps, remain) in inputs.items():
            before = self.counts()
            outs[batch] = select(self.state, ps, remain)
            after = self.counts()
            per_call.append((batch, {k: after[k] - before[k] for k in after}))
        torch.cuda.synchronize()
        self.launches = self.counts()
        for batch, delta in per_call:
            log(f"[main] select_action B={batch}: launches {delta}")
            if delta != PER_CALL:
                raise AssertionError(f"B={batch}: launches {delta}, expected {PER_CALL}")

        for batch, (ps, remain) in inputs.items():
            xyz = ps[:, :3, 6:].transpose(1, 2).contiguous()
            xyz_cpu = xyz.cpu()
            idx = sampling.furthest_point_sampling(xyz, 32)
            idx_cpu = sampling.furthest_point_sampling(xyz_cpu, 32)
            if not torch.equal(idx.cpu(), idx_cpu):
                raise AssertionError(f"B={batch}: FPS indices differ card vs CPU")
            centers = sampling.gather_points(xyz, idx)
            bq = sampling.ball_query(centers, xyz, 0.02, 64)
            bq_cpu = sampling.ball_query(centers.cpu(), xyz_cpu, 0.02, 64)
            if not torch.equal(bq.cpu(), bq_cpu):
                raise AssertionError(f"B={batch}: ball-query indices differ card vs CPU")
            action, aux = outs[batch]
            action_cpu, aux_cpu = select_cpu(state_cpu, ps.cpu(), remain.cpu())
            for name, got, want in (("action", action, action_cpu), ("aux", aux, aux_cpu)):
                if got.shape != want.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"B={batch}: {name} shape/finite check failed")
                torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
            err = max((action.cpu() - action_cpu).abs().max().item(),
                      (aux.cpu() - aux_cpu).abs().max().item())
            log(f"[main] select_action B={batch}: indices equal, "
                f"card vs CPU max_abs_err={err:.3e} ok")
        return select, inputs

    # -- phase 4 --------------------------------------------------------------
    def runner(self):
        from gaddpg_tpu_torch.deploy.runner import Frame, PolicyRunner

        h, w = 480, 640
        rng = np.random.default_rng(0)
        depth = np.zeros((h, w), np.float32)
        depth[180:300, 260:380] = 0.35 + 0.01 * rng.random((120, 120), dtype=np.float32)
        hand = np.eye(4)
        hand[:3, 3] = (0.0, 0.0, 0.5)
        cam = hand.copy()
        frame = Frame(depth=depth, target_mask=depth > 0,
                      intrinsics=np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]]),
                      cam_to_world=cam, hand_to_world=hand)
        max_steps, retract_steps = 12, 3
        runner = PolicyRunner(self.state, self.cfg, max_steps=max_steps,
                              retract_steps=retract_steps, termination=False)
        self.reset_counts()
        phases, lat = [], []
        for _ in range(max_steps + retract_steps + 2):
            t0 = time.perf_counter()
            cmd = runner(frame)
            lat.append((time.perf_counter() - t0) * 1e3)
            phases.append(cmd.phase)
            if cmd.delta_pose.shape != (6,) or not np.isfinite(cmd.delta_pose).all():
                raise AssertionError(f"bad command {cmd}")
        expect = (["APPROACH"] * max_steps + ["RETRACT"] * (retract_steps + 1) + ["DONE"])
        if phases != expect:
            raise AssertionError(f"runner phases {phases}")
        counts = self.counts()
        if counts != {k: v * max_steps for k, v in PER_CALL.items()}:
            raise AssertionError(f"runner launches {counts}")
        approach = lat[1:max_steps]  # the first tick warms the builder
        log(f"[runner] phases {' '.join(phases)}")
        log(f"[runner] launches over {max_steps} APPROACH ticks: {counts}")
        log(f"[runner] APPROACH tick latency median {statistics.median(approach):.3f} ms "
            f"(min {min(approach):.3f}, max {max(approach):.3f}, n={len(approach)}), "
            f"480x640 depth frames")

    # -- phase 5 --------------------------------------------------------------
    def work(self, kernel, args):
        """(bytes, flops) the function needs on these inputs."""
        f32 = 4
        if kernel == "fps":
            xyz, npoint = args
            b, n, _ = xyz.shape
            return b * n * 3 * f32 + b * npoint * 4, 9 * b * n * (npoint - 1)
        if kernel == "ball_query":
            centers, xyz, radius, nsample = args
            b, s, _ = centers.shape
            n = xyz.shape[1]
            d2 = self.sampling._sq_dist(centers[:, :, None, :], xyz[:, None, :, :])
            hits = (d2 <= self.sampling._radius_sq(radius)).cumsum(dim=-1)
            reach = (hits >= nsample).int().argmax(dim=-1) + 1
            scanned = torch.where(hits[..., -1] >= nsample, reach, torch.full_like(reach, n))
            nbytes = (b * s * 3 + b * n * 3) * f32 + b * s * nsample * 4
            return nbytes, 9 * int(scanned.sum().item())
        if kernel == "sa_gather_mlp":
            idx, full, cpad, weights = args
            b, s, k = idx.shape
            wbytes = sum(w.numel() + bb.numel() for w, bb in weights) * f32
            macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
            c3 = weights[-1][0].shape[1]
            nbytes = idx.numel() * 4 + (full.numel() + cpad.numel() + b * s * c3) * f32 + wbytes
            return nbytes, 2 * b * s * k * macs
        full, weights = args
        b, n, _ = full.shape
        wbytes = sum(w.numel() + bb.numel() for w, bb in weights) * f32
        macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
        c3 = weights[-1][0].shape[1]
        return full.numel() * f32 + wbytes + b * c3 * f32, 2 * b * n * macs

    def timings(self, select, inputs, gen):
        totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0} for k in self.wrappers}
        for batch in TIME_BATCHES:
            ps = synthetic_point_state(batch, gen, self.hand_points, self.device)
            for kernel, calls in self.level_inputs(ps).items():
                for label, args in calls:
                    ms = cuda_ms(lambda: self.wrappers[kernel](*args))
                    plain = cuda_ms(lambda: self.reference(kernel)(*args), reps=3, rounds=5)
                    nbytes, flops = self.work(kernel, args)
                    bms, by = bound_ms(nbytes, flops)
                    log(f"[time] {kernel:13s} {label} B={batch:4d} kernel {ms:.4f} ms, "
                        f"plain {plain:.4f} ms, bound {bms:.6f} ms ({by}; "
                        f"{nbytes} B, {flops} FLOP)")
                    if batch == TIME_BATCHES[-1]:
                        t = totals[kernel]
                        t["ms"] += ms
                        t["plain_ms"] += plain
                        t["bytes"] += nbytes
                        t["flops"] += flops
        for batch, (ps, remain) in inputs.items():
            call = lambda: select(self.state, ps, remain)
            ms = host_ms(call, reps=20 if batch < 256 else 10)
            log(f"[time] select_action B={batch:4d}: {ms:.3f} ms per call (host clock, "
                f"synchronised), {ms / batch:.4f} ms per request")
            busy, top = device_profile(call)
            if busy == 0:
                log(f"[profile] select_action B={batch:4d}: device time not measured "
                    "(the profiler saw no device activity)")
                continue
            log(f"[profile] select_action B={batch:4d}: device busy {busy:.4f} ms per call, "
                f"idle share {max(0.0, 1 - busy / ms):.3f} of the host-clock call")
            for name, t in top:
                log(f"[profile]   {t:.4f} ms  {name[:100]}")
        return totals

    def kernel_line(self, totals):
        rows = []
        for kernel in self.wrappers:
            t = totals[kernel]
            bms, by = bound_ms(t["bytes"], t["flops"])
            rows.append({
                "name": kernel,
                "route": "cuda",
                "source": f"gaddpg_tpu_torch/ops/csrc/{kernel}.cu",
                "replaces": REPLACES[kernel],
                "launches": self.launches[kernel],
                "max_abs_err": self.errors[kernel],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": bms,
                "bound_by": by,
                "library_ms": None,
            })
        return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gaddpg_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the gaddpg_tpu_torch package is missing ({e})", file=sys.stderr)
        return 1
    try:
        log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        card = card_line()
        t0 = time.perf_counter()
        build.build_all()
        log(f"[build] {len(build.KERNELS)} kernels built and loaded in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, text in build.build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"[build] {name}: {line.strip()}")
        torch.manual_seed(0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.no_grad():  # serving only: no autograd graph anywhere
            smoke = Smoke()
            smoke.check_kernels(gen)
            select, inputs = smoke.main_path(gen)
            smoke.runner()
            totals = smoke.timings(select, inputs, gen)
            line = smoke.kernel_line(totals)
    except Exception:  # report which phase failed, then fail the run
        traceback.print_exc()
        return 1
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
