"""Both dry-run tiers of the data-parallel train iteration (counterpart of
`__graft_entry__.dryrun_multichip`, `_dryrun_impl` and
`_dryrun_flagship_impl`).

    python -m gaddpg_tpu_torch.parallel.dryrun --ranks 2 --device cpu
    python -m gaddpg_tpu_torch.parallel.dryrun --ranks 2 --ranks-per-card 2   # one card

Each tier starts its ranks through `parallel.launch` and runs one fused
iteration on tiny shapes: a collect over the sharded env batch, the
insert into the capacity-sharded ring, one sharded DDPG update. The
flagship tier runs the CHOMP planner, two dynamic clutter bodies and a
procedural library (built once here and handed to the ranks as a file);
the fast tier a box with the goal servo. Each checks that transitions
went in, that the ring is spread over the ranks, that the update's
metrics are finite with update_step 1, and that every rank's agent state
is rank 0's bit for bit. It prints DRYRUN_FLAGSHIP_OK ranks=N, then
DRYRUN_OK ranks=N, and exits non-zero if either tier failed (both run).
"""

import argparse
import dataclasses
import math
import os
import sys
import tempfile
import traceback

from gaddpg_tpu_torch.parallel.launch import launch, rank_devices

TIMEOUT_S = 1800.0


def tier_config(world: int, output_dir: str, flagship: bool = False):
    """The dry run's TrainConfig on `world` ranks: num_envs 2 n, batch n,
    a ring of 16 n; with `flagship`, the planner and two clutter bodies
    (`__graft_entry__.py:121-237`)."""
    from gaddpg_tpu_torch.envs.grasp_env import EnvParams
    from gaddpg_tpu_torch.physics.types import PhysicsParams
    from gaddpg_tpu_torch.render.camera import CameraParams
    from gaddpg_tpu_torch.train.config import load_config

    env_p = EnvParams(
        physics=PhysicsParams(substeps=10), camera=CameraParams(width=32, height=32),
        uniform_num_pts=58, pc_capacity=128, new_points_per_step=32,
        settle_substeps=20, max_steps=3, reset_tries=2, retract_lift_steps=2,
        **(dict(use_planner=True, num_clutter=2, clutter_points_per_step=16) if flagship
           else dict(use_planner=False)))
    overrides = {
        "num_envs": 2 * world, "max_steps": 3, "extend_steps": 1,
        "batch_size": world, "updates_per_iter": 1, "buffer_size": 16 * world,
        "fill_data_step": 0, "explore_ratio": 0.5, "explore_cap": 0.5,
        "output_dir": output_dir,
    }
    if flagship:
        overrides["num_clutter"] = 2
    cfg = load_config(overrides=overrides, policy="DDPG")
    return dataclasses.replace(cfg, env=env_p)


def tier_library(flagship: bool, library_path=None):
    """The fast tier's box, or the flagship tier's procedural library
    from its `save_library` file."""
    from gaddpg_tpu_torch.envs.assets import box_asset, load_library

    return load_library(library_path) if flagship else box_asset(0.06, 0.06, 0.14)


def build_flagship_library(path: str) -> str:
    """`build_proc_library(2, seed0=11)`, saved to `path` (.npz)."""
    from gaddpg_tpu_torch.data.procgen import build_proc_library
    from gaddpg_tpu_torch.envs.assets import save_library

    save_library(build_proc_library(2, seed0=11), path)
    return path


def check_replicated(mesh, state):
    """Raise unless every rank's agent state is rank 0's bit for bit."""
    from gaddpg_tpu_torch.agents.state import state_tensors
    from gaddpg_tpu_torch.parallel.mesh import replicate

    replicate(mesh, state_tensors(state), check=True)


def tier_iteration(tr, flagship: bool):
    """A tier's iteration on its Trainer `tr`: collect (again while nothing
    went in: tiny scenes are often invalid), update once, check. Returns
    (collect stats, update metrics)."""
    from gaddpg_tpu_torch.parallel.mesh import world_of

    roll = tr.collect()
    for _ in range(4 if flagship else 2):  # as __graft_entry__.py retries
        if roll["buffer_idx"] > 0:
            break
        roll = tr.collect()
    assert roll["buffer_idx"] > 0, "no transitions inserted"
    # the ring is physically spread: each rank holds its slots' points
    shard = tr.buffer.point_state
    assert shard.shape[0] == tr.cfg.buffer_size // world_of(tr.mesh)
    assert shard.device == tr.device
    stats = tr.train_iter()
    assert stats, "train_iter did not run an update"
    assert all(math.isfinite(v) for v in stats.values()), f"non-finite metrics: {stats}"
    assert tr.update_step == 1
    check_replicated(tr.mesh, tr.agent_state)
    return roll, stats


def run_tier(mesh, flagship: bool, output_dir: str, library_path=None):
    """One rank's tier -> (collect stats, update metrics)."""
    from gaddpg_tpu_torch.train.loop import Trainer

    cfg = tier_config(mesh.world, output_dir, flagship)
    tr = Trainer(cfg, lib=tier_library(flagship, library_path), mesh=mesh)
    return tier_iteration(tr, flagship)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--ranks-per-card", type=int, default=1,
                   help="ranks sharing each card (gloo, staged through the host)")
    p.add_argument("--timeout", type=float, default=TIMEOUT_S, help="seconds a tier")
    args = p.parse_args(argv)
    devices = rank_devices(args.ranks, args.device, args.ranks_per_card)
    work = tempfile.mkdtemp(prefix="gaddpg_dryrun_")
    failed = []
    for name, flagship in (("FLAGSHIP", True), ("", False)):
        tag = f"DRYRUN_{name}_" if name else "DRYRUN_"
        try:
            lib = (build_flagship_library(os.path.join(work, "flagship_lib.npz"))
                   if flagship else None)
            out = os.path.join(work, name.lower() or "fast")
            launch(run_tier, args.ranks, args=(flagship, out, lib), devices=devices,
                   rendezvous_dir=work, timeout_s=args.timeout)
            print(f"{tag}OK ranks={args.ranks}", flush=True)
        except Exception:  # noqa: BLE001 -- reported, and the exit code says it
            traceback.print_exc()
            print(f"{tag}FAILED ranks={args.ranks}", flush=True)
            failed.append(name or "FAST")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
