"""Grasp-pose (goal feature) training CLI (counterpart of
gaddpg_tpu/cli/train_goal.py).

Trains the `GoalFeature` encoder to predict grasps and a confidence from
object clouds, the analogue of the reference's grasp-evaluator training
data path (reference: misc/grasp_data_reader.py, train_goal_feature
config flag). Runs on the card unless --device cpu:

    python -m gaddpg_tpu_torch.cli.train_goal --steps 200 --batch 32 \
        --index ycb --log_dir output/goal0

Scalars go to <log_dir>/metrics.jsonl every 10 steps; the trained
module's state_dict to <log_dir>/goal_feature.pt.
"""

import argparse
import os
import time


def main(argv=None, lib=None):
    """Train; returns {"steps", "seconds", "metrics": [{"pm_loss",
    "bce_loss"} as floats per step], "path"}. `lib`, an ObjectLibrary,
    stands in for --index's (a library already built)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--index", default="ycb")
    p.add_argument("--log_dir", default="output/goal")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from gaddpg_tpu_torch.agents.optim import AdamW
    from gaddpg_tpu_torch.agents.state import goal_parameters, init_goal_
    from gaddpg_tpu_torch.data.grasp_dataset import (
        GraspDatasetGenerator, make_goal_feature_update,
    )
    from gaddpg_tpu_torch.envs.assets import library_from_index
    from gaddpg_tpu_torch.models import GoalFeature
    from gaddpg_tpu_torch.train.metrics import MetricLogger

    if lib is None:
        lib = library_from_index(args.index, "train")
    gen = GraspDatasetGenerator(lib, device=args.device)
    goal = init_goal_(GoalFeature(), torch.Generator().manual_seed(args.seed)).to(gen.device)
    # optax.adamw(lr, eps=1e-5, weight_decay=1e-5), as the JAX CLI trains
    opt = AdamW(goal_parameters(goal), args.lr, eps=1e-5, weight_decay=1e-5)
    update = make_goal_feature_update(goal, opt)
    draws = torch.Generator(device=gen.device).manual_seed(args.seed)

    logger = MetricLogger(args.log_dir)
    history = []
    t0 = time.time()
    for i in range(args.steps):
        batch = gen.sample(draws, batch=args.batch)
        m = {k: float(v) for k, v in update(batch).items()}
        history.append(m)
        if i % 10 == 0:
            logger.log(i, m)
            print(f"[{i}] pm={m['pm_loss']:.4f} bce={m['bce_loss']:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    seconds = time.time() - t0

    path = os.path.join(args.log_dir, "goal_feature.pt")
    torch.save({"goal": goal.state_dict(), "mu": opt.mu, "nu": opt.nu, "count": opt.count},
               path)
    print("saved", path)
    return {"steps": args.steps, "seconds": seconds, "metrics": history, "path": path}


if __name__ == "__main__":
    main()
