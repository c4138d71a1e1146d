"""Online training CLI (counterpart of gaddpg_tpu/cli/train_online.py).

Usage (experiments/scripts/train_online.sh's command; the card unless
--device cpu):

    python -m gaddpg_tpu_torch.cli.train_online \
        --config_file experiments/cfgs/td3_critic_aux_policy_aux.yaml \
        --policy DDPG --log_dir output/run0 [--num_envs 1024] [--max_iters N]

Writes <log_dir>/config.json, metrics.jsonl (every log_interval
iterations and the last one) and agent_latest.pt.
"""

import argparse
import dataclasses
import json
import os
import time


def create_parser():
    p = argparse.ArgumentParser(description="GA-DDPG online training (PyTorch port)")
    p.add_argument("--policy", default="DDPG", choices=["DDPG", "BC"])
    p.add_argument("--config_file", default=None)
    p.add_argument("--log_dir", default="output/run")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--pretrained", default=None,
                   help="directory with an agent_latest.pt (or a JAX run's .msgpack) to resume")
    p.add_argument("--save_buffer", action="store_true")
    p.add_argument("--max_iters", type=int, default=None)
    p.add_argument("--index_file", default=None, help="object library: ycb | extra_shape")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    """Train; returns the Trainer."""
    args = create_parser().parse_args(argv)
    overrides = {"output_dir": args.log_dir}
    for k in ("seed", "num_envs", "max_epoch", "index_file"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v

    from gaddpg_tpu_torch.train.config import load_config
    from gaddpg_tpu_torch.train.loop import Trainer

    cfg = load_config(args.config_file, overrides=overrides, policy=args.policy)
    os.makedirs(cfg.output_dir, exist_ok=True)
    # snapshot the config (reference: core/train_online.py:108-126)
    with open(os.path.join(cfg.output_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    trainer = Trainer(cfg, device=args.device)
    if args.pretrained and trainer.load_pretrained(args.pretrained):
        print(f"resumed from {args.pretrained} at step {trainer.update_step}")

    t0 = time.time()
    perf = trainer.run(max_iters=args.max_iters)
    print(perf.table())
    print(f"total wall time {time.time() - t0:.1f}s, update steps {trainer.update_step}, "
          f"env steps {int(trainer.buffer.total_env_step)}")

    if args.save_buffer:
        from gaddpg_tpu_torch.replay import save_npz

        save_npz(trainer.buffer, os.path.join(cfg.output_dir, cfg.save_data_name))
    return trainer


if __name__ == "__main__":
    main()
