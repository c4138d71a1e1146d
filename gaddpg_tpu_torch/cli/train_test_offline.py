"""Offline training and evaluation CLI (counterpart of
gaddpg_tpu/cli/train_test_offline.py; reference: core/train_test_offline.py).

Trains from a saved replay .npz (the reference's buffer format), or
evaluates a trained policy with per-object tables and the mean and
spread over runs. Runs on the card unless --device cpu:

    # offline BC/DDPG from a buffer dump
    python -m gaddpg_tpu_torch.cli.train_test_offline --policy BC \
        --config_file experiments/cfgs/bc_aux_dagger.yaml \
        --buffer data/offline_data/data_50k.npz --log_dir output/off0

    # evaluation (experiments/scripts/test_ycb.sh's protocol)
    python -m gaddpg_tpu_torch.cli.train_test_offline --test \
        --pretrained output/off0 --num_runs 3 --episodes 200

--pretrained reads <dir>/agent_latest.pt, or the JAX package's
<dir>/agent_latest.msgpack (`train.checkpoints.load_agent`); --profile
writes a torch.profiler trace of the evaluation to
<log_dir>/profile/trace.json.
"""

import argparse
import contextlib
import os
import time

import numpy as np


def create_parser():
    p = argparse.ArgumentParser(description="GA-DDPG offline train/test (PyTorch port)")
    p.add_argument("--policy", default="BC", choices=["DDPG", "BC"])
    p.add_argument("--config_file", default=None)
    p.add_argument("--log_dir", default="output/offline")
    p.add_argument("--buffer", default=None, help="reference-format .npz")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--test", action="store_true")
    p.add_argument("--num_runs", type=int, default=1)
    p.add_argument("--episodes", type=int, default=None,
                   help="eval episodes per run (default num_envs)")
    p.add_argument("--max_updates", type=int, default=None)
    p.add_argument("--index_file", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--video", type=int, default=0, metavar="N",
                   help="record N eval episodes as a GIF and a PNG strip "
                        "(reference: core/utils.py:370-406)")
    p.add_argument("--expert", action="store_true",
                   help="evaluate the expert instead of the policy (reference --expert A/B)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the evaluation to log_dir/profile")
    p.add_argument("--device", default="cuda")
    return p


def _profiler(out_dir: str, device):
    """A torch.profiler context over the CPU and, on the card, CUDA, whose
    exit writes the Chrome trace `out_dir`/trace.json."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=lambda prof: prof.export_chrome_trace(os.path.join(out_dir, "trace.json")))


def main(argv=None):
    """With --test, returns the mean success rate over the runs; else
    trains offline and returns the number of updates."""
    args = create_parser().parse_args(argv)
    overrides = {"output_dir": args.log_dir}
    for k in ("index_file", "seed"):
        if getattr(args, k) is not None:
            overrides[k] = getattr(args, k)

    import torch

    from gaddpg_tpu_torch import replay
    from gaddpg_tpu_torch.train.checkpoints import load_agent, save_agent
    from gaddpg_tpu_torch.train.config import load_config
    from gaddpg_tpu_torch.train.loop import Trainer

    cfg = load_config(args.config_file, overrides=overrides, policy=args.policy)
    trainer = Trainer(cfg, device=args.device)
    if args.pretrained:
        restored = load_agent(trainer.agent_state, args.pretrained)
        if restored is not None:
            trainer.agent_state = restored
            print(f"loaded {args.pretrained} @ step {trainer.update_step}")

    if args.test:
        if args.video:
            # rollout videos (reference: core/utils.py:370-406)
            from gaddpg_tpu_torch.agents.ddpg import make_select_action
            from gaddpg_tpu_torch.utils.video import record_episode, write_strip, write_video

            select = None if args.expert else make_select_action(cfg.agent, trainer.device)
            vdir = os.path.join(cfg.output_dir, "videos")
            for ep in range(args.video):
                gen = torch.Generator(device=trainer.device).manual_seed(1000 + ep)
                frames, success, _ = record_episode(trainer.env, trainer.agent_state, select,
                                                    gen, use_image_policy=cfg.agent.use_image)
                tag = f"ep{ep}_{'ok' if success > 0.5 else 'fail'}"
                write_video(frames, os.path.join(vdir, f"{tag}.gif"))
                write_strip(frames, os.path.join(vdir, f"{tag}.png"))
                print(f"recorded {vdir}/{tag}.gif ({len(frames)} frames)")

        # evaluation protocol (reference: experiments/scripts/test_ycb.sh:
        # ~200 episodes x 3 runs, mean +- std)
        prof = contextlib.nullcontext()
        if args.profile:
            prof_dir = os.path.join(cfg.output_dir, "profile")
            prof = _profiler(prof_dir, trainer.device)
            print(f"profiling eval to {prof_dir}")
        rates = []
        with prof:
            for run in range(args.num_runs):
                n_ep = args.episodes or cfg.num_envs
                waves = max(1, n_ep // cfg.num_envs)
                rate, perf = trainer.evaluate(episodes=waves, expert=args.expert)
                rates.append(rate)
                print(f"run {run}: success {rate:.3f}")
                print(perf.table())
        print(f"overall: {np.mean(rates):.3f} +- {np.std(rates):.3f}")
        return float(np.mean(rates))

    # offline training from a buffer dump
    if not args.buffer:
        raise SystemExit("--buffer is required for offline training")
    num_pts = cfg.env.uniform_num_pts + 6
    trainer.buffer = replay.load_npz(args.buffer, buffer_size=cfg.buffer_size,
                                     num_points=num_pts, device=trainer.device)
    print(f"loaded buffer: {replay.upper_idx(trainer.buffer)} transitions")
    max_updates = args.max_updates or cfg.max_epoch
    t0 = time.time()
    while trainer.update_step < max_updates:
        metrics = trainer.train_iter()
        if not metrics:
            raise SystemExit(f"{args.buffer} holds fewer than batch_size={cfg.batch_size} "
                             "transitions")
        if trainer.update_step % cfg.log_interval < cfg.updates_per_iter:
            trainer.metrics.log(trainer.update_step, metrics)
        if trainer.update_step % cfg.save_interval < cfg.updates_per_iter:
            save_agent(trainer.agent_state, cfg.output_dir)
    save_agent(trainer.agent_state, cfg.output_dir)
    print(f"offline training done: {trainer.update_step} updates in {time.time() - t0:.0f}s")
    return trainer.update_step


if __name__ == "__main__":
    main()
