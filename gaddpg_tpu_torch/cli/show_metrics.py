"""Summarise metrics.jsonl files across runs (counterpart of
gaddpg_tpu/cli/show_metrics.py).

Takes the place of the reference's TensorBoard multiplexer
(reference: core/load_tensorboard.py): point it at one or more run
directories and get each scalar's mean over its last values.

    python -m gaddpg_tpu_torch.cli.show_metrics output/run0 output/run1
"""

import argparse
import collections
import json
import os


def summarize(path: str, window: int = 50):
    """{"step": the last step, scalar: mean of its last `window` values}
    of `path`/metrics.jsonl, or None without the file. Lines that are not
    JSON are skipped."""
    f = os.path.join(path, "metrics.jsonl")
    if not os.path.exists(f):
        return None
    tail = collections.defaultdict(list)
    last_step = 0
    with open(f) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            last_step = rec.get("step", last_step)
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k != "step":
                    tail[k].append(v)
    out = {"step": last_step}
    for k, vs in tail.items():
        out[k] = sum(vs[-window:]) / len(vs[-window:])
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("runs", nargs="+")
    p.add_argument("--keys", default=None, help="comma-separated scalar filter")
    args = p.parse_args(argv)
    keys = args.keys.split(",") if args.keys else None
    for run in args.runs:
        s = summarize(run)
        if s is None:
            print(f"{run}: no metrics.jsonl")
            continue
        print(f"== {run} (step {s.pop('step')})")
        for k in sorted(s):
            if keys and k not in keys:
                continue
            print(f"  {k:28s} {s[k]:.5f}")


if __name__ == "__main__":
    main()
