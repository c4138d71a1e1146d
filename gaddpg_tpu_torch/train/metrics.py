"""Metrics: JSONL scalars + per-object success tables (counterpart of
gaddpg_tpu/train/metrics.py).

The reference logs to tensorboardX + tabulate consoles
(reference: core/trainer.py:173-200, core/replay_memory.py:95-104).
Here scalars stream to a JSONL file (tensorboard-importable) and the
per-object table mirrors `print_obj_performance`.
"""

import collections
import json
import os
import time
from typing import Dict


# scalars are smoothed over their last SMOOTH values
SMOOTH = 50


class MetricLogger:
    def __init__(self, output_dir: str):
        """Scalars append to `output_dir`/metrics.jsonl, one JSON object
        per `log` call."""
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._smooth = collections.defaultdict(
            lambda: collections.deque(maxlen=SMOOTH)
        )
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float]):
        for k, v in scalars.items():
            self._smooth[k].append(float(v))
        rec = {"step": int(step), "wall": time.time() - self._t0}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def smoothed(self, key: str) -> float:
        d = self._smooth[key]
        return sum(d) / len(d) if d else 0.0


class ObjectPerformance:
    """Per-object attempt/success counts
    (reference: core/replay_memory.py:71-104)."""

    def __init__(self, names):
        self.names = names
        self.counts = collections.defaultdict(int)
        self.success = collections.defaultdict(int)

    def update(self, obj_idx, rewards, valid):
        for i, r, v in zip(obj_idx, rewards, valid):
            if not v:
                continue
            name = self.names[int(i)]
            self.counts[name] += 1
            self.success[name] += int(r > 0.5)

    def table(self) -> str:
        rows = ["object name              count  success  rate"]
        total_c = total_s = 0
        for name in sorted(self.counts):
            c, s = self.counts[name], self.success[name]
            total_c += c
            total_s += s
            rows.append(f"{name:24s} {c:6d} {s:8d}  {s / max(c, 1):.3f}")
        rows.append(
            f"{'TOTAL':24s} {total_c:6d} {total_s:8d}  {total_s / max(total_c, 1):.3f}"
        )
        return "\n".join(rows)

    @property
    def overall(self) -> float:
        c = sum(self.counts.values())
        return sum(self.success.values()) / max(c, 1)
