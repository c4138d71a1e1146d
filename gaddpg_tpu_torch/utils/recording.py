"""Episode recording for offline visualisation (counterpart of
gaddpg_tpu/utils/recording.py).

The reference writes rollout videos with OpenCV and a Blender recorder
(reference: core/utils.py:370-406, core/train_test_offline_blender.py).
Here an episode records its pose stream (joints, object pose, goal) to
an .npz, which any renderer can replay offline. States and observations
may lie on any device: each frame is copied to the host.
"""

import os
from typing import Dict, List

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class EpisodeRecorder:
    def __init__(self):
        self.frames: List[Dict[str, np.ndarray]] = []

    def add(self, state, obs=None, action=None, extra=None):
        frame = {
            "joints": _np(state.phys.arm.q),
            "obj_pos": _np(state.phys.obj.pos),
            "obj_quat": _np(state.phys.obj.quat),
            "obj_idx": _np(state.obj_idx),
            "goal_obj": _np(state.goal_obj),
        }
        if obs is not None:
            frame["ef_pose"] = _np(obs.ef_pose)
            frame["num_points"] = _np(obs.num_points)
        if action is not None:
            frame["action"] = _np(action)
        if extra:
            frame.update({k: _np(v) for k, v in extra.items()})
        self.frames.append(frame)

    def save(self, path: str):
        """Stack every key present in all frames into `path` (.npz);
        nothing is written for an empty recording."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not self.frames:
            return
        stacked = {k: np.stack([f[k] for f in self.frames]) for k in self.frames[0]
                   if all(k in f for f in self.frames)}
        np.savez(path, **stacked)

    def __len__(self):
        return len(self.frames)
