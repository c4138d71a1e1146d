"""Replay: the ring buffer on the device and reference .npz compatibility
(counterpart of gaddpg_tpu/replay/)."""

from gaddpg_tpu_torch.replay.buffer import (
    ReplayBuffer, add_episode, add_episodes, create_buffer, sample, upper_idx,
)
from gaddpg_tpu_torch.replay.npz_io import load_npz, save_npz

__all__ = ["ReplayBuffer", "add_episode", "add_episodes", "create_buffer", "load_npz",
           "sample", "save_npz", "upper_idx"]
