"""Training: the batched rollout and the online learner loop (counterpart
of gaddpg_tpu/train/).

- `RolloutWorker.rollout`: N envs play one episode each (expert / policy
  / DAgger / DART branching as per-env masked selects), then a batched
  retract scores the lifts;
- `Trainer`: collect -> replay insert on the device -> agent updates
  sampled from the ring, with the schedules, checkpoints and metrics;
- `checkpoints`: the port's snapshots and the JAX package's `.msgpack`
  ones (`flax_msgpack` decodes them).
"""

from gaddpg_tpu_torch.train.config import TrainConfig, load_config
from gaddpg_tpu_torch.train.loop import Trainer
from gaddpg_tpu_torch.train.rollout import RolloutWorker
from gaddpg_tpu_torch.train.schedules import explore_schedule, noise_schedule

__all__ = ["RolloutWorker", "TrainConfig", "Trainer", "explore_schedule", "load_config",
           "noise_schedule"]
