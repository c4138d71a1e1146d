"""Milestone schedules for exploration and noise (counterpart of
gaddpg_tpu/train/schedules.py; host-side, plain Python;
reference: core/train_online.py:533-537, experiments/config.py:150-153)."""


def _valid_index(arr, idx):
    return arr[min(len(arr) - 1, idx)]


def _milestone_index(update_step, cfg) -> int:
    return sum(update_step > m for m in cfg.mix_milestones)


def explore_schedule(update_step, cfg):
    """Fraction of envs rolling the policy instead of the expert."""
    ratio = cfg.explore_ratio * _valid_index(cfg.explore_ratio_list,
                                             _milestone_index(update_step, cfg))
    return min(ratio, cfg.explore_cap)


def noise_schedule(update_step, cfg):
    """Exploration noise scale multiplier."""
    return _valid_index(cfg.noise_ratio_list, _milestone_index(update_step, cfg))
