"""Config system: typed dataclass tree + YAML overlay (counterpart of
gaddpg_tpu/train/config.py, over the port's own AgentConfig and
EnvParams).

Mirrors the reference's edict-based config (reference:
experiments/config.py:31-177) with the same key names where they still
apply, but typed and immutable. YAML experiment files use the same
nesting (`RL_TRAIN:` block) as the reference's experiments/cfgs/*.yaml.
PyYAML is imported only when `load_config` is given a file.
"""

import dataclasses
from typing import Optional, Tuple

from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.envs.grasp_env import EnvParams


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # schedule / scale (reference: experiments/config.py:67-177)
    seed: int = 3                          # RNG_SEED
    num_envs: int = 64                     # replaces num_remotes CPU actors
    max_steps: int = 20                    # RL_MAX_STEP
    extend_steps: int = 6                  # EXTEND_MAX_STEP margin
    buffer_size: int = 100000              # RL_MEMORY_SIZE
    online_buffer_size: int = 0            # ONPOLICY_MEMORY_SIZE (0 = share)
    batch_size: int = 256
    updates_per_iter: int = 4              # updates_per_step
    # remaining-time feature at EVAL time: "plan" derives it from the
    # expert plan length (training-consistent), "steps" uses
    # max_steps - t (the reference's deployment convention,
    # reference: core/test_realworld_ros_final.py episode clock).
    # RESULTS.md carries the A/B showing the policy tolerates both.
    eval_time_mode: str = "plan"
    max_epoch: int = 150000
    fill_data_step: int = 10
    online_buffer_ratio: float = 0.0
    save_interval: int = 4000
    log_interval: int = 10

    # exploration (reference: experiments/config.py:146-167)
    explore_ratio: float = 0.1
    explore_cap: float = 0.5
    explore_ratio_list: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.5, 0.6, 0.7, 0.8)
    noise_ratio_list: Tuple[float, ...] = (3.0, 2.5, 2.0, 1.5, 1.0, 0.5)
    mix_milestones: Tuple[int, ...] = (
        4000, 8000, 20000, 40000, 60000, 80000, 100000, 140000, 180000,
    )
    expert_initial_state: bool = True
    expert_init_min_step: int = 0
    expert_init_max_step: int = 15
    dagger: bool = False
    dagger_min_step: int = 5
    dagger_max_step: int = 18
    dagger_ratio: float = 0.5
    # collision-aware demo curation (BC/DAgger collection only):
    # dagger_success_filter keeps ONLY successful episodes (expert and
    # explore alike) -- failed on-policy DAgger trajectories dilute the
    # demo set at low demo budgets; demo_collision_filter additionally
    # drops episodes that carry a robot-obstacle collision flag
    dagger_success_filter: bool = False
    demo_collision_filter: bool = False
    dart: bool = True
    dart_min_step: int = 5
    dart_max_step: int = 13
    dart_ratio: float = 0.5

    # policy selection
    policy: str = "DDPG"                   # "DDPG" | "BC"
    rl: bool = True
    self_supervision: bool = False
    onpolicy: bool = False

    # data
    index_file: str = "extra_shape"        # object library name
    index_split: str = "train"
    save_data_name: str = "data_50k.npz"
    output_dir: str = "output"

    agent: AgentConfig = dataclasses.field(default_factory=AgentConfig)
    env: EnvParams = dataclasses.field(default_factory=EnvParams)

    @property
    def rollout_horizon(self) -> int:
        return self.max_steps + self.extend_steps


# Mapping from reference RL_TRAIN keys -> TrainConfig/AgentConfig fields.
_RL_TRAIN_MAP = {
    "batch_size": ("train", "batch_size"),
    "updates_per_step": ("train", "updates_per_iter"),
    "max_epoch": ("train", "max_epoch"),
    "fill_data_step": ("train", "fill_data_step"),
    "online_buffer_ratio": ("train", "online_buffer_ratio"),
    "explore_ratio": ("train", "explore_ratio"),
    "explore_cap": ("train", "explore_cap"),
    "explore_ratio_list": ("train", "explore_ratio_list"),
    "noise_ratio_list": ("train", "noise_ratio_list"),
    "mix_milestones": ("train", "mix_milestones"),
    "expert_initial_state": ("train", "expert_initial_state"),
    "EXPERT_INIT_MIN_STEP": ("train", "expert_init_min_step"),
    "EXPERT_INIT_MAX_STEP": ("train", "expert_init_max_step"),
    "dagger": ("train", "dagger"),
    "DAGGER_MIN_STEP": ("train", "dagger_min_step"),
    "DAGGER_MAX_STEP": ("train", "dagger_max_step"),
    "DAGGER_RATIO": ("train", "dagger_ratio"),
    "dart": ("train", "dart"),
    "DART_MIN_STEP": ("train", "dart_min_step"),
    "DART_MAX_STEP": ("train", "dart_max_step"),
    "DART_RATIO": ("train", "dart_ratio"),
    "RL": ("train", "rl"),
    "self_supervision": ("train", "self_supervision"),
    "onpolicy": ("train", "onpolicy"),
    "index_file": ("train", "index_file"),
    "num_remotes": ("train", "num_envs"),
    # agent fields
    "gamma": ("agent", "gamma"),
    "tau": ("agent", "tau"),
    "lr": ("agent", "lr"),
    "value_lr": ("agent", "value_lr"),
    "lr_gamma": ("agent", "lr_gamma"),
    "value_lr_gamma": ("agent", "value_lr_gamma"),
    "clip_grad": ("agent", "clip_grad"),
    "hidden_size": ("agent", "hidden_size"),
    "policy_update_gap": ("agent", "policy_update_gap"),
    "target_update_interval": ("agent", "target_update_interval"),
    "action_noise": ("agent", "action_noise"),
    "noise_type": ("agent", "noise_type"),
    "policy_aux": ("agent", "policy_aux"),
    "critic_aux": ("agent", "critic_aux"),
    "collision_demo_discount": ("agent", "collision_demo_discount"),
    "collision_aux_weight": ("agent", "collision_aux_weight"),
    "sa_channel_concat": ("agent", "sa_channel_concat"),
    "use_time": ("agent", "use_time"),
    "use_image": ("agent", "use_image"),
    "IMG_SIZE": ("agent", "image_size"),
    "pretrained_resnet": ("agent", "pretrained_resnet"),
    "train_feature": ("agent", "train_feature"),
    "train_value_feature": ("agent", "train_value_feature"),
    "policy_milestones": ("agent", "policy_milestones"),
    "value_milestones": ("agent", "value_milestones"),
    "mix_policy_ratio_list": ("agent", "mix_policy_ratio_list"),
    "mix_value_ratio_list": ("agent", "mix_value_ratio_list"),
}

# env-level keys (EnvParams fields settable from experiment YAML)
_ENV_MAP = {
    "num_clutter": "num_clutter",
    "domain_rand": "domain_rand",
    "use_planner": "use_planner",
    "RL_MAX_STEP_ENV": "max_steps",
    "reset_tries": "reset_tries",
}

_TOP_MAP = {
    "RL_MEMORY_SIZE": "buffer_size",
    "ONPOLICY_MEMORY_SIZE": "online_buffer_size",
    "RL_MAX_STEP": "max_steps",
    "RNG_SEED": "seed",
    "RL_SAVE_DATA_NAME": "save_data_name",
    "OUTPUT_DIR": "output_dir",
}


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None,
                policy: Optional[str] = None) -> TrainConfig:
    """Build a TrainConfig, optionally overlaying a reference-style YAML."""
    train_kw = {}
    agent_kw = {}
    env_kw = {}

    def apply(d: dict):
        for k, v in d.items():
            if k == "RL_TRAIN" and isinstance(v, dict):
                apply(v)
            elif k in _RL_TRAIN_MAP:
                scope, field = _RL_TRAIN_MAP[k]
                if isinstance(v, list):
                    v = tuple(v)
                (train_kw if scope == "train" else agent_kw)[field] = v
            elif k in _TOP_MAP:
                v2 = tuple(v) if isinstance(v, list) else v
                if _TOP_MAP[k] == "online_buffer_size" and v2 == -1:
                    v2 = 0
                train_kw[_TOP_MAP[k]] = v2
            elif k in _ENV_MAP:
                env_kw[_ENV_MAP[k]] = v

    if path:
        # PyYAML is needed only to read an experiment file; a plain
        # ImportError says so where it is missing
        import yaml

        with open(path) as f:
            apply(yaml.safe_load(f) or {})
    if overrides:
        apply(overrides)
        for k, v in overrides.items():
            if k in TrainConfig.__dataclass_fields__:
                train_kw[k] = v
    if policy:
        train_kw["policy"] = policy
        if policy == "BC":
            # BC is supervised: rl=False routes collection through the
            # demo-curation block (success filter + the collision-aware
            # demo filters, train/loop.py), the analogue of the
            # reference's expert-only replay push
            # (reference: core/replay_memory.py:214-215). A YAML/override
            # RL: True still wins (explicit beats implied).
            train_kw.setdefault("rl", False)

    env = EnvParams(**env_kw) if env_kw else EnvParams()
    cfg = TrainConfig(agent=AgentConfig(**agent_kw), env=env, **train_kw)
    if cfg.agent.use_image and not cfg.env.use_image:
        # image mode: render RGBDM at the agent's input resolution (the
        # reference renders 112x112 for ResNet, core/networks.py:129-132)
        from gaddpg_tpu_torch.render.camera import CameraParams

        s = cfg.agent.image_size
        cfg = dataclasses.replace(
            cfg,
            env=dataclasses.replace(
                cfg.env, use_image=True,
                camera=CameraParams(width=s, height=s),
            ),
        )
    # derived hacks mirroring process_cfg (reference: experiments/config.py:180-205)
    if cfg.onpolicy and cfg.rl:
        cfg = dataclasses.replace(cfg, explore_cap=1.0)
    if cfg.self_supervision and cfg.rl:
        cfg = dataclasses.replace(
            cfg, expert_initial_state=False, explore_ratio=1.0,
            agent=dataclasses.replace(cfg.agent, action_noise=0.0),
        )
    return cfg
