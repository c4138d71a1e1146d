"""Agent hyperparameters (defaults = reference experiments/config.py).

The port's own copy of gaddpg_tpu/agents/config.py, field for field, so
configurations carry over unchanged: point clouds through PointNet++ or,
with `use_image`, RGBDM images through ResNet-18, in either compute
dtype.
"""

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Mirrors the RL_TRAIN block of the reference config
    (reference: experiments/config.py:67-177). Only fields consumed by
    the jitted update paths live here; env/ rollout knobs live in
    train/config.py.
    """

    # architecture
    feature_dim: int = 512
    hidden_size: int = 256
    action_dim: int = 6
    use_time: bool = True
    policy_aux: bool = True
    critic_aux: bool = True
    sa_channel_concat: bool = True
    # RGBDM image observations through ResNet-18 instead of the point
    # cloud through PointNet++ (reference: experiments/config.py:105
    # use_image, core/networks.py:106-147)
    use_image: bool = False
    image_size: int = 112
    # path to a torchvision resnet18 checkpoint (.pth state dict or .npz)
    # to initialize both image encoders from, mirroring the reference's
    # pretrained=True (reference: core/networks.py:38-58,118,126). The
    # weights are not auto-downloaded (zero-egress); empty = from scratch.
    pretrained_resnet: str = ""
    # matmul compute dtype for the feature trunks: "bfloat16" runs the
    # encoders' FC Dense layers in bf16, with params and BatchNorm in
    # float32 (the SA levels' fused kernels stay float32, as in the JAX
    # package, gaddpg_tpu/models/pointnet.py:83-140)
    compute_dtype: str = "float32"

    # collision-aware imitation (closes the clutter/mesh-scale
    # collision gap; the reference logs collision alongside success,
    # reference: env/panda_scene.py:1078-1095,
    # core/train_test_offline.py:258-302, but never trains on it):
    # collision_demo_discount d down-weights expert BC transitions whose
    # episode suffix carries a collision flag by (1 - d); 0 = off.
    collision_demo_discount: float = 0.0
    # collision_aux_weight w adds a collision-prediction logit to the
    # policy aux head, trained with sigmoid BCE against collide_future
    # (representation shaping: the trunk must separate collision-bound
    # states); 0 = off.
    collision_aux_weight: float = 0.0

    # optimization
    lr: float = 3e-4
    value_lr: float = 3e-4
    feature_lr: float = 1e-3
    lr_gamma: float = 0.5
    value_lr_gamma: float = 0.5
    feature_lr_gamma: float = 0.3
    policy_milestones: Tuple[int, ...] = (20000, 40000, 60000, 80000)
    value_milestones: Tuple[int, ...] = (20000, 40000, 60000, 80000)
    feature_milestones: Tuple[int, ...] = (8000, 16000, 30000, 50000, 70000, 90000)
    clip_grad: float = 0.5
    batch_size: int = 256
    weight_decay: float = 1e-5
    adam_eps: float = 1e-5
    train_feature: bool = True
    train_value_feature: bool = True

    # RL
    gamma: float = 0.95
    tau: float = 1e-4
    policy_update_gap: int = 2
    target_update_interval: int = 3000
    action_noise: float = 0.01
    noise_type: str = "uniform"
    # mix schedules (reference: experiments/config.py:87-89, ddpg.py:108-117)
    mix_milestones: Tuple[int, ...] = (
        4000, 8000, 20000, 40000, 60000, 80000, 100000, 140000, 180000,
    )
    mix_policy_ratio_list: Tuple[float, ...] = (0.1, 0.2)
    mix_value_ratio_list: Tuple[float, ...] = (1.0,)
    mix_policy_ratio_cap: float = 0.2  # ddpg_coefficients[4]
    mix_value_ratio_cap: float = 1.0   # ddpg_coefficients[3]
    noise_ratio_list: Tuple[float, ...] = (3.0, 2.5, 2.0, 1.5, 1.0, 0.5)

    @property
    def num_inputs(self) -> int:
        return self.feature_dim + (1 if self.use_time else 0)
