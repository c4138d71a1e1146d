"""PointNet++ encoder, policy and critic heads."""

from gaddpg_tpu_torch.models.heads import GaussianPolicy, QNetwork
from gaddpg_tpu_torch.models.pointnet import (
    GoalFeature, PointNetEncoder, PointNetFeature, SetAbstraction,
)

__all__ = ["GaussianPolicy", "GoalFeature", "PointNetEncoder", "PointNetFeature", "QNetwork",
           "SetAbstraction"]
