"""PointNet++ and ResNet-18 encoders, policy and critic heads."""

from gaddpg_tpu_torch.models.heads import GaussianPolicy, QNetwork
from gaddpg_tpu_torch.models.pointnet import (
    GoalFeature, PointNetEncoder, PointNetFeature, SetAbstraction,
)
from gaddpg_tpu_torch.models.resnet import ImageFeature, ResNet18Feature

__all__ = ["GaussianPolicy", "GoalFeature", "ImageFeature", "PointNetEncoder",
           "PointNetFeature", "QNetwork", "ResNet18Feature", "SetAbstraction"]
