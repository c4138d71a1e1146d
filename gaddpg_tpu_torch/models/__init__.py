"""PointNet++ encoder, policy and critic heads."""

from gaddpg_tpu_torch.models.heads import GaussianPolicy, QNetwork
from gaddpg_tpu_torch.models.pointnet import PointNetEncoder, PointNetFeature, SetAbstraction

__all__ = ["GaussianPolicy", "PointNetEncoder", "PointNetFeature", "QNetwork", "SetAbstraction"]
