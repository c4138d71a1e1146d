"""PointNet++ encoder and policy head."""

from gaddpg_tpu_torch.models.heads import GaussianPolicy
from gaddpg_tpu_torch.models.pointnet import PointNetEncoder, PointNetFeature, SetAbstraction

__all__ = ["GaussianPolicy", "PointNetEncoder", "PointNetFeature", "SetAbstraction"]
