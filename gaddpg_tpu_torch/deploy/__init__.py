"""Deployment: real-camera point-state construction and the control loop."""

from gaddpg_tpu_torch.deploy.realworld import RealsenseStateBuilder, backproject_depth

__all__ = ["RealsenseStateBuilder", "backproject_depth"]
