"""Franka Panda kinematics: forward kinematics, the hand Jacobian and
batched DLS IK (counterpart of gaddpg_tpu/robot/)."""

from gaddpg_tpu_torch.robot.ik import dls_ik, ik_from_seeds
from gaddpg_tpu_torch.robot.panda import (
    ANCHOR_SEEDS, DEFAULT_JOINTS, JOINT_LOWER, JOINT_UPPER, PandaKinematics, fk_all, fk_camera,
    fk_fingers, fk_hand, hand_jacobian,
)

__all__ = ["ANCHOR_SEEDS", "DEFAULT_JOINTS", "JOINT_LOWER", "JOINT_UPPER", "PandaKinematics",
           "dls_ik", "fk_all", "fk_camera", "fk_fingers", "fk_hand", "hand_jacobian",
           "ik_from_seeds"]
