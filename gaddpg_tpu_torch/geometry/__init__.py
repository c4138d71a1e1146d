"""Geometry constants and transforms (counterpart of gaddpg_tpu/geometry/):
quaternions are (w, x, y, z), euler angles static-frame xyz ("sxyz"), a
packed pose [t(3), q(4)] and a "rot-first" one [q(4), t(3)]."""

from gaddpg_tpu_torch.geometry.gripper import (
    GRIPPER_CONTROL_POINTS, HAND_FINGER_POINTS, control_points, control_points_from_euler_trans,
    transform_control_points_qt,
)
from gaddpg_tpu_torch.geometry.rotations import (
    axis_angle_to_quat, euler_to_mat, euler_to_quat, mat_to_euler, mat_to_quat, quat_conj,
    quat_integrate, quat_mul, quat_normalize, quat_rotate, quat_to_mat, rot_x, rot_y, rot_z,
)
from gaddpg_tpu_torch.geometry.se3 import (
    inv_relative_pose, pack_pose, pack_pose_rot_first, se3_from_quat_pos, se3_inverse,
    se3_log_pose_delta, se3_mul, se3_transform_points, unpack_action, unpack_pose,
    unpack_pose_rot_first,
)

__all__ = ["GRIPPER_CONTROL_POINTS", "HAND_FINGER_POINTS", "axis_angle_to_quat",
           "control_points", "control_points_from_euler_trans", "euler_to_mat",
           "euler_to_quat", "inv_relative_pose", "mat_to_euler", "mat_to_quat",
           "pack_pose", "pack_pose_rot_first", "quat_conj", "quat_integrate", "quat_mul",
           "quat_normalize", "quat_rotate", "quat_to_mat", "rot_x", "rot_y", "rot_z",
           "se3_from_quat_pos", "se3_inverse", "se3_log_pose_delta", "se3_mul",
           "se3_transform_points", "transform_control_points_qt", "unpack_action",
           "unpack_pose", "unpack_pose_rot_first"]
