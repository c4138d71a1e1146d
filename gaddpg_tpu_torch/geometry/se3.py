"""Batched SE(3) helpers: 4x4 transforms and packed poses (counterpart
of gaddpg_tpu/geometry/se3.py).

A packed pose is [t(3), q(4)], a "rot-first" one [q(4), t(3)]
(reference: core/utils.py:586-727). Every function broadcasts over
leading batch axes. Callers on the card run them under
`utils.precision.f32_matmuls`.
"""

import torch

from gaddpg_tpu_torch.geometry.rotations import (
    euler_to_mat, mat_to_euler, mat_to_quat, quat_to_mat,
)
from gaddpg_tpu_torch.utils.constants import const


def _bottom_row(top):
    row = const((0.0, 0.0, 0.0, 1.0), top.device, top.dtype)
    return row.expand(*top.shape[:-2], 1, 4)


def se3_from_quat_pos(q, t):
    """(..., 4) quat wxyz + (..., 3) pos -> (..., 4, 4)."""
    top = torch.cat([quat_to_mat(q), t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_inverse(T):
    """Inverse of rigid transform(s) (..., 4, 4)."""
    rot_t = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rot_t, -rot_t @ T[..., :3, 3:]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_mul(a, b):
    return a @ b


def se3_transform_points(T, pts):
    """Apply (..., 4, 4) to points (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def pack_pose(T):
    """(..., 4, 4) -> [t(3), q(4)] (reference: core/utils.py:606-614)."""
    return torch.cat([T[..., :3, 3], mat_to_quat(T[..., :3, :3])], dim=-1)


def unpack_pose(p):
    """[t(3), q(4)] -> (..., 4, 4)."""
    return se3_from_quat_pos(p[..., 3:7], p[..., :3])


def pack_pose_rot_first(T):
    """(..., 4, 4) -> [q(4), t(3)] (reference: core/utils.py:672-676)."""
    return torch.cat([mat_to_quat(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def unpack_pose_rot_first(p):
    """[q(4), t(3)] -> (..., 4, 4)."""
    return se3_from_quat_pos(p[..., :4], p[..., 4:7])


def inv_relative_pose(pose_b2a, pose_c2a):
    """T_{b->c} = inv(T_{c->a}) @ T_{b->a} of packed [t, q] poses
    (reference: core/utils.py:712-727)."""
    return se3_inverse(unpack_pose(pose_c2a)) @ unpack_pose(pose_b2a)


def unpack_action(action):
    """6-d task-space action [dx dy dz ex ey ez] -> (..., 4, 4) delta pose
    (reference: core/utils.py:586-590)."""
    top = torch.cat([euler_to_mat(action[..., 3:6]), action[..., :3, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_log_pose_delta(T):
    """Approximate 6-d [t, sxyz euler] coordinates of a delta transform:
    the inverse of `unpack_action` for small rotations
    (reference: env/panda_scene.py:1118-1139)."""
    return torch.cat([T[..., :3, 3], mat_to_euler(T[..., :3, :3])], dim=-1)
