"""Batched SE(3) helpers: 4x4 transforms and packed poses (counterpart
of the part of gaddpg_tpu/geometry/se3.py that the env uses).

Every function broadcasts over leading batch axes. Callers on the card
run them under `utils.precision.f32_matmuls`.
"""

import torch

from gaddpg_tpu_torch.geometry.rotations import euler_to_mat, mat_to_quat, quat_to_mat
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


def pack_pose_rot_first(T):
    """(..., 4, 4) -> [q(4), t(3)] (reference: core/utils.py:672-676)."""
    return torch.cat([mat_to_quat(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def unpack_action(action):
    """6-d task-space action [dx dy dz ex ey ez] -> (..., 4, 4) delta pose
    (reference: core/utils.py:586-590)."""
    top = torch.cat([euler_to_mat(action[..., 3:6]), action[..., :3, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)
