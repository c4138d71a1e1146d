"""Panda gripper anchor and control points, and the point-matching (PM)
transforms of the losses (counterpart of gaddpg_tpu/geometry/gripper.py).

Six canonical gripper "control points" are transformed by predicted and
ground-truth poses and compared with an L1 point-matching loss. Numbers
match the reference (reference: core/utils.py:38-40, 814-937).
"""

import math

import numpy as np
import torch

from gaddpg_tpu_torch.geometry.rotations import euler_to_mat, quat_rotate, rot_z

# 6 anchor points on the hand in the wrist-camera-aligned frame used by
# the point-cloud state: columns are points (3, 6)
# (reference: core/utils.py:38-40).
HAND_FINGER_POINTS = np.array(
    [
        [0.0, 0.0, 0.0, -0.0, 0.0, -0.0],
        [0.0, 0.0, 0.053, -0.053, 0.053, -0.053],
        [0.0, 0.0, 0.075, 0.075, 0.105, 0.105],
    ],
    dtype=np.float32,
)

# Canonical control points in the gripper frame, (6, 3)
# (reference: core/utils.py:819-824).
GRIPPER_CONTROL_POINTS = np.array(
    [
        [0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0],
        [0.053, -0.0, 0.075],
        [-0.053, 0.0, 0.075],
        [0.053, -0.0, 0.105],
        [-0.053, 0.0, 0.105],
    ],
    dtype=np.float32,
)


def control_points(rotz: bool = False, device="cpu", dtype=torch.float32):
    """(6, 3) control points, optionally right-multiplied by Rz(pi/2),
    which maps (x, y, z) -> (y, -x, z) and aligns them with
    HAND_FINGER_POINTS (reference: core/utils.py:826-827)."""
    pts = torch.as_tensor(GRIPPER_CONTROL_POINTS, device=device, dtype=dtype)
    if rotz:
        pts = pts @ rot_z(torch.tensor(math.pi / 2, device=device, dtype=dtype))
    return pts


def transform_control_points_qt(qt, rotz: bool = False):
    """Control points transformed by packed grasps [q (4, wxyz), t (3)]:
    qt (..., 7) -> (..., 6, 3) (reference: core/utils.py:834-874)."""
    pts = control_points(rotz, qt.device, qt.dtype)
    q = qt[..., None, :4].expand(*qt.shape[:-1], pts.shape[0], 4)
    t = qt[..., None, 4:7]
    return quat_rotate(q, pts.expand(*qt.shape[:-1], *pts.shape)) + t


def control_points_from_euler_trans(euler, trans, rotz: bool = False):
    """Control points from sxyz euler (..., 3) and translation (..., 3):
    pts @ R^T + t (reference: core/utils.py:926-937)."""
    rot = euler_to_mat(euler)
    pts = control_points(rotz, euler.device, euler.dtype)
    return pts @ rot.transpose(-1, -2) + trans[..., None, :]
