"""Closed-form Franka Panda forward kinematics (counterpart of
gaddpg_tpu/robot/panda.py).

Kinematic parameters of the reference URDF
(reference: env/models/panda/panda_gripper_hand_camera.urdf):

    joint1: t=(0,0,0.333)            Rz(q1)
    joint2: rpy=(-pi/2,0,0)          Rz(q2)
    joint3: t=(0,-0.316,0)  rpy=(pi/2,0,0)   Rz(q3)
    joint4: t=(0.0825,0,0)  rpy=(pi/2,0,0)   Rz(q4)
    joint5: t=(-0.0825,0.384,0) rpy=(-pi/2,0,0) Rz(q5)
    joint6: rpy=(pi/2,0,0)           Rz(q6)
    joint7: t=(0.088,0,0)   rpy=(pi/2,0,0)   Rz(q7)
    hand:   t=(0,0,0.107)   Rz(-pi/4)                (fixed)
    fingerL/R: t=(0,0,0.0584), prismatic +-y          (0..0.04)
    camera: t=(0.036,0,0.036) rpy=(-pi/2,0,-pi/2)     (fixed)

Every function takes joints q (..., 7) and broadcasts over the leading
axes; `base` (..., 4, 4), where given, places the arm's base in the
world (default: the identity). Callers on the card run them under
`utils.precision.f32_matmuls`, as the rest of the geometry.

The constants are float64 numpy arrays; `utils.constants.const` hands
them out as float32 tensors on a device, as the JAX package casts them. The
"end-effector" everywhere is the hand frame (PyBullet link 7,
reference: env/panda_gripper_hand_camera.py:52).
"""

import numpy as np
import torch

from gaddpg_tpu_torch.utils.constants import const

# Arm joint limits (reference: env/panda_gripper_hand_camera.py:53-54).
JOINT_LOWER = np.array([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973])
JOINT_UPPER = np.array([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973])
FINGER_LOWER, FINGER_UPPER = 0.0, 0.04

# Home configuration (reference: env/panda_gripper_hand_camera.py:73-74).
DEFAULT_JOINTS = np.array([0.0, -1.285, 0.0, -2.356, 0.0, 1.571, 0.785])

# IK restart seeds (reference: core/utils.py:41-56).
ANCHOR_SEEDS = np.array(
    [
        [0.0, -1.285, 0, -2.356, 0.0, 1.571, 0.785],
        [2.5, 0.23, -2.89, -1.69, 0.056, 1.46, -1.27],
        [2.8, 0.23, -2.89, -1.69, 0.056, 1.46, -1.27],
        [2, 0.23, -2.89, -1.69, 0.056, 1.46, -1.27],
        [2.5, 0.83, -2.89, -1.69, 0.056, 1.46, -1.27],
        [0.049, 1.22, -1.87, -0.67, 2.12, 0.99, -0.85],
        [-2.28, -0.43, 2.47, -1.35, 0.62, 2.28, -0.27],
        [-2.02, -1.29, 2.20, -0.83, 0.22, 1.18, 0.74],
        [-2.2, 0.03, -2.89, -1.69, 0.056, 1.46, -1.27],
        [-2.5, -0.71, -2.73, -0.82, -0.7, 0.62, -0.56],
        [-2, -0.71, -2.73, -0.82, -0.7, 0.62, -0.56],
        [-2.66, -0.55, 2.06, -1.77, 0.96, 1.77, -1.35],
        [1.51, -1.48, -1.12, -1.55, -1.57, 1.15, 0.24],
        [-2.61, -0.98, 2.26, -0.85, 0.61, 1.64, 0.23],
    ]
)


def _rpy_t(roll, pitch, yaw, x, y, z):
    """Constant URDF joint-origin transform as a 4x4 (float64)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    T = np.eye(4)
    T[:3, :3] = rz @ ry @ rx
    T[:3, 3] = [x, y, z]
    return T


_HPI = np.pi / 2
# Static joint-origin transforms for the 7 revolute joints.
_ORIGINS = np.stack(
    [
        _rpy_t(0, 0, 0, 0, 0, 0.333),
        _rpy_t(-_HPI, 0, 0, 0, 0, 0),
        _rpy_t(_HPI, 0, 0, 0, -0.316, 0),
        _rpy_t(_HPI, 0, 0, 0.0825, 0, 0),
        _rpy_t(-_HPI, 0, 0, -0.0825, 0.384, 0),
        _rpy_t(_HPI, 0, 0, 0, 0, 0),
        _rpy_t(_HPI, 0, 0, 0.088, 0, 0),
    ]
)
_T_HAND = _rpy_t(0, 0, -np.pi / 4, 0, 0, 0.107)
_T_FINGER = _rpy_t(0, 0, 0, 0, 0, 0.0584)
_T_CAMERA = _rpy_t(-_HPI, 0, -_HPI, 0.036, 0, 0.036)

# Full-arm collision skeleton: spheres at each inter-frame segment's
# start and midpoint from link 1 through the hand, plus the hand origin
# (reference plans and collision-checks every link,
# reference: env/panda_scene.py:897-917, 1078-1095).
_ARM_SEG_RADII = np.array([0.065, 0.065, 0.062, 0.058, 0.055, 0.05, 0.05])
_ARM_SEG_TS = np.array([0.0, 0.5])
ARM_POINT_RADII = np.concatenate([np.repeat(_ARM_SEG_RADII, len(_ARM_SEG_TS)), [0.05]])


def _rz_h(q):
    """Rz(q) as (..., 4, 4)."""
    c, s = torch.cos(q), torch.sin(q)
    z, o = torch.zeros_like(q), torch.ones_like(q)
    m = torch.stack([c, -s, z, z, s, c, z, z, z, z, o, z, z, z, z, o], dim=-1)
    return m.reshape(*q.shape, 4, 4)


def _start(q, base=None):
    """The chain's first frame: `base` (..., 4, 4) broadcast over q's
    leading axes, or the identity."""
    if base is None:
        return torch.eye(4, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 4, 4)
    return base.expand(*torch.broadcast_shapes(q.shape[:-1], base.shape[:-2]), 4, 4)


def _joint_frames(q, base=None):
    """The 7 joint frames after each joint's rotation, in order."""
    origins = const(_ORIGINS, q.device)
    T = _start(q, base)
    frames = []
    for i in range(7):
        T = T @ origins[i] @ _rz_h(q[..., i])
        frames.append(T)
    return frames


def fk_all(q, base=None):
    """All 8 frames (links 1..7 + hand) for arm joints q (..., 7):
    (..., 8, 4, 4) in the base frame, or in the world with `base`."""
    frames = _joint_frames(q, base)
    frames.append(frames[-1] @ const(_T_HAND, q.device))
    return torch.stack(frames, dim=-3)


def fk_hand(q, base=None):
    """Hand ("end-effector") frame only, (..., 4, 4)."""
    return _joint_frames(q, base)[-1] @ const(_T_HAND, q.device)


def fk_camera(q, base=None):
    """Wrist camera frame (..., 4, 4): hand @ T_CAMERA."""
    return fk_hand(q, base) @ const(_T_CAMERA, q.device)


def fk_fingers(q, finger, base=None):
    """Left and right fingertip frames (..., 2, 4, 4) for finger openings
    (..., 2): finger 1 translates +y, finger 2 -y in the hand frame."""
    tip = fk_hand(q, base) @ const(_T_FINGER, q.device)
    shift = torch.zeros((*finger.shape[:-1], 2, 4, 4), dtype=q.dtype, device=q.device)
    shift[..., 1, 3] = torch.stack([finger[..., 0], -finger[..., 1]], dim=-1)
    shift = shift + torch.eye(4, dtype=q.dtype, device=q.device)
    return tip[..., None, :, :] @ shift


def hand_jacobian(q):
    """(..., 6, 7) geometric Jacobian of the hand frame: the position rows
    by forward-mode differentiation of `fk_hand` (`torch.func.jacfwd`, as
    the JAX package's `jax.jacfwd`), the rotation rows the z axis of each
    joint frame."""
    def position(qq):
        return fk_hand(qq)[:3, 3]

    flat = q.reshape(-1, 7)
    jp = torch.func.vmap(torch.func.jacfwd(position))(flat).reshape(*q.shape[:-1], 3, 7)
    jr = torch.stack([T[..., :3, 2] for T in _joint_frames(q)], dim=-1)
    return torch.cat([jp, jr], dim=-2)


def arm_collision_points(q=None, base=None, frames=None):
    """(..., N, 3) world sphere centres along the arm skeleton (pair
    with ARM_POINT_RADII (N,)), from joints q (..., 7) (and `base`) or
    from frames (..., 8, 4, 4) that `fk_all` already gave (no second FK
    chain)."""
    if frames is None:
        frames = fk_all(q, base)
    starts = frames[..., :-1, :3, 3]                     # (..., 7, 3)
    ends = frames[..., 1:, :3, 3]
    ts = const(_ARM_SEG_TS, frames.device)[:, None]      # (T, 1)
    pts = starts[..., :, None, :] * (1.0 - ts) + ends[..., :, None, :] * ts
    pts = pts.reshape(*pts.shape[:-3], -1, 3)
    return torch.cat([pts, ends[..., -1:, :]], dim=-2)


class PandaKinematics:
    """The chain's constants and forward kinematics under one name."""

    joint_lower = JOINT_LOWER
    joint_upper = JOINT_UPPER
    default_joints = DEFAULT_JOINTS
    anchor_seeds = ANCHOR_SEEDS
    fk_hand = staticmethod(fk_hand)
    fk_all = staticmethod(fk_all)
    fk_camera = staticmethod(fk_camera)
    fk_fingers = staticmethod(fk_fingers)
