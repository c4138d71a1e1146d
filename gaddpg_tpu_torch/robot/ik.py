"""Batched damped-least-squares inverse kinematics (counterpart of
gaddpg_tpu/robot/ik.py).

The iteration is written element for element as the JAX package's
fusible form: the FK chain carried as quaternions, the rotation error
and trace from the column identities

    w = sum_k R[:,k] x T[:,k],     trace(T R^T) = sum(T * R),

the right-Jacobian-inverse action through rx^2 = r r^T - |r|^2 I, the
normal equations A = J J^T as a broadcast-reduce, and the 6x6 SPD
system solved by an unrolled Cholesky in scalar ops (no
`torch.linalg.solve`). Everything is batched over leading axes: one
call solves every env, or every (env, seed) pair of `ik_from_seeds`.
"""

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from gaddpg_tpu_torch.geometry.rotations import quat_mul, quat_rotate, quat_to_mat
from gaddpg_tpu_torch.robot import panda
from gaddpg_tpu_torch.utils.constants import const

# constant joint-origin chain as quaternions (wxyz) and offsets, float64
_OQ = np.roll(Rotation.from_matrix(panda._ORIGINS[:, :3, :3]).as_quat(), 1, axis=-1)
_OT = panda._ORIGINS[:, :3, 3]
_HQ = np.roll(Rotation.from_matrix(panda._T_HAND[:3, :3]).as_quat(), 1, axis=-1)
_HT = panda._T_HAND[:3, 3]
_IDENTITY_QUAT = (1.0, 0.0, 0.0, 0.0)
_EZ = (0.0, 0.0, 1.0)


def _fk_frames_fused(q):
    """Hand pose and joint axes/origins from one quaternion FK pass.

    q (..., 7) -> (p_e (..., 3), R_hand (..., 3, 3), z (..., 7, 3) joint
    axes, p (..., 7, 3) joint origins)."""
    dev, batch = q.device, q.shape[:-1]
    oq, ot, ez = const(_OQ, dev), const(_OT, dev), const(_EZ, dev)
    pos = q.new_zeros(*batch, 3)
    rot = const(_IDENTITY_QUAT, dev).expand(*batch, 4)
    zs, ps = [], []
    for i in range(7):
        pos = pos + quat_rotate(rot, ot[i].expand(*batch, 3))
        rot = quat_mul(rot, oq[i].expand(*batch, 4))
        zs.append(quat_rotate(rot, ez.expand(*batch, 3)))
        ps.append(pos)
        half = q[..., i] * 0.5
        zero = torch.zeros_like(half)
        rot = quat_mul(rot, torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1))
    pos = pos + quat_rotate(rot, const(_HT, dev).expand(*batch, 3))
    rot = quat_mul(rot, const(_HQ, dev).expand(*batch, 4))
    return pos, quat_to_mat(rot), torch.stack(zs, dim=-2), torch.stack(ps, dim=-2)


def _rot_err_vec(R_hand, target_rot):
    """Scaled rotation-vector error of the hand rotation against the
    target, through the column identities (no 3x3 product)."""
    w = torch.linalg.cross(R_hand.transpose(-1, -2), target_rot.transpose(-1, -2),
                           dim=-1).sum(dim=-2)
    cos_t = torch.clamp((torch.sum(target_rot * R_hand, dim=(-2, -1)) - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    scale = torch.where(sin_t > 1e-6, theta / (2.0 * torch.clamp(sin_t, min=1e-6)), 0.5)
    return scale[..., None] * w


def _err_and_jacobian(q, target_pos, target_rot):
    """6-d task error and the analytic geometric jacobian (..., 6, 7)
    from one FK pass; the rotation rows carry the SO(3) right-Jacobian
    inverse, applied per column as
    Jr^-1 z = z + (r x z)/2 + c(theta) (r (r.z) - theta^2 z)."""
    p_e, R_hand, z, p = _fk_frames_fused(q)
    perr = target_pos - p_e
    r = _rot_err_vec(R_hand, target_rot)
    jv = torch.linalg.cross(z, p_e[..., None, :] - p, dim=-1)       # (..., 7, 3)
    th2 = torch.sum(r * r, dim=-1)
    th = torch.sqrt(th2)
    th_s = torch.clamp(th, min=1e-9)
    sin_t = torch.sin(th_s)
    coef = torch.where(
        (th > 1e-6) & (sin_t > 1e-6),
        1.0 / torch.clamp(th2, min=1e-18)
        - (1.0 + torch.cos(th_s)) / (2.0 * th_s * torch.clamp(sin_t, min=1e-9)),
        1.0 / 12.0,
    )[..., None, None]
    rb = r[..., None, :]
    jw = (z + 0.5 * torch.linalg.cross(rb.expand_as(z), z, dim=-1)
          + coef * (rb * torch.sum(z * rb, dim=-1, keepdim=True) - th2[..., None, None] * z))
    J = torch.cat([jv, jw], dim=-1).transpose(-1, -2)                # (..., 6, 7)
    return torch.cat([perr, r], dim=-1), J


def _chol_solve6(A, b):
    """Unrolled 6x6 SPD Cholesky solve in scalar ops; A (..., 6, 6),
    b (..., 6). A = J J^T + damping^2 I keeps the diagonal off zero."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _pose_error(q, target_pos, target_rot):
    p_e, R_hand, _, _ = _fk_frames_fused(q)
    return torch.cat([target_pos - p_e, _rot_err_vec(R_hand, target_rot)], dim=-1)


def dls_ik(seed_q, target_pos, target_rot, iters: int = 30, damping: float = 0.05):
    """Damped-least-squares IK, batched over leading axes: seed_q (..., 7),
    target_pos (..., 3), target_rot (..., 3, 3). Returns (q, pos_err,
    rot_err)."""
    lo, hi = const(panda.JOINT_LOWER, seed_q.device), const(panda.JOINT_UPPER, seed_q.device)
    eye = torch.eye(6, dtype=seed_q.dtype, device=seed_q.device) * (damping ** 2)
    q = seed_q
    for _ in range(iters):
        e, J = _err_and_jacobian(q, target_pos, target_rot)
        A = (J[..., :, None, :] * J[..., None, :, :]).sum(-1) + eye
        x = _chol_solve6(A, e)
        dq = (J * x[..., :, None]).sum(-2)
        q = torch.minimum(torch.maximum(q + dq, lo), hi)
    e = _pose_error(q, target_pos, target_rot)
    return (q, torch.linalg.vector_norm(e[..., :3], dim=-1),
            torch.linalg.vector_norm(e[..., 3:], dim=-1))


def ik_from_seeds(target_pos, target_rot, iters: int = 30, pos_tol: float = 5e-3,
                  rot_tol: float = 5e-2):
    """Multi-start IK over the anchor seeds for a batch of targets:
    target_pos (B, 3), target_rot (B, 3, 3) -> (q (B, 7), success (B,)).

    Every seed runs in parallel; the best (lowest pos + rot error, first
    on ties) wins (reference: env/panda_scene.py:809-818)."""
    seeds = const(panda.ANCHOR_SEEDS, target_pos.device)
    b, s = target_pos.shape[0], seeds.shape[0]
    qs, perr, rerr = dls_ik(
        seeds[None].expand(b, s, 7), target_pos[:, None].expand(b, s, 3),
        target_rot[:, None].expand(b, s, 3, 3), iters=iters)
    best = torch.argmin(perr + rerr, dim=1)
    rows = torch.arange(b, device=target_pos.device)
    ok = (perr[rows, best] < pos_tol) & (rerr[rows, best] < rot_tol)
    return qs[rows, best], ok
