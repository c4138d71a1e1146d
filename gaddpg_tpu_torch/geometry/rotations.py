"""Batched SO(3) primitives (counterpart of gaddpg_tpu/geometry/rotations.py).

Quaternions (wxyz), sxyz euler angles and rotation matrices: what the
point-matching losses, the kinematics, the physics and the env use.
Every function broadcasts over leading batch axes. The matrix products
run in true float32: callers on the card wrap them in
`utils.precision.f32_matmuls`, since reduced
precision in geometry matmuls is what `utils/precision.py` records as
costly.
"""

import torch

from gaddpg_tpu_torch.utils.constants import const

_EPS = 1e-8
CONJ = (1.0, -1.0, -1.0, -1.0)


def quat_normalize(q):
    """Normalize quaternion(s) to unit length; zero-safe."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_mul(q1, q2):
    """Hamilton product q1*q2; both (..., 4) wxyz."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    """Conjugate (inverse for unit quaternions)."""
    return q * const(CONJ, q.device, q.dtype)


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4), wxyz,
    with the two-cross-product form (reference: core/utils.py:940-958)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (qw * uv + uuv)


def _stack3x3(entries):
    m = torch.stack(entries, dim=-1)
    return m.reshape(*m.shape[:-1], 3, 3)


def rot_x(a):
    """Rotation about x by angle a (...,) -> (..., 3, 3)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([o, z, z, z, c, -s, z, s, c])


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([c, z, s, z, o, z, -s, z, c])


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3x3([c, -s, z, s, c, z, z, z, o])


def euler_to_mat(e):
    """sxyz euler (..., 3) -> matrix R = Rz(ez) @ Ry(ey) @ Rx(ex)
    (transforms3d's default axes; reference: env/panda_scene.py:761)."""
    return rot_z(e[..., 2]) @ rot_y(e[..., 1]) @ rot_x(e[..., 0])


def quat_to_mat(q):
    """Unit quaternion(s) (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _stack3x3([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ])


def mat_to_quat(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz, w >= 0.

    Branch-free Shepperd's method: all four candidates, picked by the
    largest pivot (first on ties, as jnp.argmax)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cand = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1),
    ], dim=-1)  # (..., 4 candidates, 4 components)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def mat_to_euler(m):
    """Matrix (..., 3, 3) -> sxyz euler (..., 3); gimbal-safe."""
    cy = torch.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
    safe = cy > 1e-6
    ex = torch.where(safe, torch.atan2(m[..., 2, 1], m[..., 2, 2]),
                     torch.atan2(-m[..., 1, 2], m[..., 1, 1]))
    ey = torch.atan2(-m[..., 2, 0], cy)
    ez = torch.where(safe, torch.atan2(m[..., 1, 0], m[..., 0, 0]), 0.0)
    return torch.stack([ex, ey, ez], dim=-1)


def euler_to_quat(e):
    return mat_to_quat(euler_to_mat(e))


def axis_angle_to_quat(axis, angle):
    """Axis (..., 3, not necessarily unit) + angle (...,) -> quaternion
    (..., 4) wxyz."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=_EPS)
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_integrate(q, omega, dt):
    """Integrate unit quaternion(s) q (..., 4) by world-frame angular
    velocity omega (..., 3) over dt: normalize(q + 0.5 dt omega_q * q).
    Stable for the small per-substep rotations of the physics loop."""
    omega_q = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    return quat_normalize(q + 0.5 * dt * quat_mul(omega_q, q))
