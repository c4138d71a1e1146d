"""Batched SO(3) primitives (counterpart of part of gaddpg_tpu/geometry/rotations.py).

Only what the point-matching losses need: quaternion rotation (wxyz)
and sxyz euler angles to matrices. Every function broadcasts over
leading batch axes. The matrix products run in true float32: callers on
the card wrap them in `utils.precision.f32_matmuls`, since reduced
precision in geometry matmuls is what `utils/precision.py` records as
costly.
"""

import torch


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
