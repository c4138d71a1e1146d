"""Contact geometry and forces for sphere sets against analytic
primitives (counterpart of gaddpg_tpu/physics/contact.py), batched over
a leading env axis.

The per-env contact model (physics/step.py) runs in two phases:

1. a geometry pass gives penetration, normal, contact point and the
   other surface's velocity for every (sphere, primitive) pair,
   concatenated into one flat contact array per env;
2. normal springs (with capped damping) and gravity give a predicted
   velocity, and friction is then applied as Jacobi impulses against
   that prediction.

Friction as impulses gives true stiction: an explicit Coulomb force on
the current velocity cannot hold a grasped object, since gravity
re-injects g*dt of slip every substep; impulses against the post-force
velocity cancel that drift up to the mu*Fn*dt cone bound.
"""

import math
from typing import NamedTuple

import torch

from gaddpg_tpu_torch.utils.constants import const


class Contacts(NamedTuple):
    """Flat contact arrays of B envs (C candidate contacts each)."""

    pen: torch.Tensor        # (B, C) penetration depth (<= 0 inactive)
    normal: torch.Tensor     # (B, C, 3) outward normal (pushes the body along +n)
    point: torch.Tensor      # (B, C, 3) world contact point
    surf_vel: torch.Tensor   # (B, C, 3) velocity of the other surface
    fn_scale: torch.Tensor   # (B, C) per-contact normal force cap


def clamp_passive_delta(dv, v, dv_max, eps=1e-9):
    """Constrain a contact-driven velocity delta to passive behaviour.

    Decomposed against the current velocity v: the braking component
    (along -v) may run to full reversal plus a dv_max margin, so an
    incoming object is always stopped, never tunnels; the
    speed-increasing components (along +v and perpendicular) are capped
    at dv_max per substep. Penalty springs backed by the position-servo
    arm are an unbounded energy source; this keeps a deep squeeze or
    table press from releasing as an ejection.

    Broadcasts over leading batch axes; the last axis is the vector.
    `dv_max` is a float or a tensor broadcasting against (..., 1).
    """
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v_hat = v / torch.clamp(vn, min=eps)
    along = torch.sum(dv * v_hat, dim=-1, keepdim=True)
    perp = dv - along * v_hat
    pn = torch.linalg.vector_norm(perp, dim=-1, keepdim=True)
    along_c = torch.minimum(torch.maximum(along, -(vn + dv_max)), torch.as_tensor(dv_max).to(along))
    perp_c = perp * torch.clamp(dv_max / torch.clamp(pn, min=eps), max=1.0)
    return along_c * v_hat + perp_c


def sphere_plane_contacts(centers, radii, plane_z, max_force=math.inf):
    """Spheres (B, N, 3) with radii (B, N) against the plane z = plane_z.
    Radius-0 padding spheres never contact: the half-space test would
    fire if the body's rotation swung a parked padding sphere below the
    table."""
    pen = torch.where(radii > 0, radii - (centers[..., 2] - plane_z), -1.0)
    n = const((0.0, 0.0, 1.0), centers.device).expand_as(centers)
    return Contacts(pen=pen, normal=n, point=centers - n * radii[..., None],
                    surf_vel=torch.zeros_like(centers),
                    fn_scale=torch.full_like(pen, max_force))


def box_sdf_normal(p, half_extents):
    """Signed distance and outward normal of an axis-aligned box at
    points p (..., 3). Inside, the normal is the sign of the nearest
    face's axis, written by index (no one-hot product)."""
    he = torch.as_tensor(half_extents, dtype=p.dtype).to(p.device)
    q = torch.abs(p) - he
    outside = torch.clamp(q, min=0.0)
    d_out = torch.linalg.vector_norm(outside, dim=-1)
    d_in = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    sdf = d_out + d_in
    sign = torch.sign(p)
    n_out = outside * sign
    n_out = n_out / torch.clamp(torch.linalg.vector_norm(n_out, dim=-1, keepdim=True), min=1e-9)
    n_in = axis_sign(q, sign)
    return sdf, torch.where((d_out > 0)[..., None], n_out, n_in)


def axis_sign(q, sign):
    """The vector that is `sign` on the axis of q's largest entry (the
    first on ties, as argmax) and 0 on the others, for q, sign (..., 3)."""
    axis = torch.argmax(q, dim=-1, keepdim=True)
    return torch.zeros_like(sign).scatter(-1, axis, torch.gather(sign, -1, axis))


def sphere_box_contacts(centers_w, radii, box_pose, half_extents, box_vel,
                        max_force=math.inf):
    """Spheres (B, N, 3), radii (B, N) against oriented boxes box_pose
    (B, 4, 4) moving with box_vel = (linear (B, 3), angular (B, 3))."""
    rot = box_pose[:, :3, :3]
    origin = box_pose[:, None, :3, 3]
    sdf, n_local = box_sdf_normal((centers_w - origin) @ rot, half_extents)
    pen = torch.where(radii > 0, radii - sdf, -1.0)  # padding spheres never contact
    n_world = n_local @ rot.transpose(-1, -2)
    pts = centers_w - n_world * radii[..., None]
    box_lin, box_ang = box_vel
    v_surf = box_lin[:, None, :] + torch.linalg.cross(box_ang[:, None, :].expand_as(pts),
                                                      pts - origin, dim=-1)
    return Contacts(pen=pen, normal=n_world, point=pts, surf_vel=v_surf,
                    fn_scale=torch.full_like(pen, max_force))


def concat_contacts(*contact_sets):
    """One flat contact array per env from several sets."""
    return Contacts(*[torch.cat([getattr(c, f) for c in contact_sets], dim=1)
                      for f in Contacts._fields])


def normal_forces(c: Contacts, body_vels, stiffness, damp_cap):
    """Spring plus impulse-capped damping along the normal, fn in [0,
    fn_scale]. body_vels (B, C, 3): the body's velocity at its contact
    points; damp_cap (B, C)."""
    active = c.pen > 0
    pen_c = torch.where(active, c.pen, 0.0)
    vn = torch.sum((body_vels - c.surf_vel) * c.normal, dim=-1)
    fn = stiffness * pen_c - damp_cap * vn * active
    return torch.minimum(torch.clamp(torch.clamp(fn, min=0.0) * active, min=0.0), c.fn_scale)


def quad_form(x, m, y):
    """x^T m y per contact: x, y (B, C, 3), m (B, 3, 3) -> (B, C)."""
    return torch.einsum("bci,bij,bcj->bc", x, m, y)


def friction_impulses(c: Contacts, fn, v_pred, w_pred, com, mass, inv_iw, mu, dt,
                      n_active, budget=None):
    """One Jacobi friction pass against the predicted velocity.

    Each contact removes at most its 1/n share of the predicted relative
    tangential velocity (with the directional effective mass
    w_t = 1/m + (r x t)^T I^-1 (r x t)), clamped to the remaining Coulomb
    budget (mu*fn*dt across all passes of a substep). v_pred, w_pred,
    com (B, 3); mass (B,); inv_iw (B, 3, 3); n_active (B,). Returns
    (d_linvel (B, 3), d_angvel (B, 3), new budget (B, C))."""
    r = c.point - com[:, None, :]
    v_rel = v_pred[:, None, :] + torch.linalg.cross(w_pred[:, None, :].expand_as(r), r,
                                                    dim=-1) - c.surf_vel
    vn = torch.sum(v_rel * c.normal, dim=-1, keepdim=True)
    vt = v_rel - vn * c.normal
    vt_norm = torch.linalg.vector_norm(vt, dim=-1)
    t_dir = vt / torch.clamp(vt_norm[..., None], min=1e-9)

    rxt = torch.linalg.cross(r, t_dir, dim=-1)
    w_t = 1.0 / mass[:, None] + quad_form(rxt, inv_iw, rxt)
    share = torch.clamp(n_active, min=1).to(vt_norm.dtype)[:, None]
    j_stick = vt_norm / (w_t * share)          # the impulse that zeroes the share of vt
    if budget is None:
        budget = mu * fn * dt                   # the full Coulomb bound
    j = torch.minimum(j_stick, budget) * (fn > 0)

    imp = -j[..., None] * t_dir                 # (B, C, 3) impulse on the body
    d_lin = torch.sum(imp, dim=1) / mass[:, None]
    d_ang = (inv_iw @ torch.sum(torch.linalg.cross(r, imp, dim=-1), dim=1)[..., None])[..., 0]
    return d_lin, d_ang, budget - j
