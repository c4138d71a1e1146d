"""Multi-body batched physics: the target and K dynamic clutter bodies
per env (counterpart of gaddpg_tpu/physics/multi.py).

The reference steps every scene body in PyBullet, so obstacles react to
pushes, get knocked over and register robot-obstacle contact
(reference: env/panda_scene.py:354-387, 995-1035, 1078-1095). This module
generalises the single-object model of physics/fast.py to M = K + 1
free bodies per env:

- all per-body machinery (table and gripper-box contacts, spring
  normals with impulse-capped damping, cone-budgeted Jacobi friction
  passes, the passive-contact clamp, semi-implicit integration) runs
  with the body axis folded into the batch axis: (B, M) bodies are B*M
  independent rows sharing their env's hand trajectory, body 0 (the
  target) first in each env;
- the two couplings that cannot fold:
  1. the fingers: the penetration-limited finger servo feels pad
     penetration from every body of its env;
  2. object-object contact: penalty spring-damper forces between
     per-body coarse sphere sets (ObjectLibrary.coarse_spheres) with
     stiction-exact tangential friction capped by the Coulomb cone,
     computed as a full (M, M) antisymmetric tensor, so Newton's third
     law holds exactly.

Behaviour contract: with the clutter parked far away the target's
trajectory matches `fast_physics_step`; settled clutter stays put;
pushed clutter moves and can topple; gripper-clutter penetration raises
the collision event. The substep loop is plain PyTorch (the reference
has no kernel for it), a few hundred small ops per substep.
"""

import torch

from gaddpg_tpu_torch.geometry.rotations import CONJ, quat_mul, quat_normalize, quat_rotate
from gaddpg_tpu_torch.physics.contact import axis_sign, clamp_passive_delta
from gaddpg_tpu_torch.physics.fast import hand_trajectory
from gaddpg_tpu_torch.physics.types import BodyState, PhysicsParams, PhysicsState
from gaddpg_tpu_torch.utils.constants import const
from gaddpg_tpu_torch.utils.precision import f32_matmuls


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _pair_forces(p: PhysicsParams, pos, quat, linvel, angvel, coarse, mass, inertia):
    """Object-object contact forces between coarse sphere sets.

    pos, quat, linvel, angvel (B, M, ...) body states; coarse (B, M, NC, 4)
    object-frame spheres (radius 0 = padding); mass (B, M); inertia
    (B, M, 3). Returns per-body force and torque (B, M, 3). Entry (i, j)
    of the pair tensor is the force on i from j; the formula is odd under
    i <-> j, so the sum conserves momentum.

    Stability comes from a pair-level impulse cap instead of the per-body
    passive clamp (which is asymmetric and would destroy momentum in
    impacts): the normal force may brake the pair's relative approach
    completely but may push their separation speed up to
    obj_obj_sep_vmax only. The cap scales a per-pair force, the same on
    both bodies, so Newton's third law survives it.
    """
    dev = pos.device
    rc = coarse[..., 3]                                            # (B, M, NC)
    cw = pos[:, :, None, :] + quat_rotate(quat[:, :, None, :], coarse[..., :3])
    # sphere-pair geometry: i on axes (1, 3), j on axes (2, 4)
    d = cw[:, :, None, :, None, :] - cw[:, None, :, None, :, :]    # (B, M, M, NC, NC, 3)
    dist = torch.linalg.vector_norm(d, dim=-1)
    nrm = d / torch.clamp(dist, min=1e-9)[..., None]
    pen = (rc[:, :, None, :, None] + rc[:, None, :, None, :]) - dist

    m = pos.shape[1]
    not_self = ~torch.eye(m, dtype=torch.bool, device=dev)[None, :, :, None, None]
    live = (rc[:, :, None, :, None] > 0) & (rc[:, None, :, None, :] > 0)
    active = (pen > 0) & not_self & live
    pen_c = torch.where(active, pen, 0.0)

    # contact point: mid-penetration between the two sphere surfaces
    cp = cw[:, :, None, :, None, :] - nrm * (rc[:, :, None, :, None, None]
                                              - 0.5 * pen_c[..., None])
    # surface velocities of both bodies at the contact point
    r_i = cp - pos[:, :, None, None, None, :]
    r_j = cp - pos[:, None, :, None, None, :]
    v_i = linvel[:, :, None, None, None, :] + _cross(angvel[:, :, None, None, None, :], r_i)
    v_j = linvel[:, None, :, None, None, :] + _cross(angvel[:, None, :, None, None, :], r_j)
    v_rel = v_i - v_j
    vn = torch.sum(v_rel * nrm, dim=-1)

    # impulse-capped damping (an explicit damper above 2/(dt w_pair) pumps
    # the pair's rocking mode)
    inv_m = 1.0 / mass
    w_pair = inv_m[:, :, None, None, None] + inv_m[:, None, :, None, None]
    n_active_pair = torch.sum(active, dim=(3, 4))                 # (B, M, M)
    share = torch.clamp(n_active_pair, min=1)[..., None, None].to(pen_c.dtype)
    damp = 0.9 / (p.dt * w_pair * share)
    fn = p.contact_stiffness * pen_c - damp * vn * active

    # pair impulse cap: brake the relative approach to zero, push the
    # separation up to obj_obj_sep_vmax (an absolute ceiling, so
    # penetration relaxes at a bounded speed however long it lasts)
    dv_allow = torch.clamp(-vn, min=0.0) + torch.clamp(
        p.obj_obj_sep_vmax - torch.clamp(vn, min=0.0), min=0.0)
    f_cap = dv_allow / (p.dt * w_pair * share)
    fn = torch.minimum(fn, f_cap)
    fn = torch.clamp(torch.clamp(fn, min=0.0) * active, 0.0, p.obj_obj_max_force)

    vt = v_rel - vn[..., None] * nrm
    vt_n = torch.linalg.vector_norm(vt, dim=-1)
    # stiction-exact tangential pass: the force brakes the relative slide
    # to zero within the substep when the Coulomb budget allows, with the
    # pair's effective inverse mass along the slide, rotation included
    t_dir = vt / torch.clamp(vt_n, min=1e-9)[..., None]
    q_conj = quat * const(CONJ, dev)
    rxt_i = quat_rotate(q_conj[:, :, None, None, None, :], _cross(r_i, t_dir))
    rxt_j = quat_rotate(q_conj[:, None, :, None, None, :], _cross(r_j, t_dir))
    inv_i = 1.0 / inertia
    w_rot = (torch.sum(rxt_i ** 2 * inv_i[:, :, None, None, None, :], dim=-1)
             + torch.sum(rxt_j ** 2 * inv_i[:, None, :, None, None, :], dim=-1))
    f_stick = 0.9 * vt_n / (p.dt * (w_pair + w_rot) * share)
    ft_mag = torch.minimum(f_stick, p.friction_mu * fn)
    f_pair = fn[..., None] * nrm - ft_mag[..., None] * (
        vt / torch.clamp(vt_n, min=1e-9)[..., None])

    force = torch.sum(f_pair, dim=(2, 3, 4))                       # (B, M, 3)
    torque = torch.sum(_cross(r_i, f_pair), dim=(2, 3, 4))

    # pair rolling stiction: coarse-sphere proxies make every contact a
    # point contact with no rolling resistance; real faces resist rolling
    # with a torque up to mu * N * patch radius, applied as an
    # equal-and-opposite brake on the pair's relative angular velocity
    w_rel = angvel[:, :, None, :] - angvel[:, None, :, :]          # (B, M, M, 3)
    wn_rel = torch.linalg.vector_norm(w_rel, dim=-1)
    inv_i_max = torch.amax(inv_i, dim=-1)
    inv_i_pair = inv_i_max[:, :, None] + inv_i_max[:, None, :]    # (B, M, M)
    tau_stick = 0.9 * wn_rel / (p.dt * torch.clamp(inv_i_pair, min=1e-9))
    fn_sum = torch.sum(fn, dim=(3, 4))                             # (B, M, M)
    tau_budget = p.friction_mu * fn_sum * p.obj_obj_roll_patch
    tau_mag = torch.minimum(tau_stick, tau_budget)
    tau_roll = -tau_mag[..., None] * (w_rel / torch.clamp(wn_rel, min=1e-9)[..., None])
    return force, torque + torch.sum(tau_roll, dim=2)


@f32_matmuls
def multi_physics_step(p: PhysicsParams, state: PhysicsState, spheres, coarse, mass, inertia,
                       clutter: BodyState, substeps=None):
    """Advance B envs' arm and M = K + 1 free bodies by `substeps` ticks.

    state: PhysicsState of B envs, the arm and the target (body 0);
    clutter: BodyState with (B, K, ...) fields, bodies 1..K; spheres
    (B, M, NS, 4), coarse (B, M, NC, 4), mass (B, M), inertia (B, M, 3):
    each body's contact geometry and dynamics, body 0 first.

    Returns (new PhysicsState, new clutter BodyState, clutter_hit (B,)),
    clutter_hit: a clutter body penetrated a gripper box during the step
    (the reference's robot-obstacle collision event)."""
    n = substeps if substeps is not None else p.substeps
    b, m = mass.shape
    bm = b * m
    k_clutter = m - 1
    arm, obj = state.arm, state.obj
    dev = mass.device

    # ---- the arm's trajectory and hand poses and velocities (as fast.py) ----
    q_traj, qd_final, hand = hand_trajectory(p, arm, n)
    # every body of an env shares its hand: body 0 first in each env
    hand = hand.repeat_interleave(m, dim=1)                        # (n, BM, 13)

    # ---- fold the bodies into the batch axis ----
    def fold(t, c):
        return torch.cat([t[:, None], c], dim=1).reshape(bm, *t.shape[1:])

    pos, quat = fold(obj.pos, clutter.pos), fold(obj.quat, clutter.quat)
    linvel, angvel = fold(obj.linvel, clutter.linvel), fold(obj.angvel, clutter.angvel)

    sph_local = spheres[..., :3].reshape(bm, -1, 3)
    radii = spheres[..., 3].reshape(bm, -1)
    ns = radii.shape[1]
    mass_c = mass.reshape(bm)[:, None]
    inertia_bm = inertia.reshape(bm, 3)
    inv_inertia = 1.0 / inertia_bm

    fhe = p.finger_half_extents
    half_ext = const((fhe, fhe, p.palm_half_extents), dev)         # (3, 3)
    fn_clamp = torch.cat([torch.full((bm, ns), p.table_max_force, device=dev),
                          torch.full((bm, 2 * ns), 2.0 * p.finger_force, device=dev),
                          torch.full((bm, ns), p.palm_max_force, device=dev)], dim=1)
    off_p = const(p.palm_center, dev).expand(bm, 3)
    dvw_caps = const(((p.contact_dv_max,), (p.contact_dw_max,)), dev)
    conj = const(CONJ, dev)
    up = const((0.0, 0.0, 1.0), dev)
    real = radii > 0
    zeros_bm = torch.zeros(bm, device=dev)
    z_center = torch.full((bm,), p.finger_z_center, device=dev)
    not_table = torch.arange(4 * ns, device=dev) >= ns

    q_f = arm.q[:, 7:9]
    tgt_f = arm.q_target[:, 7:9]
    grip_any = torch.zeros(b, dtype=torch.bool, device=dev)
    clut_any = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(n):
        h_pos, h_quat, h_lin, h_ang = hand[t].split((3, 4, 3, 3), dim=-1)   # (BM, ...)
        centers = pos[:, None, :] + quat_rotate(quat[:, None, :], sph_local)

        # ---- gripper boxes (the fingers are per env: expand to BM) ----
        q_f_b = q_f.repeat_interleave(m, dim=0)                    # (BM, 2)
        off_l = torch.stack([zeros_bm, q_f_b[:, 0] + fhe[1], z_center], dim=-1)
        off_r = torch.stack([zeros_bm, -(q_f_b[:, 1] + fhe[1]), z_center], dim=-1)
        box_off = torch.stack([off_l, off_r, off_p], dim=1)        # (BM, 3, 3)
        box_t = h_pos[:, None, :] + quat_rotate(h_quat[:, None, :], box_off)

        hq_c = h_quat * conj
        c_hand = quat_rotate(hq_c[:, None, :], centers - h_pos[:, None, :])
        p_loc = c_hand[:, None, :, :] - box_off[:, :, None, :]     # (BM, 3, NS, 3)

        qd_box = torch.abs(p_loc) - half_ext[None, :, None, :]
        outside = torch.clamp(qd_box, min=0.0)
        d_out = torch.linalg.vector_norm(outside, dim=-1)
        d_in = torch.clamp(torch.amax(qd_box, dim=-1), max=0.0)
        sdf = d_out + d_in
        sign = torch.sign(p_loc)
        n_out = outside * sign
        n_out = n_out / torch.clamp(torch.linalg.vector_norm(n_out, dim=-1, keepdim=True),
                                    min=1e-9)
        n_loc = torch.where((d_out > 0)[..., None], n_out, axis_sign(qd_box, sign))
        n_box = quat_rotate(h_quat[:, None, None, :], n_loc)
        # radius-0 padding spheres never contact (as fast.py)
        pen_box = torch.where(real[:, None, :], radii[:, None, :] - sdf, -1.0)

        cpts_box = centers[:, None, :, :] - n_box * radii[:, None, :, None]
        v_box = h_lin[:, None, None, :] + _cross(h_ang[:, None, None, :],
                                                 cpts_box - box_t[:, :, None, :])

        # ---- the table plane ----
        pen_tab = torch.where(real, radii - (centers[..., 2] - p.table_z), -1.0)
        n_tab = up.expand_as(centers)
        cpts_tab = centers - n_tab * radii[..., None]

        pen = torch.cat([pen_tab, pen_box.reshape(bm, 3 * ns)], dim=1)
        nrm = torch.cat([n_tab, n_box.reshape(bm, 3 * ns, 3)], dim=1)
        cpts = torch.cat([cpts_tab, cpts_box.reshape(bm, 3 * ns, 3)], dim=1)
        v_surf = torch.cat([torch.zeros_like(cpts_tab), v_box.reshape(bm, 3 * ns, 3)], dim=1)

        active = pen > 0
        pen_c = torch.where(active, pen, 0.0)
        n_active = torch.sum(active, dim=1)
        share = torch.clamp(n_active, min=1).to(pen.dtype)[:, None]

        r_c = cpts - pos[:, None, :]
        v_rel = linvel[:, None, :] + _cross(angvel[:, None, :], r_c) - v_surf
        q_c = quat * conj

        def inv_mass_along(d):
            rxd_b = quat_rotate(q_c[:, None, :], _cross(r_c, d))
            return 1.0 / mass_c + torch.sum(rxd_b ** 2 * inv_inertia[:, None, :], dim=-1)

        w_n = inv_mass_along(nrm)
        damp_cap = 0.9 / (w_n * share * p.dt)
        vn = torch.sum(v_rel * nrm, dim=-1)
        fn = p.contact_stiffness * pen_c - damp_cap * vn * active
        fn = torch.minimum(torch.clamp(fn, min=0.0) * active, fn_clamp)

        f_n = fn[..., None] * nrm
        f_contact = torch.sum(f_n, dim=1)
        torque = torch.sum(_cross(r_c, f_n), dim=1)

        # the arm and table deltas go through the asymmetric passive clamp
        # (the arm servo is an energy source); the object-object forces are
        # pair-capped in _pair_forces and added after the clamp, so momentum
        # transfer between bodies is never clipped on one side
        dw_body = p.dt * quat_rotate(q_c, torque) * inv_inertia
        w_body = quat_rotate(q_c, angvel)
        d_pair = clamp_passive_delta(torch.stack([p.dt * f_contact / mass_c, dw_body], dim=1),
                                     torch.stack([linvel, w_body], dim=1), dvw_caps)
        dv_c, dw_c_body = d_pair[:, 0], d_pair[:, 1]

        if k_clutter > 0:
            f_oo, tau_oo = _pair_forces(
                p, pos.reshape(b, m, 3), quat.reshape(b, m, 4), linvel.reshape(b, m, 3),
                angvel.reshape(b, m, 3), coarse, mass, inertia)
            dv_c = dv_c + p.dt * f_oo.reshape(bm, 3) / mass_c
            dw_c_body = dw_c_body + p.dt * quat_rotate(q_c, tau_oo.reshape(bm, 3)) * inv_inertia

        gyro_b = _cross(w_body, inertia_bm * w_body)
        v_pred = linvel + dv_c
        v_pred = torch.cat([v_pred[:, :2], v_pred[:, 2:] + p.dt * p.gravity], dim=1)
        w_pred = angvel + quat_rotate(quat, dw_c_body - p.dt * gyro_b * inv_inertia)

        # ---- friction impulse passes (the structure of fast.py) ----
        budget = p.friction_mu * fn * p.dt
        have = fn > 0

        v_cc = v_pred[:, None, :] + _cross(w_pred[:, None, :], r_c) - v_surf
        vn_c = torch.sum(v_cc * nrm, dim=-1, keepdim=True)
        vt = v_cc - vn_c * nrm
        vt_n = torch.linalg.vector_norm(vt, dim=-1)
        t_dir = vt / torch.clamp(vt_n[..., None], min=1e-9)
        w_t = inv_mass_along(t_dir)

        def apply_impulse(v, w, j):
            imp = -j[..., None] * t_dir
            dv = torch.sum(imp, dim=1) / mass_c
            tau_i = quat_rotate(q_c, torch.sum(_cross(r_c, imp), dim=1))
            return v + dv, w + quat_rotate(quat, tau_i * inv_inertia)

        j1 = torch.minimum(vt_n / (w_t * share), budget) * have
        v_out, w_out = apply_impulse(v_pred, w_pred, j1)
        budget = budget - j1
        for _ in range(max(p.friction_iters - 1, 0)):
            v_cc2 = v_out[:, None, :] + _cross(w_out[:, None, :], r_c) - v_surf
            vt_along = torch.sum(v_cc2 * t_dir, dim=-1)
            j2 = torch.minimum(torch.clamp(vt_along / (w_t * share), min=0.0), budget) * have
            v_out, w_out = apply_impulse(v_out, w_out, j2)
            budget = budget - j2

        # rigid-set translational stiction (as fast.py): linear slip only
        v_lin3 = v_out[:, None, :] - v_surf
        vn3 = torch.sum(v_lin3 * nrm, dim=-1, keepdim=True)
        vt3 = (v_lin3 - vn3 * nrm) * have[..., None]
        fn_sum = torch.sum(fn, dim=1, keepdim=True)
        vbar = torch.sum(fn[..., None] * vt3, dim=1) / torch.clamp(fn_sum, min=1e-9)
        vbar_n = torch.linalg.vector_norm(vbar, dim=-1, keepdim=True)
        pool = torch.sum(budget, dim=1, keepdim=True)
        scale = torch.clamp(pool / torch.clamp(mass_c * vbar_n, min=1e-9), max=1.0)
        v_out = v_out - vbar * scale * (fn_sum > 0)

        # torsional (spinning) friction (as fast.py)
        if p.torsion_patch_radius > 0:
            w_surf_ang = torch.cat([torch.zeros(bm, ns, 3, device=dev),
                                    h_ang[:, None, :].expand(bm, 3 * ns, 3)], dim=1)
            s_rel = torch.sum((w_out[:, None, :] - w_surf_ang) * nrm, dim=-1)
            n_b = quat_rotate(q_c[:, None, :], nrm)
            w_rot = torch.sum(n_b ** 2 * inv_inertia[:, None, :], dim=-1)
            l_cap = p.friction_mu * p.torsion_patch_radius * fn * p.dt
            lj = torch.minimum(torch.maximum(s_rel / (w_rot * share), -l_cap), l_cap) * have
            dl_b = torch.sum(n_b * (-lj)[..., None], dim=1)
            w_out = w_out + quat_rotate(quat, dl_b * inv_inertia)

        # aggregate rotational stiction over the pad contacts (as fast.py;
        # PhysicsParams.pad_rot_stiction)
        if p.pad_rot_stiction:
            pad_have = have & not_table                            # the table excluded
            w_rel = (w_out[:, None, :] - h_ang[:, None, :]) * pad_have[..., None]
            fnp = fn * pad_have
            fnp_sum = torch.sum(fnp, dim=1, keepdim=True)
            wbar = torch.sum(fnp[..., None] * w_rel, dim=1) / torch.clamp(fnp_sum, min=1e-9)
            lever = torch.linalg.vector_norm(r_c, dim=-1) + p.torsion_patch_radius
            pool_ang = torch.sum(p.friction_mu * fnp * lever * p.dt, dim=1, keepdim=True)
            wbar_b = quat_rotate(q_c, wbar)
            l_need = torch.linalg.vector_norm(inertia_bm * wbar_b, dim=-1, keepdim=True)
            scale_a = torch.clamp(pool_ang / torch.clamp(l_need, min=1e-9), max=1.0)
            w_out = w_out - wbar * scale_a * (fnp_sum > 0)

        linvel = torch.clamp(v_out / (1.0 + p.linear_damping * p.dt), -p.max_linvel, p.max_linvel)
        angvel = torch.clamp(w_out / (1.0 + p.angular_damping * p.dt), -p.max_angvel,
                             p.max_angvel)
        pos = pos + p.dt * linvel
        w_q = torch.cat([torch.zeros(bm, 1, device=dev), angvel], dim=-1)
        quat = quat_normalize(quat + 0.5 * p.dt * quat_mul(w_q, quat))

        # ---- fingers: squeezed by every body's pad penetration ----
        pen_pads = pen_box.reshape(b, m, 3, ns)[:, :, :2]          # (B, M, 2, NS)
        pen_pads = torch.where(pen_pads > 0, pen_pads, 0.0)
        step_lim = p.finger_vel_limit * p.dt
        k = p.contact_stiffness
        f_pad = k * torch.sum(pen_pads, dim=(1, 3))                # (B, 2)
        n_pad = torch.sum(pen_pads > 0, dim=(1, 3)).to(q_f.dtype)
        if p.finger_gear_coupling:
            # the gear-coupled pair (PhysicsParams.finger_gear_coupling)
            s = torch.mean(q_f, dim=-1, keepdim=True)
            tgt_s = torch.mean(tgt_f, dim=-1, keepdim=True)
            s_cand = s + torch.clamp(tgt_s - s, -step_lim, step_lim)
            f_tot = torch.sum(f_pad, dim=-1, keepdim=True)
            n_tot = torch.sum(n_pad, dim=-1, keepdim=True)
            floor = s + torch.clamp((f_tot - 2.0 * p.finger_force)
                                    / (k * torch.clamp(n_tot, min=1.0)), -step_lim, step_lim)
            s_new = torch.clamp(torch.maximum(s_cand, floor), 0.0, 0.04)
            q_f = s_new.expand(b, 2)
        else:
            qf_cand = q_f + torch.clamp(tgt_f - q_f, -step_lim, step_lim)
            floor = q_f + torch.clamp((f_pad - p.finger_force)
                                      / (k * torch.clamp(n_pad, min=1.0)), -step_lim, step_lim)
            q_f = torch.clamp(torch.maximum(qf_cand, floor), 0.0, 0.04)

        pen_bm = torch.any((pen_box > 0).reshape(bm, -1), dim=1).reshape(b, m)
        grip_any = grip_any | pen_bm[:, 0]
        if k_clutter > 0:
            clut_any = clut_any | torch.any(pen_bm[:, 1:], dim=1)

    def unfold(a):
        return a.reshape(b, m, *a.shape[1:])

    pos_u, quat_u, lin_u, ang_u = unfold(pos), unfold(quat), unfold(linvel), unfold(angvel)
    new_state = PhysicsState(
        arm=type(arm)(q=torch.cat([q_traj[-1], q_f], dim=-1), qd=qd_final,
                      q_target=arm.q_target),
        obj=type(obj)(pos=pos_u[:, 0], quat=quat_u[:, 0], linvel=lin_u[:, 0],
                      angvel=ang_u[:, 0]),
        contact_force=torch.zeros(b, device=dev),
        gripper_contact=grip_any,
    )
    new_clutter = BodyState(pos=pos_u[:, 1:], quat=quat_u[:, 1:], linvel=lin_u[:, 1:],
                            angvel=ang_u[:, 1:])
    return new_state, new_clutter, clut_any
