"""The per-env contact model: one substep and the policy step's substep
loop (counterpart of gaddpg_tpu/physics/step.py), batched over B envs.

Substep structure (physics/contact.py says why friction is an impulse
pass):

1. arm position servo (rate limited) -> new hand pose and velocity
2. contact geometry for the table, the finger pads and the palm as one
   flat array
3. normal spring forces and gravity -> predicted velocity
4. friction Jacobi impulses against the predicted velocity (stiction)
5. integrate the object pose; penetration-limited finger closing

This is the readable form of the model, with rotation matrices; the env
steps it through `PandaGraspEnv.step` / `retract`. `physics/fast.py`
runs the same model restructured for throughput (K7 on the card) and
`physics/multi.py` generalises it to clutter bodies.
"""

import torch

from gaddpg_tpu_torch.geometry.rotations import quat_integrate, quat_to_mat
from gaddpg_tpu_torch.physics.contact import (
    clamp_passive_delta, concat_contacts, friction_impulses, normal_forces, quad_form,
    sphere_box_contacts, sphere_plane_contacts,
)
from gaddpg_tpu_torch.physics.types import PhysicsParams, PhysicsState
from gaddpg_tpu_torch.robot.panda import fk_hand
from gaddpg_tpu_torch.utils.constants import const
from gaddpg_tpu_torch.utils.precision import f32_matmuls


def _rot_delta_to_omega(r_new, r_old, dt):
    """Angular velocity (B, 3) from consecutive rotation matrices (B, 3, 3)
    (small angle)."""
    d = r_new @ r_old.transpose(-1, -2)
    w = torch.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0],
                     d[:, 1, 0] - d[:, 0, 1]], dim=-1) * 0.5
    return w / dt


def _finger_box_pose(hand, side, q_f, p: PhysicsParams):
    """World poses (B, 4, 4) of a finger-pad box; side +1 left (+y), -1
    right; q_f (B,) the finger's opening."""
    t = torch.eye(4, device=hand.device).repeat(hand.shape[0], 1, 1)
    t[:, 1, 3] = side * (q_f + p.finger_half_extents[1])
    t[:, 2, 3] = p.finger_z_center
    return hand @ t


def gripper_box_poses(hand, q_l, q_r, p: PhysicsParams):
    """World poses (B, 4, 4) of the three gripper collision boxes (left
    finger, right finger, palm), shared by contact resolution and the
    camera's analytic occluders."""
    palm = torch.eye(4, device=hand.device)
    palm[:3, 3] = const(p.palm_center, hand.device)
    return (_finger_box_pose(hand, 1.0, q_l, p), _finger_box_pose(hand, -1.0, q_r, p),
            hand @ palm)


def hand_pose(q, base_pose=None):
    """The hand's world pose (B, 4, 4) from arm joints q (B, 7), the base at
    `base_pose` (4, 4) (None: the world origin)."""
    hand = fk_hand(q)
    return hand if base_pose is None else base_pose @ hand


def physics_substep(p: PhysicsParams, state: PhysicsState, sphere_set, mass, inertia_diag,
                    base_pose=None) -> PhysicsState:
    """One substep of B envs: sphere_set (B, ns, 4), mass (B,),
    inertia_diag (B, 3), base_pose (4, 4) or None."""
    arm, obj = state.arm, state.obj
    dev = mass.device
    b = mass.shape[0]

    # ---- arm servo: trapezoidal (velocity and acceleration limited) ----
    # an instant jump to the velocity limit demands a friction impulse the
    # grasp cone cannot supply within one substep: acceleration-limited
    # ramps keep it inside the cone
    err = arm.q_target[:, :7] - arm.q[:, :7]
    v_brake = torch.sqrt(2.0 * p.arm_acc_limit * torch.abs(err))
    v_des = torch.sign(err) * torch.clamp(v_brake, max=p.arm_vel_limit)
    qd = torch.minimum(torch.maximum(v_des, arm.qd - p.arm_acc_limit * p.dt),
                       arm.qd + p.arm_acc_limit * p.dt)
    q_arm = arm.q[:, :7] + qd * p.dt
    hand_prev = hand_pose(arm.q[:, :7], base_pose)
    hand = hand_pose(q_arm, base_pose)
    hand_lin = (hand[:, :3, 3] - hand_prev[:, :3, 3]) / p.dt
    hand_ang = _rot_delta_to_omega(hand[:, :3, :3], hand_prev[:, :3, :3], p.dt)
    box_vel = (hand_lin, hand_ang)

    # ---- object spheres in the world ----
    r_obj = quat_to_mat(obj.quat)
    centers = obj.pos[:, None, :] + sphere_set[..., :3] @ r_obj.transpose(-1, -2)
    radii = sphere_set[..., 3]
    r_t = r_obj.transpose(-1, -2)
    inv_iw = r_obj @ torch.diag_embed(1.0 / inertia_diag) @ r_t

    # ---- contact geometry (one flat array per env) ----
    pose_l, pose_r, palm_pose = gripper_box_poses(hand, arm.q[:, 7], arm.q[:, 8], p)
    c_table = sphere_plane_contacts(centers, radii, p.table_z, max_force=p.table_max_force)
    c_l = sphere_box_contacts(centers, radii, pose_l, p.finger_half_extents, box_vel,
                              max_force=2.0 * p.finger_force)
    c_r = sphere_box_contacts(centers, radii, pose_r, p.finger_half_extents, box_vel,
                              max_force=2.0 * p.finger_force)
    c_palm = sphere_box_contacts(centers, radii, palm_pose, p.palm_half_extents, box_vel,
                                 max_force=p.palm_max_force)
    contacts = concat_contacts(c_table, c_l, c_r, c_palm)
    ns = sphere_set.shape[1]
    n_active = torch.sum(contacts.pen > 0, dim=1)

    # ---- normal forces and gravity -> predicted velocity ----
    r_pts = contacts.point - obj.pos[:, None, :]
    v_pts = obj.linvel[:, None, :] + torch.linalg.cross(
        obj.angvel[:, None, :].expand_as(r_pts), r_pts, dim=-1)
    # normal damping capped at the velocity-zeroing share
    rxn = torch.linalg.cross(r_pts, contacts.normal, dim=-1)
    w_n = 1.0 / mass[:, None] + quad_form(rxn, inv_iw, rxn)
    damp_cap = 0.9 / (w_n * torch.clamp(n_active, min=1)[:, None] * p.dt)
    fn = normal_forces(contacts, v_pts, p.contact_stiffness, damp_cap)

    f_normal = fn[..., None] * contacts.normal
    f_contact = torch.sum(f_normal, dim=1)
    torque = torch.sum(torch.linalg.cross(r_pts, f_normal, dim=-1), dim=1)
    # the passive-contact caps (PhysicsParams.contact_dv_max): braking up to
    # full reversal is free, speed gain is capped
    dv_c = clamp_passive_delta(p.dt * f_contact / mass[:, None], obj.linvel, p.contact_dv_max)
    dw_c = clamp_passive_delta(p.dt * (inv_iw @ torque[..., None])[..., 0], obj.angvel,
                               p.contact_dw_max)

    i_world = r_obj @ torch.diag_embed(inertia_diag) @ r_t
    gyro = torch.linalg.cross(obj.angvel, (i_world @ obj.angvel[..., None])[..., 0], dim=-1)
    gravity = const((0.0, 0.0, p.gravity), dev)
    v_pred = obj.linvel + dv_c + p.dt * gravity
    w_pred = obj.angvel + dw_c - p.dt * (inv_iw @ gyro[..., None])[..., 0]
    total_f = f_contact + const((0.0, 0.0, p.gravity), dev) * mass[:, None]

    # ---- friction impulse passes (stiction against the predicted velocity) ----
    # Jacobi with 1/n shares removes ~90% of the tangential velocity per
    # pass; iterating drives the residual slip to ~0 so grasps hold
    v_out, w_out, budget = v_pred, w_pred, p.friction_mu * fn * p.dt
    for _ in range(p.friction_iters):
        d_lin, d_ang, budget = friction_impulses(
            contacts, fn, v_out, w_out, obj.pos, mass, inv_iw, p.friction_mu, p.dt, n_active,
            budget=budget)
        v_out, w_out = v_out + d_lin, w_out + d_ang

    # rigid-set translational stiction (see fast.py): one aggregate impulse
    # stops the fn-weighted mean linear slip, bounded by the pooled
    # remaining Coulomb budget
    have = fn > 0
    v_lin3 = v_out[:, None, :] - contacts.surf_vel
    vn3 = torch.sum(v_lin3 * contacts.normal, dim=-1, keepdim=True)
    vt3 = (v_lin3 - vn3 * contacts.normal) * have[..., None]
    fn_sum = torch.sum(fn, dim=1)
    vbar = torch.sum(fn[..., None] * vt3, dim=1) / torch.clamp(fn_sum, min=1e-9)[:, None]
    vbar_n = torch.linalg.vector_norm(vbar, dim=-1)
    pool = torch.sum(budget, dim=1)
    scale = torch.clamp(pool / torch.clamp(mass * vbar_n, min=1e-9), max=1.0)
    v_out = v_out - vbar * (scale * (fn_sum > 0))[:, None]

    # torsional (spinning) friction about each contact normal
    # (PhysicsParams.torsion_patch_radius)
    share_t = torch.clamp(n_active, min=1)[:, None]
    if p.torsion_patch_radius > 0:
        w_surf_ang = torch.cat([torch.zeros(b, ns, 3, device=dev),
                                hand_ang[:, None, :].expand(b, 3 * ns, 3)], dim=1)
        s_rel = torch.sum((w_out[:, None, :] - w_surf_ang) * contacts.normal, dim=-1)
        w_rot = quad_form(contacts.normal, inv_iw, contacts.normal)
        l_cap = p.friction_mu * p.torsion_patch_radius * fn * p.dt
        lj = torch.minimum(torch.maximum(s_rel / (w_rot * share_t), -l_cap), l_cap) * have
        w_out = w_out - (inv_iw @ torch.sum(contacts.normal * lj[..., None], dim=1)[..., None]
                         )[..., 0]

    # aggregate rotational stiction over the pad contacts
    # (PhysicsParams.pad_rot_stiction); table contacts excluded so free
    # rolling is untouched
    if p.pad_rot_stiction:
        nc = contacts.pen.shape[1]
        pad_have = have & (torch.arange(nc, device=dev) >= ns)
        w_rel = (w_out[:, None, :] - hand_ang[:, None, :]) * pad_have[..., None]
        fnp = fn * pad_have
        fnp_sum = torch.sum(fnp, dim=1)
        wbar = torch.sum(fnp[..., None] * w_rel, dim=1) / torch.clamp(fnp_sum, min=1e-9)[:, None]
        lever = torch.linalg.vector_norm(r_pts, dim=-1) + p.torsion_patch_radius
        pool_ang = torch.sum(p.friction_mu * fnp * lever * p.dt, dim=1)
        l_need = torch.linalg.vector_norm((i_world @ wbar[..., None])[..., 0], dim=-1)
        scale_a = torch.clamp(pool_ang / torch.clamp(l_need, min=1e-9), max=1.0)
        w_out = w_out - wbar * (scale_a * (fnp_sum > 0))[:, None]

    linvel = v_out / (1.0 + p.linear_damping * p.dt)
    angvel = w_out / (1.0 + p.angular_damping * p.dt)
    linvel = torch.clamp(linvel, -p.max_linvel, p.max_linvel)
    angvel = torch.clamp(angvel, -p.max_angvel, p.max_angvel)
    pos = obj.pos + p.dt * linvel
    quat = quat_integrate(obj.quat, angvel, p.dt)

    # ---- fingers: penetration-limited quasi-static servo ----
    # the finger tracks its target at the velocity limit but the pad spring
    # force may not exceed finger_force: the steady grip force equals
    # finger_force, monotone, no chatter
    pen_l = torch.where(c_l.pen > 0, c_l.pen, 0.0)
    pen_r = torch.where(c_r.pen > 0, c_r.pen, 0.0)
    q_f = arm.q[:, 7:9]
    step_lim = p.finger_vel_limit * p.dt
    k = p.contact_stiffness
    f_pad = torch.stack([k * torch.sum(pen_l, dim=1), k * torch.sum(pen_r, dim=1)], dim=-1)
    n_pad = torch.stack([torch.sum(pen_l > 0, dim=1), torch.sum(pen_r > 0, dim=1)],
                        dim=-1).to(q_f.dtype)
    tgt_f = arm.q_target[:, 7:9]
    if p.finger_gear_coupling:
        # the gear-coupled pair (PhysicsParams.finger_gear_coupling)
        s = torch.mean(q_f, dim=-1)
        tgt_s = torch.mean(tgt_f, dim=-1)
        s_cand = s + torch.clamp(tgt_s - s, -step_lim, step_lim)
        f_tot = torch.sum(f_pad, dim=-1)
        n_tot = torch.sum(n_pad, dim=-1)
        floor = s + torch.clamp((f_tot - 2.0 * p.finger_force)
                                / (k * torch.clamp(n_tot, min=1.0)), -step_lim, step_lim)
        s_new = torch.clamp(torch.maximum(s_cand, floor), 0.0, 0.04)
        q_f = torch.stack([s_new, s_new], dim=-1)
    else:
        qf_cand = q_f + torch.clamp(tgt_f - q_f, -step_lim, step_lim)
        floor = q_f + torch.clamp((f_pad - p.finger_force) / (k * torch.clamp(n_pad, min=1.0)),
                                  -step_lim, step_lim)
        q_f = torch.clamp(torch.maximum(qf_cand, floor), 0.0, 0.04)

    grip_contact = ((torch.amax(pen_l, dim=1) > 0) | (torch.amax(pen_r, dim=1) > 0)
                    | (torch.amax(c_palm.pen, dim=1) > 0))
    return PhysicsState(
        arm=type(arm)(q=torch.cat([q_arm, q_f], dim=-1), qd=qd, q_target=arm.q_target),
        obj=type(obj)(pos=pos, quat=quat, linvel=linvel, angvel=angvel),
        contact_force=torch.linalg.vector_norm(total_f, dim=-1),
        gripper_contact=state.gripper_contact | grip_contact,
    )


@f32_matmuls
def physics_step(p: PhysicsParams, state: PhysicsState, sphere_set, mass, inertia_diag,
                 base_pose=None, substeps=None) -> PhysicsState:
    """One policy step of B envs: `substeps` (default p.substeps) physics
    substeps. Clears the gripper-contact accumulator first, like the
    reference's per-step collision check
    (reference: env/panda_scene.py:1078-1095)."""
    n = substeps if substeps is not None else p.substeps
    state = PhysicsState(arm=state.arm, obj=state.obj, contact_force=state.contact_force,
                         gripper_contact=torch.zeros_like(state.gripper_contact))
    for _ in range(n):
        state = physics_substep(p, state, sphere_set, mass, inertia_diag, base_pose)
    return state
