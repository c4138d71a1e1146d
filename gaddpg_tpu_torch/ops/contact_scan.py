"""K7: the contact scan, the whole substep loop of the single-object
physics in one launch (counterpart of `gaddpg_tpu/ops/pallas_physics.py`
and of the XLA substep of `gaddpg_tpu/physics/fast.py:225-475`).

Inputs, as the Pallas kernel takes them (`physics.fast` packs them):
state16 (B, 16) = [pos 3, quat 4 (wxyz), linvel 3, angvel 3, fingers 2,
gripper-contact flag]; hand (n, B, 13) = the hand's [pos, quat, linear
velocity, angular velocity] at every substep; sph3 (3, B, NS) sphere
centres in the object frame; radii (B, NS), radius 0 = padding; mass1
(B, 1); inert (B, 3) diagonal body inertia; fn_clamp (B, 4 NS) the
normal-force cap of every contact lane (table, left pad, right pad,
palm, NS spheres each); tgt (B, 2) finger targets. Output: state16 after
n substeps, the flag or-ed with any gripper contact on the way.

`contact_scan` dispatches on the device of its inputs: a CPU tensor runs
`contact_scan_reference` (plain PyTorch on (B, 4 NS) lanes, a Python
loop over the substeps), a CUDA tensor launches the kernel
(`csrc/contact_scan.cu`: one warp per env, the env's hand trajectory
staged in shared memory) or raises. It counts its
launches in `contact_scan.launches`.
"""

import ctypes

import torch

from gaddpg_tpu_torch.geometry.rotations import quat_mul, quat_normalize, quat_rotate
from gaddpg_tpu_torch.ops import build
from gaddpg_tpu_torch.physics.contact import clamp_passive_delta

NS = 32        # spheres per object, one per lane of a warp
C = 4 * NS     # contact lanes: table + left pad + right pad + palm


def contact_scan_reference(p, n, state16, hand, sph3, radii, mass1, inert, fn_clamp, tgt):
    """Plain PyTorch contact scan, op for op the XLA substep of
    `gaddpg_tpu/physics/fast.py` (same shapes as `contact_scan`)."""
    b = state16.shape[0]
    ns = radii.shape[1]
    dev, f32 = state16.device, torch.float32
    vec = lambda x: torch.tensor(x, dtype=f32, device=dev)
    sph_local = sph3.permute(1, 2, 0)                       # (B, NS, 3)
    fhe, phe = vec(p.finger_half_extents), vec(p.palm_half_extents)
    half_ext = torch.stack([fhe, fhe, phe])                 # (3 boxes, 3)
    mass_c, inertia = mass1, inert
    inv_inertia = 1.0 / inertia
    off_p = vec(p.palm_center).expand(b, 3)
    caps = vec([[p.contact_dv_max], [p.contact_dw_max]])
    conj = vec([1.0, -1.0, -1.0, -1.0])
    n_tab = vec([0.0, 0.0, 1.0]).expand(b, ns, 3)
    zeros_b = torch.zeros(b, dtype=f32, device=dev)
    zeros_ns3 = torch.zeros(b, ns, 3, dtype=f32, device=dev)
    real = radii > 0
    is_table = torch.arange(4 * ns, device=dev) < ns

    pos, quat = state16[:, 0:3], state16[:, 3:7]
    linvel, angvel = state16[:, 7:10], state16[:, 10:13]
    q_f, grip_any = state16[:, 13:15], state16[:, 15] > 0.5

    for t in range(n):
        h = hand[t]
        h_pos, h_quat, h_lin, h_ang = h[:, 0:3], h[:, 3:7], h[:, 7:10], h[:, 10:13]

        # ---- sphere world positions ----
        centers = pos[:, None, :] + quat_rotate(quat[:, None, :], sph_local)

        # ---- gripper boxes, stacked (B, 3, NS), in the hand frame ----
        off_l = torch.stack([zeros_b, q_f[:, 0] + p.finger_half_extents[1],
                             torch.full_like(zeros_b, p.finger_z_center)], dim=-1)
        off_r = torch.stack([zeros_b, -(q_f[:, 1] + p.finger_half_extents[1]),
                             torch.full_like(zeros_b, p.finger_z_center)], dim=-1)
        box_off = torch.stack([off_l, off_r, off_p], dim=1)                 # (B, 3, 3)
        box_t = h_pos[:, None, :] + quat_rotate(h_quat[:, None, :], box_off)
        c_hand = quat_rotate((h_quat * conj)[:, None, :], centers - h_pos[:, None, :])
        p_loc = c_hand[:, None, :, :] - box_off[:, :, None, :]              # (B, 3, NS, 3)
        qd_box = torch.abs(p_loc) - half_ext[None, :, None, :]
        outside = torch.clamp(qd_box, min=0.0)
        d_out = torch.linalg.vector_norm(outside, dim=-1)
        d_in = torch.clamp(torch.amax(qd_box, dim=-1), max=0.0)
        sdf = d_out + d_in
        n_out = outside * torch.sign(p_loc)
        n_out = n_out / torch.clamp(torch.linalg.vector_norm(n_out, dim=-1, keepdim=True),
                                    min=1e-9)
        in_axis = torch.argmax(qd_box, dim=-1)
        n_in = (in_axis[..., None] == torch.arange(3, device=dev)) * torch.sign(p_loc)
        n_loc = torch.where((d_out > 0)[..., None], n_out, n_in)
        n_box = quat_rotate(h_quat[:, None, None, :], n_loc)                # world
        pen_box = torch.where(real[:, None, :], radii[:, None, :] - sdf, -1.0)
        cpts_box = centers[:, None, :, :] - n_box * radii[:, None, :, None]
        v_box = h_lin[:, None, None, :] + torch.linalg.cross(h_ang[:, None, None, :],
                                                 cpts_box - box_t[:, :, None, :])

        # ---- table plane ----
        pen_tab = torch.where(real, radii - (centers[..., 2] - p.table_z), -1.0)
        cpts_tab = centers - n_tab * radii[..., None]

        # ---- flat contacts (B, 4 NS) ----
        pen = torch.cat([pen_tab, pen_box.reshape(b, 3 * ns)], dim=1)
        nrm = torch.cat([n_tab, n_box.reshape(b, 3 * ns, 3)], dim=1)
        cpts = torch.cat([cpts_tab, cpts_box.reshape(b, 3 * ns, 3)], dim=1)
        v_surf = torch.cat([zeros_ns3, v_box.reshape(b, 3 * ns, 3)], dim=1)

        active = pen > 0
        activef = active.to(f32)
        pen_c = torch.where(active, pen, 0.0)
        share = torch.clamp(active.sum(dim=1), min=1).to(f32)[:, None]
        r_c = cpts - pos[:, None, :]
        v_rel = linvel[:, None, :] + torch.linalg.cross(angvel[:, None, :], r_c) - v_surf
        q_c = quat * conj

        def inv_mass_along(d):
            rxd_b = quat_rotate(q_c[:, None, :], torch.linalg.cross(r_c, d))
            return 1.0 / mass_c + torch.sum(rxd_b ** 2 * inv_inertia[:, None, :], dim=-1)

        w_n = inv_mass_along(nrm)
        damp_cap = 0.9 / (w_n * share * p.dt)
        vn = torch.sum(v_rel * nrm, dim=-1)
        fn = p.contact_stiffness * pen_c - damp_cap * vn * activef
        fn = torch.minimum(torch.clamp(fn, min=0.0) * activef, fn_clamp)

        f_n = fn[..., None] * nrm
        f_contact = torch.sum(f_n, dim=1)
        torque = torch.sum(torch.linalg.cross(r_c, f_n), dim=1)
        # passive dv/dw cap, linear and angular halves in one call
        dw_body = p.dt * quat_rotate(q_c, torque) * inv_inertia
        w_body = quat_rotate(q_c, angvel)
        d_pair = clamp_passive_delta(torch.stack([p.dt * f_contact / mass_c, dw_body], dim=1),
                                     torch.stack([linvel, w_body], dim=1), caps)
        dv_c, dw_c_body = d_pair[:, 0], d_pair[:, 1]

        # gyroscopic term, I^-1 in the body frame
        gyro_b = torch.linalg.cross(w_body, inertia * w_body)
        v_pred = linvel + dv_c
        v_pred = torch.cat([v_pred[:, :2], v_pred[:, 2:] + p.dt * p.gravity], dim=1)
        w_pred = angvel + quat_rotate(quat, dw_c_body - p.dt * gyro_b * inv_inertia)

        # ---- friction impulse passes (pass 1 fixes the slip direction) ----
        budget = p.friction_mu * fn * p.dt
        have = fn > 0
        havef = have.to(f32)
        v_cc = v_pred[:, None, :] + torch.linalg.cross(w_pred[:, None, :], r_c) - v_surf
        vt = v_cc - torch.sum(v_cc * nrm, dim=-1, keepdim=True) * nrm
        vt_n = torch.linalg.vector_norm(vt, dim=-1)
        t_dir = vt / torch.clamp(vt_n[..., None], min=1e-9)
        w_t = inv_mass_along(t_dir)

        def apply_impulse(v, w, j):
            imp = -j[..., None] * t_dir
            dv = torch.sum(imp, dim=1) / mass_c
            tau_i = quat_rotate(q_c, torch.sum(torch.linalg.cross(r_c, imp), dim=1))
            return v + dv, w + quat_rotate(quat, tau_i * inv_inertia)

        j1 = torch.minimum(vt_n / (w_t * share), budget) * havef
        v_out, w_out = apply_impulse(v_pred, w_pred, j1)
        budget = budget - j1
        for _ in range(max(p.friction_iters - 1, 0)):
            v_cc2 = v_out[:, None, :] + torch.linalg.cross(w_out[:, None, :], r_c) - v_surf
            vt_along = torch.sum(v_cc2 * t_dir, dim=-1)
            j2 = torch.minimum(torch.clamp(vt_along / (w_t * share), min=0.0), budget) * havef
            v_out, w_out = apply_impulse(v_out, w_out, j2)
            budget = budget - j2

        # ---- rigid-set translational stiction (linear slip only) ----
        v_lin3 = v_out[:, None, :] - v_surf
        vt3 = (v_lin3 - torch.sum(v_lin3 * nrm, dim=-1, keepdim=True) * nrm) * havef[..., None]
        fn_sum = torch.sum(fn, dim=1, keepdim=True)
        vbar = torch.sum(fn[..., None] * vt3, dim=1) / torch.clamp(fn_sum, min=1e-9)
        vbar_n = torch.linalg.vector_norm(vbar, dim=-1, keepdim=True)
        pool = torch.sum(budget, dim=1, keepdim=True)
        scale = torch.clamp(pool / torch.clamp(mass_c * vbar_n, min=1e-9), max=1.0)
        v_out = v_out - vbar * scale * (fn_sum > 0)

        w_surf_ang = torch.where(is_table[None, :, None], 0.0, h_ang[:, None, :])
        # ---- torsional friction through the pad patch ----
        if p.torsion_patch_radius > 0:
            s_rel = torch.sum((w_out[:, None, :] - w_surf_ang) * nrm, dim=-1)
            n_b = quat_rotate(q_c[:, None, :], nrm)
            w_rot = torch.sum(n_b ** 2 * inv_inertia[:, None, :], dim=-1)
            l_cap = p.friction_mu * p.torsion_patch_radius * fn * p.dt
            lj = torch.minimum(torch.maximum(s_rel / (w_rot * share), -l_cap), l_cap) * havef
            dl_b = torch.sum(n_b * (-lj)[..., None], dim=1)
            w_out = w_out + quat_rotate(quat, dl_b * inv_inertia)

        # ---- aggregate rotational stiction over the pad contacts ----
        if p.pad_rot_stiction:
            pad_have = (have & ~is_table).to(f32)
            w_rel = (w_out[:, None, :] - h_ang[:, None, :]) * pad_have[..., None]
            fnp = fn * pad_have
            fnp_sum = torch.sum(fnp, dim=1, keepdim=True)
            wbar = torch.sum(fnp[..., None] * w_rel, dim=1) / torch.clamp(fnp_sum, min=1e-9)
            lever = torch.linalg.vector_norm(r_c, dim=-1) + p.torsion_patch_radius
            pool_ang = torch.sum(p.friction_mu * fnp * lever * p.dt, dim=1, keepdim=True)
            l_need = torch.linalg.vector_norm(inertia * quat_rotate(q_c, wbar), dim=-1,
                                              keepdim=True)
            scale_a = torch.clamp(pool_ang / torch.clamp(l_need, min=1e-9), max=1.0)
            w_out = w_out - wbar * scale_a * (fnp_sum > 0)

        # ---- damping, clips, integration ----
        linvel = torch.clamp(v_out / (1.0 + p.linear_damping * p.dt), -p.max_linvel, p.max_linvel)
        angvel = torch.clamp(w_out / (1.0 + p.angular_damping * p.dt),
                             -p.max_angvel, p.max_angvel)
        pos = pos + p.dt * linvel
        w_q = torch.cat([zeros_b[:, None], angvel], dim=-1)
        quat = quat_normalize(quat + 0.5 * p.dt * quat_mul(w_q, quat))

        # ---- fingers: penetration-limited servo ----
        pen_l = torch.clamp(pen_box[:, 0], min=0.0)
        pen_r = torch.clamp(pen_box[:, 1], min=0.0)
        step_lim = p.finger_vel_limit * p.dt
        k = p.contact_stiffness
        f_pad = k * torch.stack([pen_l.sum(dim=1), pen_r.sum(dim=1)], dim=-1)
        n_pad = torch.stack([(pen_l > 0).sum(dim=1), (pen_r > 0).sum(dim=1)], dim=-1).to(f32)
        if p.finger_gear_coupling:
            # one opening DOF driven by the total pad force
            s = torch.mean(q_f, dim=-1, keepdim=True)
            tgt_s = torch.mean(tgt, dim=-1, keepdim=True)
            s_cand = s + torch.clamp(tgt_s - s, -step_lim, step_lim)
            floor = s + torch.clamp(
                (f_pad.sum(dim=-1, keepdim=True) - 2.0 * p.finger_force)
                / (k * torch.clamp(n_pad.sum(dim=-1, keepdim=True), min=1.0)),
                -step_lim, step_lim)
            q_f = torch.clamp(torch.maximum(s_cand, floor), 0.0, 0.04).expand(b, 2)
        else:
            qf_cand = q_f + torch.clamp(tgt - q_f, -step_lim, step_lim)
            floor = q_f + torch.clamp((f_pad - p.finger_force) / (k * torch.clamp(n_pad, min=1.0)),
                                      -step_lim, step_lim)
            q_f = torch.clamp(torch.maximum(qf_cand, floor), 0.0, 0.04)

        grip_any = grip_any | (pen_box.reshape(b, -1) > 0).any(dim=1)

    return torch.cat([pos, quat, linvel, angvel, q_f, grip_any.to(f32)[:, None]], dim=1)


# PhysicsParams -> the kernel's float block, in `struct ScanParams` order
# (csrc/contact_scan.cu). Products the JAX code forms in Python double
# before they meet a float32 array are formed here the same way.
def kernel_params(p):
    floats = [
        p.dt, p.dt * p.gravity, p.contact_stiffness, p.friction_mu,
        p.friction_mu * p.torsion_patch_radius, p.torsion_patch_radius,
        1.0 + p.linear_damping * p.dt, 1.0 + p.angular_damping * p.dt,
        p.max_linvel, p.max_angvel, p.contact_dv_max, p.contact_dw_max,
        p.finger_vel_limit * p.dt, p.finger_force, 2.0 * p.finger_force, p.table_z,
        *p.finger_half_extents, *p.palm_half_extents, *p.palm_center, p.finger_z_center,
        0.5 * p.dt,
        float(p.friction_iters), float(p.torsion_patch_radius > 0),
        float(bool(p.pad_rot_stiction)), float(bool(p.finger_gear_coupling)),
    ]
    return (ctypes.c_float * len(floats))(*floats)


def contact_scan(p, n, state16, hand, sph3, radii, mass1, inert, fn_clamp, tgt):
    """Run n physics substeps for every env (shapes in the module
    docstring; NS must be 32). CPU tensors: `contact_scan_reference`.
    CUDA tensors: the K7 kernel, one launch; it raises where a block's
    staged trajectories exceed shared memory (n > 1117)."""
    b = state16.shape[0]
    shapes = {"state16": (state16, (b, 16)), "hand": (hand, (n, b, 13)),
              "sph3": (sph3, (3, b, NS)), "radii": (radii, (b, NS)), "mass1": (mass1, (b, 1)),
              "inert": (inert, (b, 3)), "fn_clamp": (fn_clamp, (b, C)), "tgt": (tgt, (b, 2))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"contact_scan: {name} must be float32 {shape}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    args = [t for t, _ in shapes.values()]
    dev = build.kernel_device("contact_scan", *args)
    if dev.type == "cpu":
        return contact_scan_reference(p, n, *args)
    out = torch.empty((b, 16), dtype=torch.float32, device=dev)
    params = kernel_params(p)
    build.launch("contact_scan", dev, *(t.data_ptr() for t in args), out.data_ptr(),
                 ctypes.addressof(params), len(params), b, n, NS)
    contact_scan.launches += 1
    return out


contact_scan.launches = 0
