"""Batched physics: the whole env batch in one program (counterpart of
gaddpg_tpu/physics/fast.py).

The contact model is the JAX package's: spring normals with capped
damping, cone-budgeted friction passes, rigid-set translational
stiction, torsional and pad rotational stiction, gear-coupled
penetration-limited fingers, an acceleration-limited arm servo. The arm
is position-servoed and feels no reaction forces, so its trajectory and
every hand pose and velocity of the `substeps` horizon are computed
first; the object's substep loop then runs as one call of
`ops.contact_scan` (K7 on the card, its plain version on the CPU).
"""

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from gaddpg_tpu_torch.geometry.rotations import CONJ, quat_mul, quat_rotate
from gaddpg_tpu_torch.ops.contact_scan import NS, contact_scan
from gaddpg_tpu_torch.physics.types import PhysicsParams, PhysicsState
from gaddpg_tpu_torch.robot import panda
from gaddpg_tpu_torch.utils.constants import const

# constant chain as quaternions (wxyz), float64 until placed on a device
_OQ = np.roll(Rotation.from_matrix(panda._ORIGINS[:, :3, :3]).as_quat(), 1, axis=-1)
_OT = panda._ORIGINS[:, :3, 3]
_HQ = np.roll(Rotation.from_matrix(panda._T_HAND[:3, :3]).as_quat(), 1, axis=-1)
_HT = panda._T_HAND[:3, 3]


def fk_hand_batched(q):
    """Hand pose from arm joints q (..., 7) -> (pos (..., 3), quat (..., 4))."""
    batch, dev = q.shape[:-1], q.device
    oq, ot = const(_OQ, dev), const(_OT, dev)
    pos = q.new_zeros(*batch, 3)
    rot = const((1.0, 0.0, 0.0, 0.0), dev).expand(*batch, 4)
    for i in range(7):
        pos = pos + quat_rotate(rot, ot[i].expand(*batch, 3))
        rot = quat_mul(rot, oq[i].expand(*batch, 4))
        half = q[..., i] * 0.5
        zero = torch.zeros_like(half)
        rot = quat_mul(rot, torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1))
    pos = pos + quat_rotate(rot, const(_HT, dev).expand(*batch, 3))
    return pos, quat_mul(rot, const(_HQ, dev).expand(*batch, 4))


def arm_trajectory(p: PhysicsParams, q0, qd0, q_tgt, n: int):
    """Trapezoidal servo rollout: (n, B, 7) joint positions and the final qd."""
    q, qd = q0, qd0
    traj = []
    for _ in range(n):
        err = q_tgt - q
        v_brake = torch.sqrt(2.0 * p.arm_acc_limit * torch.abs(err))
        v_des = torch.sign(err) * torch.clamp(v_brake, max=p.arm_vel_limit)
        qd = torch.minimum(torch.maximum(v_des, qd - p.arm_acc_limit * p.dt),
                           qd + p.arm_acc_limit * p.dt)
        q = q + qd * p.dt
        traj.append(q)
    return torch.stack(traj), qd


def pack_contact_scan(p: PhysicsParams, n: int, state: PhysicsState, sphere_sets, mass,
                      inertia, hand):
    """The contact scan's inputs (ops/contact_scan.py) from the state, the
    (B, ns, 4) sphere sets (ns <= NS; padding spheres, parked at z = 1e6
    with radius 0, can never contact) and the (n, B, 13) hand trajectory."""
    b, ns = sphere_sets.shape[:2]
    obj, arm = state.obj, state.arm
    state16 = torch.cat([obj.pos, obj.quat, obj.linvel, obj.angvel, arm.q[:, 7:9],
                         obj.pos.new_zeros(b, 1)], dim=1)
    sph = sphere_sets
    if ns < NS:
        pad = sph.new_zeros(b, NS - ns, 4)
        pad[:, :, 2] = 1e6
        sph = torch.cat([sph, pad], dim=1)
    elif ns > NS:
        raise ValueError(f"sphere sets of {ns} > {NS} spheres")
    caps = const((p.table_max_force, 2.0 * p.finger_force, 2.0 * p.finger_force,
                  p.palm_max_force), sph.device)
    fn_clamp = caps.repeat_interleave(NS).expand(b, 4 * NS)
    return (state16, hand, sph[..., :3].permute(2, 0, 1), sph[..., 3], mass[:, None],
            inertia, fn_clamp, arm.q_target[:, 7:9])


def hand_trajectory(p: PhysicsParams, arm, n: int):
    """The arm's servo rollout over n substeps and the hand's pose and
    velocity at each: (q_traj (n, B, 7), final qd (B, 7), hand (n, B, 13)
    = [pos, quat, linear velocity, angular velocity])."""
    q_traj, qd_final = arm_trajectory(p, arm.q[:, :7], arm.qd, arm.q_target[:, :7], n)
    q_all = torch.cat([arm.q[None, :, :7], q_traj], dim=0)            # (n+1, B, 7)
    hand_pos_all, hand_quat_all = fk_hand_batched(q_all)
    hand_lin = (hand_pos_all[1:] - hand_pos_all[:-1]) / p.dt
    # angular velocity from quaternion increments: w = 2 (dq x q^-1).vec
    dq = hand_quat_all[1:] - hand_quat_all[:-1]
    qc = hand_quat_all[:-1] * const(CONJ, hand_quat_all.device)
    hand_ang = (quat_mul(dq, qc) * (2.0 / p.dt))[..., 1:]
    hand = torch.cat([hand_pos_all[1:], hand_quat_all[1:], hand_lin, hand_ang], dim=-1)
    return q_traj, qd_final, hand


def fast_physics_step(p: PhysicsParams, state: PhysicsState, sphere_sets, mass, inertia,
                      substeps=None) -> PhysicsState:
    """Advance a (B,)-batched PhysicsState by `substeps` ticks of p.dt.

    sphere_sets (B, ns, 4); mass (B,); inertia (B, 3). The base is at the
    world origin."""
    n = substeps if substeps is not None else p.substeps
    arm = state.arm
    q_traj, qd_final, hand = hand_trajectory(p, arm, n)
    out = contact_scan(p, n, *(t.contiguous() for t in pack_contact_scan(
        p, n, state, sphere_sets, mass, inertia, hand)))
    q_new = torch.cat([q_traj[-1], out[:, 13:15]], dim=-1)
    return PhysicsState(
        arm=type(arm)(q=q_new, qd=qd_final, q_target=arm.q_target),
        obj=type(state.obj)(pos=out[:, 0:3], quat=out[:, 3:7], linvel=out[:, 7:10],
                            angvel=out[:, 10:13]),
        contact_force=out.new_zeros(out.shape[0]),
        gripper_contact=out[:, 15] > 0.5,
    )
