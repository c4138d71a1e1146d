"""Physics state holders and parameters (counterpart of
gaddpg_tpu/physics/types.py).

`PhysicsParams` is the JAX package's frozen, hashable dataclass with the
same defaults. The states are dataclasses of batched tensors: every
field has the env batch as its leading axis.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Static simulation constants (frozen and hashable)."""

    # 75 x 2 ms = the reference's 150 ms of simulated time per policy
    # step (reference: env/panda_scene.py:152,358 uses 150 x 1 ms);
    # 2 ms is the largest substep at which grasp/lift behavior stays
    # clean (validated in tests/examples), at half the cost.
    dt: float = 2e-3
    substeps: int = 75
    gravity: float = -9.81

    # compliant contact
    contact_stiffness: float = 5000.0   # N/m
    contact_damping_ratio: float = 1.0
    friction_mu: float = 0.8
    friction_vel_eps: float = 2e-3      # Coulomb regularization (m/s)
    # 4 passes needed for clean grasps at dt=2ms (passes 2+ reuse the
    # pass-1 slip direction and are ~4x cheaper than pass 1)
    friction_iters: int = 4
    # torsional (spinning) friction patch radius: a point contact cannot
    # resist rotation about its own normal, so a two-point pinch on a
    # curved body swings freely about the closing axis and the object
    # pours out of the grasp. Real finger pads resist through the finite
    # contact patch; torque capacity = mu * fn * this radius (PyBullet
    # exposes the same knob as spinning friction). 0 disables.
    torsion_patch_radius: float = 0.006  # m
    # aggregate rotational stiction over the PAD contact set: the
    # angular analogue of the rigid-set translational pass. In a
    # symmetric pinch the per-contact friction passes' responses to
    # rotation-mode slip cancel between opposing pads, so a curved body
    # can screw/pivot out of a long pinch even with translation fully
    # stopped. One aggregate angular impulse drives the fn-weighted
    # object-vs-hand angular slip of the pad set to zero, bounded by
    # the pooled Coulomb torque budget (mu*fn*(lever+patch) per
    # contact). Table contacts are excluded so free rolling on the
    # table is untouched. False disables (ablation knob).
    pad_rot_stiction: bool = True
    # gear-coupled fingers (the reference couples them with a PyBullet
    # gear constraint, reference: env/panda_gripper_hand_camera.py:37-45).
    # Independent penetration-limited servos creep: in an asymmetric
    # pinch one pad reaches its force floor while the other keeps
    # closing at the rate limit, translating the squeeze centerline --
    # the object drifts out of long pinches at ~the finger creep rate
    # with zero rotation (measured 1.3 mm/s on the mesh-mug rig).
    # Coupled fingers close/stop TOGETHER on the total pad force, so the
    # pinch self-centers and holds statically. False = legacy servos.
    finger_gear_coupling: bool = True

    # object free-body damping (matches PyBullet defaults feel)
    linear_damping: float = 0.04
    angular_damping: float = 0.04

    # arm servo
    arm_vel_limit: float = 2.2          # rad/s per joint
    arm_acc_limit: float = 30.0         # rad/s^2 (smooth jerk-free tracking)
    finger_vel_limit: float = 0.15      # m/s  (URDF finger limit 0.2)
    finger_force: float = 25.0          # max squeeze force (N, URDF effort 20)
    finger_kp: float = 6000.0           # servo spring (N/m)
    finger_damping: float = 150.0       # servo damping (N s/m)

    # contact force caps: the position-servoed gripper can deepen
    # penetration without limit, and an uncapped penalty spring then
    # releases that stored energy as an ejection (objects at z = tens of
    # meters). Caps make deep contact plastic instead of explosive.
    palm_max_force: float = 100.0       # N (4x finger squeeze)
    table_max_force: float = 400.0      # N
    # per-substep cap on the *speed-increasing* part of the
    # contact-driven velocity change: penalty contact may brake an
    # incoming object without limit (up to reversal, so falls never
    # tunnel) but can accelerate it by at most this much per substep --
    # the position-servoed arm is an infinite energy source, and without
    # the cap a deep squeeze or table press releases as an ejection.
    # 0.05 m/s per 2 ms substep = 25 m/s^2 sustained, far above any
    # legitimate contact acceleration in a tabletop grasp.
    contact_dv_max: float = 0.05        # m/s per substep
    contact_dw_max: float = 0.50        # rad/s per substep
    # hard physical ceilings (hand moves <~0.5 m/s; free fall from the
    # workspace tops out ~3 m/s)
    max_linvel: float = 3.0             # m/s
    max_angvel: float = 25.0            # rad/s

    # gripper collision proxies, hand frame
    palm_center: tuple = (0.0, 0.0, 0.033)
    palm_half_extents: tuple = (0.031, 0.10, 0.028)
    finger_half_extents: tuple = (0.011, 0.009, 0.027)
    finger_z_center: float = 0.0584 + 0.027  # pad center along hand z

    # object<->object contact (physics/multi.py): penalty spring between
    # coarse sphere sets; per-pair force cap + viscous tangential
    # friction capped by the Coulomb cone of the pair normal force.
    obj_obj_max_force: float = 100.0     # N per sphere pair
    obj_obj_tangent_damping: float = 30.0  # N s/m (superseded round 4:
    # the pair tangential pass is stiction-exact now; kept for config
    # compatibility)
    # ceiling on the relative separation speed the pair spring may
    # create: overlap relaxes at <= this, impacts rebound at <= this
    # (near-zero restitution), so deep spawn overlap can never eject
    obj_obj_sep_vmax: float = 0.10       # m/s
    obj_obj_roll_patch: float = 0.015    # m: contact-patch radius for the
    # pair rolling-stiction torque budget (mu * N * patch)

    table_z: float = 0.0                 # table top plane in world frame


def map_tensors(obj, fn):
    """A state dataclass with `fn` applied to every tensor field, nested
    states included."""
    return dataclasses.replace(obj, **{
        f.name: (map_tensors(v, fn) if dataclasses.is_dataclass(v) else fn(v))
        for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)
    })


@dataclasses.dataclass
class BodyState:
    """Free rigid body (the target object)."""

    pos: torch.Tensor      # (B, 3)
    quat: torch.Tensor     # (B, 4) wxyz
    linvel: torch.Tensor   # (B, 3)
    angvel: torch.Tensor   # (B, 3) world frame


@dataclasses.dataclass
class ArmState:
    """Panda joints: 7 arm + 2 fingers, position-servo targets."""

    q: torch.Tensor          # (B, 9)
    qd: torch.Tensor         # (B, 7) arm joint velocities
    q_target: torch.Tensor   # (B, 9)


@dataclasses.dataclass
class PhysicsState:
    arm: ArmState
    obj: BodyState
    contact_force: torch.Tensor    # (B,)
    gripper_contact: torch.Tensor  # (B,) bool: any object-gripper contact this step
