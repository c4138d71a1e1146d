"""Batched CHOMP-style trajectory-optimizer expert (counterpart of
gaddpg_tpu/expert/chomp.py).

Joint-space waypoints optimised by a fixed number of preconditioned
gradient-descent steps on a smoothness + obstacle cost, where the
obstacles are sphere sets (radius 0 = padding) probed by points on the
gripper and along the arm skeleton, with the OMG expert's standoff /
insertion structure (standoff_dist 0.08, reference:
experiments/config.py:220) and joint-limit projection (reference:
env/panda_scene.py:881-993).

Every function works on a batch of envs at once, and the envs are
independent: `plan_to_goal` plans each env's trajectory as the JAX
package's `plan_to_goal` plans one. The descent's gradient comes from
`torch.autograd.grad` of the per-env costs summed over the envs. Its
matmuls run in true float32 (`f32_matmuls`).
"""

import numpy as np
import torch

from gaddpg_tpu_torch.geometry.rotations import mat_to_euler
from gaddpg_tpu_torch.geometry.se3 import se3_inverse
from gaddpg_tpu_torch.models.heads import TASK6D_HIGH
from gaddpg_tpu_torch.robot import panda
from gaddpg_tpu_torch.robot.ik import dls_ik
from gaddpg_tpu_torch.utils.constants import const
from gaddpg_tpu_torch.utils.precision import f32_matmuls

STANDOFF_DIST = 0.08     # reference: experiments/config.py:220
APPROACH_STEPS = 16      # optimised waypoints to the standoff pose
INSERT_STEPS = 4         # straight standoff -> grasp insertion
PLAN_STEPS = APPROACH_STEPS + INSERT_STEPS

# gripper-local probe points of the obstacle cost (hand frame): wrist,
# palm sides, finger spread, fingertip centre, tip overshoot; the arm
# skeleton (robot/panda.arm_collision_points) joins them, so an elbow
# sweeping through an obstacle is costed too (reference:
# env/panda_scene.py:897-917)
_PROBES = np.array([
    [0.0, 0.0, 0.0],
    [0.0, 0.055, 0.03],
    [0.0, -0.055, 0.03],
    [0.0, 0.045, 0.085],
    [0.0, -0.045, 0.085],
    [0.0, 0.0, 0.065],
    [0.0, 0.0, 0.112],
])
PROBE_RADIUS = 0.022     # effective thickness of the probed geometry
_PROBE_RADII = np.concatenate([np.full(len(_PROBES), PROBE_RADIUS), panda.ARM_POINT_RADII])


def _smoothness_preconditioner():
    """Inverse CHOMP metric M^-1, M = A^T A with A the second-difference
    operator restricted to the free waypoints, inverted in float64 and
    rounded to float32 as the JAX package's `jnp.asarray` rounds it.
    Preconditioning by M^-1 is what makes the descent converge in tens
    of steps and spreads a local obstacle gradient along the whole
    trajectory."""
    t = APPROACH_STEPS
    a = np.zeros((t - 2, t))
    for i in range(t - 2):
        a[i, i:i + 3] = (1.0, -2.0, 1.0)
    a_free = a[:, 1:-1]
    m = a_free.T @ a_free + 1e-6 * np.eye(t - 2)
    return np.linalg.inv(m).astype(np.float32)


_MINV = _smoothness_preconditioner()


def _unit_steps(n):
    """The float32 values of `jnp.linspace(0.0, 1.0, n)` on the CPU: the
    iota times the float32 reciprocal of n - 1 (XLA folds the division
    into that product), the stop exactly 1."""
    out = np.arange(n, dtype=np.float32) * np.float32(1.0 / (n - 1))
    out[-1] = 1.0
    return out


_ALPHAS = _unit_steps(APPROACH_STEPS)[1:-1, None]     # (14, 1) approach blend
_BETAS = _unit_steps(INSERT_STEPS + 1)[1:, None]       # (4, 1) insertion blend
# obstacle-cost fade toward the trajectory end for the target's own
# geometry: the grasp must end in contact, so the target repels the
# approach but not the final alignment (reference: env/panda_scene.py:897-917)
_TARGET_FADE = (np.minimum(np.arange(APPROACH_STEPS, 0, -1, dtype=np.float32) - 1, 4.0)
                / 4.0).astype(np.float32)


def _probe_world(q):
    """World positions (..., P, 3) of the collision probes at joints
    q (..., 7): the gripper probes and the arm skeleton, from one FK
    chain. Their radii are `_PROBE_RADII` (P,)."""
    frames = panda.fk_all(q)
    hand = frames[..., -1, :, :]
    grip = const(_PROBES, q.device) @ hand[..., :3, :3].transpose(-1, -2) + hand[..., None, :3, 3]
    return torch.cat([grip, panda.arm_collision_points(frames=frames)], dim=-2)


def _probe_cost(p, spheres, margin, table_z):
    """Hinge-squared penetration (...,) of probes p (..., P, 3) into the
    spheres (..., NOBS, 4) (radius 0 = padding; leading axes broadcast
    against p's) and into the table plane."""
    radii = const(_PROBE_RADII, p.device)
    diff = p[..., :, None, :] - spheres[..., None, :, :3]
    # eps-regularised norm: a probe exactly at a sphere centre has a 0/0
    # norm gradient that would turn the whole descent into NaN
    d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    r_obs = spheres[..., None, :, 3]
    pen = torch.clamp(r_obs + radii[:, None] + margin - d, min=0.0)
    pen = torch.where(r_obs > 0, pen, 0.0)
    table_pen = torch.clamp(table_z + radii * 0.5 - p[..., 2], min=0.0)
    return torch.sum(pen ** 2, dim=(-2, -1)) + torch.sum(table_pen ** 2, dim=-1)


def obstacle_cost(q, spheres, margin: float = 0.01, table_z: float = 0.0):
    """Hinge-squared penetration of the gripper and arm probes at joints
    q (..., 7) into the spheres (..., NOBS, 4) (world, radius 0 =
    padding; leading axes broadcast against q's) and into the table
    plane: the all-link collision cost (reference:
    env/panda_scene.py:897-917). Returns (...,)."""
    return _probe_cost(_probe_world(q), spheres, margin, table_z)


def _traj_cost(free_q, q0, q_end, spheres, target_spheres, table_z, w_smooth, w_obs):
    """Per-env cost (B,) of the interior waypoints free_q (B, M, 7)
    between the fixed q0 and q_end (B, 7)."""
    traj = torch.cat([q0[:, None], free_q, q_end[:, None]], dim=1)
    acc = traj[:, 2:] - 2.0 * traj[:, 1:-1] + traj[:, :-2]
    smooth = torch.sum(acc ** 2, dim=(1, 2))
    p = _probe_world(traj)
    obs = torch.sum(_probe_cost(p, spheres[:, None], 0.01, table_z), dim=1)
    fade = const(_TARGET_FADE, traj.device)
    obs = obs + torch.sum(fade * _probe_cost(p, target_spheres[:, None], 0.01, table_z), dim=1)
    return w_smooth * smooth + w_obs * obs


@f32_matmuls
def approach_descent(q0, q_stand, spheres, target_spheres, table_z: float = 0.0,
                     iters: int = 30, lr: float = 0.2, w_smooth: float = 1.0,
                     w_obs: float = 50.0):
    """The CHOMP descent of the approach q0 -> q_stand (B, 7) around the
    obstacle spheres (B, NOBS, 4) and the target's (B, NS, 4): the
    interior waypoints start on the straight joint-space line and take
    `iters` steps free -= lr M^-1 grad, each clipped to the joint limits.
    Returns free (B, APPROACH_STEPS - 2, 7).

    Live on the device during a step: the trajectory's FK frames (B, 16,
    8, 4, 4), the probes (B, 16, 22, 3) and, for each sphere set, the
    probe-to-sphere differences (B, 16, 22, N, 3) and distances, kept by
    autograd for the backward: at B = 1024 and N = 32 target spheres
    about 140 MB per difference tensor, under 1 GB in all."""
    dev = q0.device
    alphas = const(_ALPHAS, dev)
    minv = const(_MINV, dev)
    lo, hi = const(panda.JOINT_LOWER, dev), const(panda.JOINT_UPPER, dev)
    free = q0[:, None] * (1.0 - alphas) + q_stand[:, None] * alphas
    for _ in range(iters):
        with torch.enable_grad():
            x = free.detach().requires_grad_(True)
            cost = _traj_cost(x, q0, q_stand, spheres, target_spheres, table_z, w_smooth,
                              w_obs)
            g, = torch.autograd.grad(cost.sum(), x)
        free = free - lr * (minv @ g)  # the CHOMP-preconditioned step
        free = torch.minimum(torch.maximum(free, lo), hi)
    return free


def _converged(perr, rerr):
    return (perr < 5e-3) & (rerr < 5e-2)


@f32_matmuls
def plan_to_goal(q0, goal_pose, obstacle_spheres, table_z: float = 0.0,
                 target_spheres=None, iters: int = 30, lr: float = 0.2,
                 w_smooth: float = 1.0, w_obs: float = 50.0):
    """Plan PLAN_STEPS joint waypoints per env from q0 (B, 7) to the grasp
    goal_pose (B, 4, 4, world) around obstacle_spheres (B, NOBS, 4,
    world, radius 0 = padding), the target's own spheres
    (B, NS, 4) an approach obstacle whose cost fades near the standoff.
    Returns (plan (B, PLAN_STEPS, 7), ok (B,)).

    The standoff solve (reference: env/panda_scene.py:920-993): DLS IK
    from q0 lands on the joint-space branch nearest the start. Where that
    branch's arm collides with an obstacle (a clash the descent cannot fix,
    since the standoff is a fixed endpoint), the lowest-cost converged
    anchor-seed branch replaces it, nearest the start among equals (first
    on ties). Then the descent to the standoff and a straight insertion
    to the IK solution at the grasp."""
    b, dev = q0.shape[0], q0.device
    if target_spheres is None:
        target_spheres = q0.new_zeros(b, 0, 4)
    standoff_pos = goal_pose[:, :3, 3] + -STANDOFF_DIST * goal_pose[:, :3, 2]
    seeds = const(panda.ANCHOR_SEEDS, dev)
    n_seeds = seeds.shape[0]
    # start 0 is q0, starts 1.. the anchor seeds: one batched solve
    starts = torch.cat([q0[:, None], seeds[None].expand(b, n_seeds, 7)], dim=1)
    qs, perrs, rerrs = dls_ik(starts, standoff_pos[:, None].expand(b, n_seeds + 1, 3),
                              goal_pose[:, None, :3, :3].expand(b, n_seeds + 1, 3, 3))
    conv = _converged(perrs, rerrs)
    costs = obstacle_cost(qs, obstacle_spheres[:, None], margin=0.005, table_z=table_z)
    q_near, ok_near, cost_near = qs[:, 0], conv[:, 0], costs[:, 0]
    qs, conv, costs = qs[:, 1:], conv[:, 1:], costs[:, 1:]
    # among converged seeds: clear of obstacles first, then nearest the start
    seed_score = torch.where(
        conv, costs * 1e3 + 0.01 * torch.linalg.vector_norm(qs - q0[:, None], dim=-1),
        torch.inf)
    best = torch.argmin(seed_score, dim=1)  # the first index on ties
    rows = torch.arange(b, device=dev)
    q_alt, ok_alt, cost_alt = qs[rows, best], conv[rows, best], costs[rows, best]
    use_near = ok_near & ((cost_near < 1e-8) | ~ok_alt | (cost_alt >= cost_near))
    q_stand = torch.where(use_near[:, None], q_near,
                          torch.where(ok_alt[:, None], q_alt, q_near))
    ok_stand = ok_near | ok_alt
    # the short insertion solve, seeded from the standoff solution
    q_final, perr, rerr = dls_ik(q_stand, goal_pose[:, :3, 3], goal_pose[:, :3, :3], iters=20)
    ok_final = _converged(perr, rerr)

    free = approach_descent(q0, q_stand, obstacle_spheres, target_spheres, table_z, iters,
                            lr, w_smooth, w_obs)
    approach = torch.cat([q0[:, None], free, q_stand[:, None]], dim=1)
    betas = const(_BETAS, dev)
    insert = q_stand[:, None] * (1.0 - betas) + q_final[:, None] * betas
    plan = torch.cat([approach, insert], dim=1)

    # residual clearance of the optimised approach
    res_obs = torch.sum(obstacle_cost(approach, obstacle_spheres[:, None], margin=0.0,
                                      table_z=table_z - 0.01), dim=1)
    return plan, ok_stand & ok_final & (res_obs < 1e-5)


@f32_matmuls
def plan_action(hand_pose, plan, step_idx):
    """Task-space expert actions (B, 6) tracking waypoint step_idx + 1 of
    each env's plan (B, PLAN_STEPS, 7) from the hand poses (B, 4, 4): the
    reference executes its joint plan by step index and converts each
    waypoint to a cartesian delta against the current pose, which
    corrects drift while progress stays monotone
    (reference: env/panda_scene.py:1118-1139, core/train_online.py:255)."""
    nxt = torch.clamp(step_idx.to(torch.int64) + 1, max=plan.shape[1] - 1)
    target = panda.fk_hand(plan[torch.arange(plan.shape[0], device=plan.device), nxt])
    rel = se3_inverse(hand_pose) @ target
    action = torch.cat([rel[:, :3, 3], mat_to_euler(rel[:, :3, :3])], dim=-1)
    high = const(TASK6D_HIGH, hand_pose.device)
    return torch.minimum(torch.maximum(action, -high), high)
