"""Grasp-goal selection from the object grasp database (counterpart of
gaddpg_tpu/expert/goals.py)."""

import torch

from gaddpg_tpu_torch.geometry.gripper import HAND_FINGER_POINTS
from gaddpg_tpu_torch.geometry.se3 import se3_inverse
from gaddpg_tpu_torch.utils.constants import const


def reachable_grasp_mask(grasps_world, valid, max_up: float = 0.3):
    """Reject grasps approaching from below the table: the approach axis
    (+z of the grasp frame) must have world z below `max_up`
    (reference: core/utils.py:141-143)."""
    return valid & (grasps_world[..., 2, 2] < max_up)


def clutter_clear_mask(grasps_world, clutter_spheres, clearance: float = 0.03):
    """Reject grasps whose gripper would land inside the clutter.

    Probes the palm centre, the standoff approach point 8 cm back and the
    fingertip point 4 cm ahead of each grasp against the clutter spheres
    (radius 0 = padding), as the reference's OMG expert does by planning
    against the combined obstacle SDF (reference:
    env/panda_scene.py:897-917). grasps_world (B, G, 4, 4); clutter_spheres
    (B, S, 4) world. Returns (B, G) bool."""
    ok = torch.ones(grasps_world.shape[:-2], dtype=torch.bool, device=grasps_world.device)
    if clutter_spheres.shape[1] == 0:
        return ok
    palm = grasps_world[..., :3, 3]
    approach = grasps_world[..., :3, 2]
    radius = clutter_spheres[:, None, :, 3]                    # (B, 1, S)
    for probe in (palm, palm - 0.08 * approach, palm + 0.04 * approach):
        d = torch.linalg.vector_norm(probe[..., None, :] - clutter_spheres[:, None, :, :3],
                                     dim=-1) - radius
        d = torch.where(radius > 0, d, torch.inf)
        ok = ok & (torch.amin(d, dim=-1) > clearance)
    return ok


def nearest_grasp_goal(hand_pose, obj_pose, grasps_obj, valid, clutter_spheres=None):
    """Point-matching-nearest reachable grasp, per env.

    hand_pose, obj_pose (B, 4, 4) world; grasps_obj (B, G, 4, 4) in the
    object frame; valid (B, G); `clutter_spheres` (B, S, 4), if given,
    rejects goals buried in clutter. Returns (goal_world (B, 4, 4),
    rel_pose hand -> goal (B, 4, 4), found (B,)). The distance is the mean
    L1 over the 6 finger points, the reference's argmin
    (reference: env/panda_scene.py:1258-1264); the first wins on ties."""
    grasps_w = obj_pose[:, None] @ grasps_obj                  # (B, G, 4, 4)
    ok = reachable_grasp_mask(grasps_w, valid)
    if clutter_spheres is not None and clutter_spheres.shape[1] > 0:
        ok = ok & clutter_clear_mask(grasps_w, clutter_spheres)
    rel = se3_inverse(hand_pose)[:, None] @ grasps_w
    p1 = const(HAND_FINGER_POINTS, hand_pose.device)  # (3, 6)
    p2 = rel[..., :3, :3] @ p1 + rel[..., :3, 3:]
    dist = torch.abs(p1 - p2).sum(dim=-2).mean(dim=-1)         # (B, G)
    dist = torch.where(ok, dist, 1e9)
    best = torch.argmin(dist, dim=1)
    rows = torch.arange(hand_pose.shape[0], device=hand_pose.device)
    return grasps_w[rows, best], rel[rows, best], ok.any(dim=1)
