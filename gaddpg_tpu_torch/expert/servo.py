"""Goal-servo expert: standoff approach, then straight insertion
(counterpart of gaddpg_tpu/expert/servo.py).

Clipped task-space actions toward the grasp goal, with the OMG
planner's standoff structure (standoff_dist = 0.08,
reference: experiments/config.py:220, env/panda_scene.py:198).
"""

import torch

from gaddpg_tpu_torch.geometry.rotations import mat_to_euler
from gaddpg_tpu_torch.geometry.se3 import se3_inverse
from gaddpg_tpu_torch.models.heads import TASK6D_HIGH
from gaddpg_tpu_torch.utils.constants import const

STANDOFF_DIST = 0.08


def expert_plan_length(rel_goal, max_step: int = 20):
    """Rough step count the servo needs (B,) from the hand -> goal
    transforms (B, 4, 4) (reference: core/train_online.py:226-229)."""
    t_dist = torch.linalg.vector_norm(rel_goal[..., :3, 3], dim=-1)
    return torch.clamp(torch.ceil(t_dist / 0.04) + 4.0, 6.0, float(max_step))


def expert_action(hand_pose, goal_pose):
    """(B, 6) [dt(3), euler(3)] actions in the hand frame toward the goals.

    Moves to a standoff pose STANDOFF_DIST behind the grasp along its
    approach (+z) axis, and drives straight in once the hand is on the
    insertion corridor; clipped to the task-space action box."""
    standoff = goal_pose.clone()
    standoff[..., :3, 3] = goal_pose[..., :3, 3] + (-STANDOFF_DIST * goal_pose[..., :3, 2])
    hand_inv = se3_inverse(hand_pose)
    rel_final = hand_inv @ goal_pose
    rel_stand = hand_inv @ standoff
    # hand position in the goal frame: on the corridor it sits at
    # (0, 0, -d), d in [0, STANDOFF]
    g = se3_inverse(goal_pose) @ hand_pose
    lateral = torch.linalg.vector_norm(g[..., :2, 3], dim=-1)
    along = g[..., 2, 3]
    aligned = torch.diagonal(rel_final[..., :3, :3], dim1=-2, dim2=-1).sum(-1) > 2.9
    on_corridor = ((lateral < 0.02) & (along > -STANDOFF_DIST - 0.03) & (along < 0.01)
                   & aligned)
    rel = torch.where(on_corridor[..., None, None], rel_final, rel_stand)
    action = torch.cat([rel[..., :3, 3], mat_to_euler(rel[..., :3, :3])], dim=-1)
    high = const(TASK6D_HIGH, action.device, action.dtype)
    return torch.minimum(torch.maximum(action, -high), high)
