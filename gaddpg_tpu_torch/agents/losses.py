"""Point-matching (PM) losses over gripper control points (counterpart of
gaddpg_tpu/agents/losses.py).

Same math as the reference (reference: core/loss.py:17-31): transform
the 6 canonical control points by predicted and target poses, take the
L1 distance summed over xyz, averaged over points and (masked) batch.
Masks are weights, as in the JAX package, so that an empty mask gives 0.

Under a data-parallel mesh (`mesh=`, `parallel.mesh`) each rank holds
its share of the batch and a loss is its rows' sum over the global
count (the mask's, summed across the ranks), so that the ranks' losses,
and their gradients, add up to the global batch's.
"""

import torch

from gaddpg_tpu_torch.geometry.gripper import (
    control_points_from_euler_trans,
    transform_control_points_qt,
)
from gaddpg_tpu_torch.parallel.mesh import sum_over_ranks, world_of


def global_mean(x, mesh=None):
    """Mean of x over its elements, and over every rank's with a
    data-parallel `mesh` (this rank's share of it)."""
    if mesh is None:
        return x.mean()
    return x.sum() / (x.numel() * world_of(mesh))


def global_sum(x, mesh=None):
    """Sum of x (no gradient), over every rank's with a `mesh`."""
    return sum_over_ranks(mesh, x.detach().sum())


def _masked_mean(x, mask, mesh=None):
    """Mean of x (B, ...) over the items where mask (B,) is true: each
    item's mean over its non-batch axes first, then the weighted mean
    over items; 0 if the mask is empty. With a data-parallel `mesh`, this
    rank's share of the mean over every rank's items."""
    if mask is None:
        return global_mean(x, mesh)
    w = mask.to(x.dtype)
    denom = torch.clamp(global_sum(w, mesh), min=1.0)
    per_item = x.reshape(x.shape[0], -1).mean(dim=-1)
    return (per_item * w).sum() / denom


def goal_pred_loss(pred_qt, goal_qt, mask=None, mesh=None):
    """PM loss between 7-d [quat, trans] grasp predictions and targets
    (reference: core/loss.py:17-23, rotz=True control points)."""
    pred_pts = transform_control_points_qt(pred_qt, rotz=True)
    goal_pts = transform_control_points_qt(goal_qt, rotz=True)
    l1 = (pred_pts - goal_pts).abs().sum(-1)  # (B, 6)
    return _masked_mean(l1, mask, mesh)


def pose_bc_loss(pi, expert_action, mask=None, mesh=None):
    """PM behaviour-cloning loss between 6-d [trans, euler] actions
    (reference: core/loss.py:25-31)."""
    pred_pts = control_points_from_euler_trans(pi[..., 3:6], pi[..., :3])
    gt_pts = control_points_from_euler_trans(expert_action[..., 3:6], expert_action[..., :3])
    l1 = (pred_pts - gt_pts).abs().sum(-1)
    return _masked_mean(l1, mask, mesh)


def collision_bce(logit, target, bound: float = 8.0, mesh=None):
    """Sigmoid binary cross-entropy of the collision-prediction logit
    against the collide_future flag, in the stable log1p form.

    The logit is clipped to [-bound, bound] (no gradient past the clip),
    and the loss is 0 on a batch with no positive label: a one-class aux
    task carries no information, and its constant-sign gradient drifted
    the shared encoder in the JAX package's training runs."""
    logit = torch.clamp(logit, -bound, bound)
    loss = torch.clamp(logit, min=0.0) - logit * target + torch.log1p(torch.exp(-logit.abs()))
    has_pos = (global_sum((target > 0.5).to(loss.dtype), mesh) > 0).to(loss.dtype)
    return has_pos * global_mean(loss, mesh)


def smooth_l1(pred, target, mask=None, beta: float = 1.0, mesh=None):
    """Huber / smooth-L1 (torch F.smooth_l1_loss semantics, beta=1)."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)
    return _masked_mean(loss, mask, mesh)
