"""Accumulated point-cloud state (counterpart of
gaddpg_tpu/render/pointcloud.py).

Each step's backprojected target points enter a world-frame reservoir
with a retention ratio of 0.95^step on the new points; the policy state
resamples 1024 of them into the hand frame beside the 6 hand anchor
points (reference: env/panda_scene.py:698-714,1178-1206). Channel 3 of
the state labels the anchors 1, target points 0 and, in clutter scenes,
obstacle points -1: an extension past the reference's target-only cloud,
whose clutter policies are collision-blind (reference:
env/panda_scene.py:1078-1095), so that the policy can see what it must
avoid.

The reservoir ring-writes contiguously from slot 0, so its valid region
is [0, min(count, capacity)): insertion is a prefix-sum scatter and
sampling a plain gather, no sorts. The random draws are explicit inputs
(`keep_u`, `idx`), so the same draws reproduce the JAX package's.
"""

import dataclasses

import torch

from gaddpg_tpu_torch.geometry.gripper import HAND_FINGER_POINTS
from gaddpg_tpu_torch.utils.constants import const

TARGET_LABEL = 0.0
HAND_LABEL = 1.0
OBSTACLE_LABEL = -1.0


@dataclasses.dataclass
class PointCloudState:
    points: torch.Tensor   # (B, CAP, 3) world frame
    labels: torch.Tensor   # (B, CAP) label per point
    count: torch.Tensor    # (B,) int32: points ever kept
    cursor: torch.Tensor   # (B,) int32 ring cursor


def create_pc_state(batch: int, capacity: int = 2048, device="cpu") -> PointCloudState:
    return PointCloudState(
        points=torch.zeros((batch, capacity, 3), device=device),
        labels=torch.zeros((batch, capacity), device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
        cursor=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def num_valid(pc: PointCloudState):
    return torch.clamp(pc.count, max=pc.points.shape[1])


def accumulate_points(pc: PointCloudState, keep_u, new_points, new_valid, env_step,
                      accumulate_ratio: float = 0.95,
                      label: float = TARGET_LABEL) -> PointCloudState:
    """Keep the new points (B, n, 3) whose uniform draw keep_u (B, n) is
    below accumulate_ratio**env_step, among the valid ones, and
    ring-write them over the oldest entries, labelled `label`
    (TARGET_LABEL or OBSTACLE_LABEL)."""
    b, n = keep_u.shape
    cap = pc.points.shape[1]
    ratio = const((accumulate_ratio,), keep_u.device)
    keep_frac = torch.pow(ratio, env_step.to(torch.float32))
    keep = (keep_u < keep_frac[:, None]) & new_valid
    slot = torch.cumsum(keep, dim=1) - 1
    n_keep = keep.sum(dim=1).to(torch.int32)
    idx = torch.where(keep, (pc.cursor[:, None] + slot) % cap, cap)   # cap = dropped
    points = torch.cat([pc.points, pc.points.new_zeros(b, 1, 3)], dim=1)
    points = points.scatter(1, idx[..., None].expand(b, n, 3), new_points)[:, :cap]
    labels = torch.cat([pc.labels, pc.labels.new_zeros(b, 1)], dim=1)
    labels = labels.scatter(1, idx, torch.full_like(keep_u, label))[:, :cap]
    return PointCloudState(points=points, labels=labels, count=pc.count + n_keep,
                           cursor=(pc.cursor + n_keep) % cap)


def build_point_state(pc: PointCloudState, idx, ef_pose_inv):
    """The (B, 4, 6 + N) policy point state in the hand frame from the
    reservoir entries idx (B, N) (each below max(num_valid, 1)), and the
    number of TARGET points in the reservoir (B,) int32."""
    n_valid = num_valid(pc)
    b = idx.shape[0]
    sampled = torch.gather(pc.points, 1, idx[..., None].expand(*idx.shape, 3))
    slabels = torch.gather(pc.labels, 1, idx)
    local = sampled @ ef_pose_inv[:, :3, :3].transpose(-1, -2) + ef_pose_inv[:, None, :3, 3]
    have = (n_valid > 0)[:, None]
    local = torch.where(have[..., None], local, 0.0)
    slabels = torch.where(have, slabels, 0.0)
    hand_pts = const(HAND_FINGER_POINTS, idx.device).T.expand(b, 6, 3)
    pts = torch.cat([hand_pts, local], dim=1)
    flags = torch.cat([torch.full((b, 6), HAND_LABEL, device=idx.device), slabels], dim=1)
    state = torch.cat([pts, flags[..., None]], dim=-1).transpose(1, 2)
    in_range = torch.arange(pc.labels.shape[1], device=idx.device) < n_valid[:, None]
    n_target = ((pc.labels == TARGET_LABEL) & in_range).sum(dim=1).to(torch.int32)
    return state.contiguous(), n_target
