"""Real-camera point-state construction (no ROS dependency).

The port's own numpy copy of gaddpg_tpu/deploy/realworld.py: the same
builder, so both packages turn the same frames into the same state.

Keeps the sim<->real state contract (SURVEY.md section 3.5): the policy
consumes `state[0][0]` = 4 x (6 + 1024) points -- 6 hand anchors flagged
in channel 3 + 1024 target points in the hand frame -- regardless of
whether depth came from the simulated wrist camera or a RealSense.
"""

from typing import Optional

import numpy as np

from gaddpg_tpu_torch.geometry.gripper import HAND_FINGER_POINTS


def backproject_depth(depth: np.ndarray, intrinsics: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Depth (H, W) metres + K (3,3) -> (N, 3) camera-frame points.

    `mask` selects target pixels (True = keep). Pinhole convention:
    +z forward, +x right, +y down (same as the reference's
    `backproject_camera_target_realworld`, core/utils.py:474-491,
    without the OpenGL y-flip).
    """
    h, w = depth.shape
    keep = depth > 0
    if mask is not None:
        keep &= mask.astype(bool)
    v, u = np.nonzero(keep)
    z = depth[v, u]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    return np.stack([x, y, z], axis=-1)


class RealsenseStateBuilder:
    """Accumulating point-state builder for real-robot rollouts.

    Mirrors the sim pipeline: per-frame target points -> world-frame
    accumulation with per-step decay -> resample to num_pts -> hand
    frame + 6 anchor points.
    """

    def __init__(self, num_pts: int = 1024, accumulate_ratio: float = 0.95,
                 capacity: int = 20000, rng: Optional[np.random.Generator] = None):
        self.num_pts = num_pts
        self.ratio = accumulate_ratio
        self.capacity = capacity
        self.rng = rng or np.random.default_rng(0)
        self.reset()

    def reset(self):
        self.points = np.zeros((0, 3), np.float32)
        self.step = 0

    def update(self, depth: np.ndarray, intrinsics: np.ndarray,
               target_mask: np.ndarray, cam_to_world: np.ndarray):
        """Add one frame's target points (world frame)."""
        pts_cam = backproject_depth(depth, intrinsics, target_mask)
        if len(pts_cam):
            pts_w = pts_cam @ cam_to_world[:3, :3].T + cam_to_world[:3, 3]
            n_keep = int(round(self.ratio ** self.step * len(pts_w)))
            if n_keep:
                idx = self.rng.choice(len(pts_w), size=n_keep, replace=False)
                self.points = np.concatenate([pts_w[idx], self.points])[: self.capacity]
        self.step += 1

    def state(self, world_to_hand: np.ndarray) -> np.ndarray:
        """(4, 6 + num_pts) policy point state in the hand frame."""
        out = np.zeros((4, 6 + self.num_pts), np.float32)
        out[:3, :6] = np.asarray(HAND_FINGER_POINTS)
        out[3, :6] = 1.0
        if len(self.points):
            if len(self.points) >= self.num_pts:
                idx = self.rng.choice(len(self.points), self.num_pts, replace=False)
            else:
                idx = self.rng.choice(len(self.points), self.num_pts, replace=True)
            local = self.points[idx] @ world_to_hand[:3, :3].T + world_to_hand[:3, 3]
            out[:3, 6:] = local.T
        return out

    def termination_heuristic(self, depth: np.ndarray, target_mask: np.ndarray,
                              thresh: float = 0.045, min_pixels: int = 10) -> bool:
        """Cage-point termination: enough target pixels within grasp depth
        in the lower-center ROI (reference: core/test_realworld_ros_final.py
        :1023-1060 / env/panda_scene.py:496-521)."""
        h, w = depth.shape
        d = np.where(target_mask.astype(bool) & (depth > 0), depth, 10.0)
        roi = d[int(38 * h / 64):, int(24 * w / 64): int(48 * w / 64)]
        return int((roi < thresh).sum()) > min_pixels
