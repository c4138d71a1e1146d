"""Transport-agnostic real-robot control loop (counterpart of
gaddpg_tpu/deploy/runner.py).

The reference's deployment node (`core/test_realworld_ros_final.py`,
`ImageListener.run_network` :475-708) interleaves: frame ingestion ->
target masking -> point-state construction -> `agent.select_action` ->
cartesian command -> cage-point termination -> retract. This module is
that logic over plain numpy frames, so any transport (ROS node, gRPC
bridge, offline bag replay, the simulator) can drive it.

Phases mirror the reference loop:
  APPROACH  policy deltas until the termination heuristic fires or the
            step budget runs out
  RETRACT   close + emit straight-up lift deltas for `retract_steps`
  DONE      no-op
"""

import dataclasses

import numpy as np
import torch

from gaddpg_tpu_torch.agents.ddpg import make_select_action
from gaddpg_tpu_torch.deploy.realworld import RealsenseStateBuilder
from gaddpg_tpu_torch.utils.precision import resolve_device


@dataclasses.dataclass
class Frame:
    """One camera frame + kinematic snapshot from the robot."""

    depth: np.ndarray          # (H, W) metres
    target_mask: np.ndarray    # (H, W) bool / {0,1}
    intrinsics: np.ndarray     # (3, 3)
    cam_to_world: np.ndarray   # (4, 4)
    hand_to_world: np.ndarray  # (4, 4)


@dataclasses.dataclass
class Command:
    """Hand-frame command for the executor (MoveIt/servo/sim)."""

    delta_pose: np.ndarray     # (6,) [dx dy dz r p y] hand frame
    close_gripper: bool
    phase: str                 # APPROACH | RETRACT | DONE


class PolicyRunner:
    """Drives a trained agent from camera frames to hand commands.

    `agent_state` must lie on `device`. `seed` seeds the generator the
    runner hands to `select_action` (used only if exploring)."""

    def __init__(self, agent_state, agent_cfg, max_steps: int = 20,
                 retract_steps: int = 10, retract_dz: float = 0.03,
                 num_pts: int = 1024, seed: int = 0,
                 termination: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.agent_state = agent_state
        self.select = make_select_action(agent_cfg, self.device)
        self.max_steps = max_steps
        self.retract_steps = retract_steps
        self.retract_dz = retract_dz
        self.termination = termination
        self.builder = RealsenseStateBuilder(num_pts=num_pts)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.reset()

    def reset(self):
        self.builder.reset()
        self.step = 0
        self.retract_step = 0
        self.phase = "APPROACH"

    def __call__(self, frame: Frame) -> Command:
        """One control tick (the reference's timer callback)."""
        if self.phase == "DONE":
            return Command(np.zeros(6), True, "DONE")

        if self.phase == "RETRACT":
            self.retract_step += 1
            if self.retract_step >= self.retract_steps:
                self.phase = "DONE"
            # straight-up lift in the WORLD frame, expressed in the hand
            # frame (reference retract: env/panda_scene.py:455-483)
            r_wh = frame.hand_to_world[:3, :3]
            dz_hand = r_wh.T @ np.array([0.0, 0.0, self.retract_dz])
            return Command(
                np.concatenate([dz_hand, np.zeros(3)]).astype(np.float32),
                True, "RETRACT",
            )

        self.builder.update(
            frame.depth, frame.intrinsics, frame.target_mask,
            frame.cam_to_world,
        )
        world_to_hand = np.linalg.inv(frame.hand_to_world)
        point_state = self.builder.state(world_to_hand)

        terminate = self.step >= self.max_steps or (
            self.termination
            and self.builder.termination_heuristic(
                frame.depth, frame.target_mask
            )
        )
        if terminate:
            self.phase = "RETRACT"
            return Command(np.zeros(6), True, "RETRACT")

        remain = np.float32(max(self.max_steps - self.step, 1))
        action, _ = self.select(
            self.agent_state,
            torch.from_numpy(point_state)[None].to(self.device),
            torch.tensor([remain], device=self.device),
            self.generator,
        )
        self.step += 1
        return Command(action[0].cpu().numpy().astype(np.float32), False, "APPROACH")
