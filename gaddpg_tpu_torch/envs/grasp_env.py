"""PandaGraspEnv: the batched 6-DoF grasping env (counterpart of
gaddpg_tpu/envs/grasp_env.py), with the CHOMP planner expert or the goal
servo, in single-object scenes or with `num_clutter` dynamic clutter
bodies.

One env step, for a batch of B envs at once:

    task-space delta action -> warm-started DLS IK -> joint servo targets
    -> `substeps` physics substeps -> wrist-camera point render ->
    accumulation -> 4 x 1030 point state -> termination

The physics of `step_batched`, `step_joint` and `retract_batched` is the
batched model of physics/fast.py (K7 on the card), or physics/multi.py
with clutter. `step` and `retract` give what the JAX package's per-env
functions give for each env: the per-env contact model of
physics/step.py, or physics/multi.py with clutter.

World frame: robot base at the origin on the table plane (z = 0);
objects spawn at x 0.5-0.6, y +-0.125 (reference:
env/panda_gripper_hand_camera.py:32, env/panda_scene.py:1000-1001).

With `use_image` every observation also carries an RGBDM image
(`render_rgbdm`, at the camera's resolution); with `domain_rand` its look
is randomised per episode (albedo, occluder tint, light gain, from the
episode's `vis_seed`) and per frame (pixel noise).

Randomness: `reset` and the steps draw from a `torch.Generator`, or take
the exact draws as tensors (`draws=`), so the JAX package's `jax.random`
draws can be injected for parity. The JAX package derives an episode's
look from `PRNGKey(vis_seed)`; the port derives it from `vis_seed` by a
counter hash (`domain_look`), the same on every device, and parity tests
inject JAX's look as draws.
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from gaddpg_tpu_torch.envs.assets import ObjectLibrary
from gaddpg_tpu_torch.expert.chomp import PLAN_STEPS, plan_action, plan_to_goal
from gaddpg_tpu_torch.expert.goals import nearest_grasp_goal
from gaddpg_tpu_torch.expert.servo import expert_action as servo_expert_action
from gaddpg_tpu_torch.expert.servo import expert_plan_length
from gaddpg_tpu_torch.geometry.rotations import quat_to_mat
from gaddpg_tpu_torch.geometry.se3 import (
    pack_pose_rot_first, se3_from_quat_pos, se3_inverse, unpack_action,
)
from gaddpg_tpu_torch.models.heads import TASK6D_HIGH
from gaddpg_tpu_torch.parallel.mesh import draw_rows
from gaddpg_tpu_torch.physics.fast import fast_physics_step
from gaddpg_tpu_torch.physics.multi import multi_physics_step
from gaddpg_tpu_torch.physics.step import gripper_box_poses, physics_step
from gaddpg_tpu_torch.physics.types import (
    ArmState, BodyState, PhysicsParams, PhysicsState, map_tensors,
)
from gaddpg_tpu_torch.render.camera import (
    CameraParams, box_zdepth, depth_to_points, plane_zdepth, render_depth_points,
    render_rgbdm, spheres_zdepth, visible_target_depth,
)
from gaddpg_tpu_torch.render.pointcloud import (
    OBSTACLE_LABEL, PointCloudState, accumulate_points, build_point_state, create_pc_state,
    num_valid,
)
from gaddpg_tpu_torch.robot import panda
from gaddpg_tpu_torch.robot.ik import dls_ik, ik_from_seeds
from gaddpg_tpu_torch.utils.constants import const
from gaddpg_tpu_torch.utils.precision import f32_matmuls, resolve_device

# camera optical frame relative to the hand: optical +z == hand +z,
# 36 mm forward and up (reference: env/panda_scene.py:200-202, 829-861)
T_CAM = ((1.0, 0.0, 0.0, 0.036), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.036),
         (0.0, 0.0, 0.0, 1.0))
TCP_OFFSET = (0.0, 0.0, 0.13)  # hand origin -> grasp point, hand frame
# domain randomisation's ranges (gaddpg_tpu/envs/grasp_env.py:330-340):
# albedo, occluder tint and light gain per episode, pixel noise per frame
ALBEDO_RANGE = (0.1, 0.95)
OCCLUDER_RANGE = (0.15, 0.85)
LIGHT_GAIN_RANGE = (0.6, 1.4)
IMAGE_NOISE_STD = 0.02
VIS_SEED_HIGH = 2**31 - 1  # vis_seed in [0, int32 max), as the JAX package draws it
_M32 = 0xFFFFFFFF


def _hash_uniforms(seed, count: int):
    """(B, count) uniforms in [0, 1) from integer seeds (B,): a counter
    hash (two rounds of xor-shift-multiply by 0x45d9f3b, mod 2^32) of
    seed * count + k. Integer arithmetic only, so every device gives the
    same values; each product stays below 2^59."""
    x = ((seed.to(torch.int64)[:, None] & _M32) * count
         + torch.arange(count, device=seed.device)) & _M32
    for _ in range(2):
        x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    return (x.to(torch.float64) / 2.0**32).to(torch.float32)


def domain_look(vis_seed):
    """An episode's randomised look from its seeds (B,): (albedo (B, 3),
    occluder colour (B, 3), light gain (B,)), uniform in their ranges."""
    u = _hash_uniforms(vis_seed, 7)
    span = lambda lo_hi, v: lo_hi[0] + (lo_hi[1] - lo_hi[0]) * v  # noqa: E731
    return (span(ALBEDO_RANGE, u[:, 0:3]), span(OCCLUDER_RANGE, u[:, 3:6]),
            span(LIGHT_GAIN_RANGE, u[:, 6]))


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """The JAX package's EnvParams, field for field, with its defaults."""

    physics: PhysicsParams = PhysicsParams()
    # 64x64 wrist camera: the point state is resampled to 1024 points and
    # the reference's termination heuristic is calibrated at 64x64
    # (reference: core/utils.py:340-343)
    camera: CameraParams = CameraParams(width=64, height=64)
    max_steps: int = 20                  # RL_MAX_STEP
    uniform_num_pts: int = 1024
    pt_accumulate_ratio: float = 0.95
    pc_capacity: int = 2048
    new_points_per_step: int = 512
    init_near: float = 0.2               # ENV_NEAR
    init_far: float = 0.5                # ENV_FAR
    spawn_x: Tuple[float, float] = (0.50, 0.60)
    spawn_y: Tuple[float, float] = (-0.125, 0.125)
    # cluttered scenes: K dynamic clutter objects beside the target on a
    # jittered grid (the reference places load_obj_num - 1 obstacles,
    # reference: env/panda_scene.py:995-1035); 0: single-object scenes
    num_clutter: int = 0
    use_planner: bool = True             # CHOMP expert; False: the straight goal servo
    # the grid stays inside the arm's validity envelope (reset requires
    # 0.15 < tcp-target distance < 0.6)
    clutter_grid_x: Tuple[float, float] = (0.45, 0.69)
    clutter_grid_y: Tuple[float, float] = (-0.14, 0.14)
    clutter_jitter: float = 0.015
    # scene candidates per reset; the first valid one is kept
    # (reference: core/train_online.py:180-188)
    reset_tries: int = 2
    # visible clutter surface points per step enter the cloud labelled
    # OBSTACLE_LABEL (render/pointcloud.py); 0: target-only observations
    clutter_points_per_step: int = 256
    step_ik_iters: int = 10
    settle_substeps: int = 200
    termination_heuristics: bool = True
    use_image: bool = False              # emit RGBDM image observations
    # per-episode visual domain randomisation of the image: target albedo,
    # occluder tint (a table-texture proxy), light gain, and per-frame
    # pixel noise (reference: env/panda_scene.py:599-618, 680-690)
    domain_rand: bool = False
    lift_height: float = 0.08            # success (reference: env/panda_scene.py:877)
    fall_height: float = 0.03            # failure (reference: env/panda_scene.py:868)
    retract_lift_steps: int = 10
    retract_step_dz: float = 0.03


@dataclasses.dataclass
class EnvState:
    """A batch of B env states; every field leads with B."""

    phys: PhysicsState
    pc: PointCloudState
    obj_idx: torch.Tensor          # (B,) int64 library index
    env_step: torch.Tensor         # (B,) int32
    init_obj_z: torch.Tensor       # (B,)
    goal_obj: torch.Tensor         # (B, 4, 4) grasp goal in the object frame
    collided: torch.Tensor         # (B,) bool: gripper contact this step
    collided_before: torch.Tensor  # (B,) bool: any contact so far
    done: torch.Tensor             # (B,) bool
    valid_scene: torch.Tensor      # (B,) bool
    # the K dynamic clutter bodies (EnvParams.num_clutter; K = 0 without)
    clutter_idx: torch.Tensor      # (B, K) int64 library indices
    clutter_pos: torch.Tensor      # (B, K, 3)
    clutter_quat: torch.Tensor     # (B, K, 4) wxyz
    clutter_linvel: torch.Tensor   # (B, K, 3)
    clutter_angvel: torch.Tensor   # (B, K, 3)
    plan: torch.Tensor             # (B, PLAN_STEPS, 7) the planner's joint waypoints
    plan_ok: torch.Tensor          # (B,) bool
    plan_step: torch.Tensor        # (B,) int32 progress along the plan
    # the episode's visual-randomisation seed (domain_rand; 0 without),
    # fixed for the episode like the reference's per-episode textures
    vis_seed: torch.Tensor         # (B,) int64

    def to(self, device) -> "EnvState":
        return map_tensors(self, lambda t: t.to(device))


@dataclasses.dataclass
class Observation:
    point_state: torch.Tensor   # (B, 4, 6 + num_pts)
    num_points: torch.Tensor    # (B,) int32 target points in the reservoir
    joint_pos: torch.Tensor     # (B, 9)
    ef_pose: torch.Tensor       # (B, 4, 4) hand in world
    goal_pose: torch.Tensor     # (B, 7) [q, t] hand -> goal
    image: torch.Tensor         # (B, 5, H, W) RGBDM with use_image, else (B, 5, 1, 1) zeros


def _tensor(x, device, dtype=torch.float32):
    """A tensor or array-like (numpy leaves of JAX arrays too) on device."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.array(x))
    return x.to(device, dtype)


def _where(cond, a, b):
    """Per-env select between two states or observations."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _where(cond, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    return torch.where(cond.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def state_from_numpy(tree, device="cuda") -> EnvState:
    """A port EnvState from the numpy leaves of a JAX EnvState given as a
    nested dict (`dataclasses.asdict` of the JAX state with every leaf
    through `np.asarray`), reservoir, plan and clutter bodies included
    (a tree without clutter fields gives K = 0) and the visual seed.
    Lands on the card unless `device="cpu"`, and raises without
    one, as `from_flax` does."""
    device = resolve_device(device)
    t = lambda x, dtype=torch.float32: _tensor(x, device, dtype)
    ph, pc = tree["phys"], tree["pc"]
    b = np.shape(tree["obj_idx"])[0]
    clutter = {k: t(tree[k] if k in tree else np.zeros((b, 0) + shape), dtype)
               for k, shape, dtype in (("clutter_idx", (), torch.int64),
                                       ("clutter_pos", (3,), torch.float32),
                                       ("clutter_quat", (4,), torch.float32),
                                       ("clutter_linvel", (3,), torch.float32),
                                       ("clutter_angvel", (3,), torch.float32))}
    return EnvState(
        phys=PhysicsState(
            arm=ArmState(q=t(ph["arm"]["q"]), qd=t(ph["arm"]["qd"]),
                         q_target=t(ph["arm"]["q_target"])),
            obj=BodyState(pos=t(ph["obj"]["pos"]), quat=t(ph["obj"]["quat"]),
                          linvel=t(ph["obj"]["linvel"]), angvel=t(ph["obj"]["angvel"])),
            contact_force=t(ph["contact_force"]),
            gripper_contact=t(ph["gripper_contact"], torch.bool),
        ),
        pc=PointCloudState(points=t(pc["points"]), labels=t(pc["labels"]),
                           count=t(pc["count"], torch.int32),
                           cursor=t(pc["cursor"], torch.int32)),
        obj_idx=t(tree["obj_idx"], torch.int64),
        env_step=t(tree["env_step"], torch.int32),
        init_obj_z=t(tree["init_obj_z"]),
        goal_obj=t(tree["goal_obj"]),
        collided=t(tree["collided"], torch.bool),
        collided_before=t(tree["collided_before"], torch.bool),
        done=t(tree["done"], torch.bool),
        valid_scene=t(tree["valid_scene"], torch.bool),
        **clutter,
        plan=t(tree["plan"]),
        plan_ok=t(tree["plan_ok"], torch.bool),
        plan_step=t(tree["plan_step"], torch.int32),
        vis_seed=t(tree["vis_seed"], torch.int64),
    )


class PandaGraspEnv:
    """Static params, the object library and a device; every method
    works on a batch of envs and leaves its inputs unchanged.

    With a data-parallel `mesh` (`parallel.mesh`) a batch is this rank's
    share of the envs, and every random draw is made for the global batch
    and sliced to this rank's rows (`draw_rows`), so that rank r's envs
    are envs [r * B, (r + 1) * B) of the one-rank run with the same
    generator state."""

    def __init__(self, params: EnvParams, lib: ObjectLibrary, device="cuda", mesh=None):
        self.p = params
        self.mesh = mesh
        self.device = resolve_device(device)
        self.lib = lib.to(self.device)
        self.t_cam = const(T_CAM, self.device)
        self.action_high = const(TASK6D_HIGH, self.device)
        self.base_pose = torch.eye(4, device=self.device)

    # ------------------------------------------------------------------
    def _hand(self, state: EnvState):
        return panda.fk_hand(state.phys.arm.q[:, :7])

    def _obj_pose(self, obj: BodyState):
        return se3_from_quat_pos(obj.quat, obj.pos)

    def _goal_world(self, state: EnvState):
        return self._obj_pose(state.phys.obj) @ state.goal_obj

    def _clutter_world(self, state: EnvState, local):
        """Object-frame points local (B, K, N, 3) of the clutter bodies in
        the world, (B, K, N, 3)."""
        rot = quat_to_mat(state.clutter_quat)                         # (B, K, 3, 3)
        return local @ rot.transpose(-1, -2) + state.clutter_pos[..., None, :]

    def _clutter_spheres_world(self, state: EnvState):
        """(B, K*NS, 4) world-frame clutter sphere sets (radius 0 = padding)."""
        sph = self.lib.spheres[state.clutter_idx]                     # (B, K, NS, 4)
        out = torch.cat([self._clutter_world(state, sph[..., :3]), sph[..., 3:]], dim=-1)
        return out.reshape(out.shape[0], -1, 4)

    def _clutter_surface_world(self, state: EnvState):
        """(B, K*NP, 3) world-frame clutter surface samples (occluders)."""
        pts = self._clutter_world(state, self.lib.surface_points[state.clutter_idx])
        return pts.reshape(pts.shape[0], -1, 3)

    def _clutter_collision(self, state: EnvState, hand):
        """(B,) True where a gripper box or an arm-skeleton sphere
        penetrates a clutter sphere: the collision event for obstacles. The
        reference queries every robot link, so a forearm sweep through an
        obstacle is a collision too (reference: env/panda_scene.py:1078-1095).
        The JAX package defines it and calls it nowhere: the env's event is
        the physics' gripper-clutter penetration (`_physics_batched`)."""
        p = self.p.physics
        sph = self._clutter_spheres_world(state)                      # (B, S, 4)
        real = sph[..., 3] > 0
        q = state.phys.arm.q
        hit = torch.zeros(q.shape[0], dtype=torch.bool, device=self.device)
        for pose, he in zip(gripper_box_poses(hand, q[:, 7], q[:, 8], p),
                            (p.finger_half_extents, p.finger_half_extents,
                             p.palm_half_extents)):
            local = (sph[..., :3] - pose[:, None, :3, 3]) @ pose[:, :3, :3]
            out = torch.clamp(torch.abs(local) - const(he, self.device), min=0.0)
            d = torch.linalg.vector_norm(out, dim=-1) - sph[..., 3]
            hit = hit | ((d < 0.0) & real).any(dim=1)
        arm_pts = panda.arm_collision_points(q[:, :7])                # (B, N, 3)
        d = (torch.linalg.vector_norm(arm_pts[:, :, None, :] - sph[:, None, :, :3], dim=-1)
             - const(panda.ARM_POINT_RADII, self.device)[:, None] - sph[:, None, :, 3])
        return hit | ((d < 0.0) & real[:, None, :]).flatten(1).any(dim=1)

    def _clutter_mask_spheres(self, state: EnvState):
        """The clutter spheres that reject buried grasp goals, or None in
        single-object scenes."""
        return self._clutter_spheres_world(state) if self.p.num_clutter else None

    def _clutter_bodies(self, state: EnvState) -> BodyState:
        return BodyState(pos=state.clutter_pos, quat=state.clutter_quat,
                         linvel=state.clutter_linvel, angvel=state.clutter_angvel)

    def _body_indices(self, state: EnvState):
        """(B, M) library indices of each env's bodies, the target first."""
        return torch.cat([state.obj_idx[:, None], state.clutter_idx], dim=1)

    def _occluder_depth(self, state: EnvState, hand, cam_pose):
        """Per-pixel z-depth of the table plane, the three gripper boxes
        and the arm's skeleton spheres up to link 7 (the reference's
        full-scene render, reference: env/panda_scene.py:414-436)."""
        p = self.p
        occ = plane_zdepth(p.camera, cam_pose, p.physics.table_z)
        fhe, phe = p.physics.finger_half_extents, p.physics.palm_half_extents
        q = state.phys.arm.q
        for pose, he in zip(gripper_box_poses(hand, q[:, 7], q[:, 8], p.physics),
                            (fhe, fhe, phe)):
            occ = torch.minimum(occ, box_zdepth(p.camera, cam_pose, pose, he))
        # the link7 -> hand spheres envelop the wrist camera itself: left out
        arm_pts = panda.arm_collision_points(q[:, :7])[:, :-3]
        radii = const(panda.ARM_POINT_RADII, hand.device)[:-3]
        return torch.minimum(occ, spheres_zdepth(p.camera, cam_pose, arm_pts, radii))

    def _draw(self, fn, generator, shape, *bounds):
        """fn(*bounds, shape) drawn on the generator's device (the global
        generator of this env's device without one), on this env's device:
        two envs on two devices given generators in the same state draw the
        same. Under a mesh, this rank's rows of the global batch's draw."""
        dev = self.device if generator is None else generator.device
        return draw_rows(self.mesh, lambda s: fn(*bounds, s, generator=generator, device=dev),
                         shape).to(self.device)

    def _rand(self, generator, shape):
        """Uniforms of `shape`, drawn as `_draw` says."""
        return self._draw(torch.rand, generator, shape)

    def _randn(self, generator, shape):
        """Standard normals, drawn as `_rand` draws its uniforms."""
        return self._draw(torch.randn, generator, shape)

    def _image(self, state: EnvState, cam_inv, surf_w, occ, generator, draws):
        """The RGBDM images (B, 5, H, W): a pseudo-albedo per object index;
        under domain_rand the episode's look (`domain_look(vis_seed)`, or
        draws' "albedo", "occluder_color", "light_gain") and the frame's
        noise (draws' "image_noise" (B, 3, H, W), else the generator)."""
        p, dev = self.p, self.device
        oi = state.obj_idx.to(torch.float32)[:, None]
        albedo = 0.35 + 0.6 * torch.abs(torch.sin(oi * const((1.7, 2.9, 4.3), dev)
                                                  + const((0.0, 2.0, 4.0), dev)))
        rand = {}
        if p.domain_rand:
            if draws is not None and "albedo" in draws:
                look = [draws[k].to(dev) for k in ("albedo", "occluder_color", "light_gain")]
            else:
                look = domain_look(state.vis_seed)
            albedo, occluder, gain = look
            b, h, w = albedo.shape[0], p.camera.height, p.camera.width
            noise = (draws["image_noise"].to(dev) if draws is not None
                     else self._randn(generator, (b, 3, h, w)))
            rand = dict(occluder_color=occluder, light_gain=gain, noise=noise,
                        noise_std=IMAGE_NOISE_STD)
        return render_rgbdm(p.camera, cam_inv, surf_w, albedo, occ_depth=occ, **rand)

    def _observe_impl(self, state: EnvState, generator=None, draws=None):
        """(state with the new reservoir, observation, the occlusion-culled
        target depth images that _termination reads). `draws`: {"keep_u":
        (B, new_points_per_step), "idx": (B, uniform_num_pts)}, with
        clutter "clutter_keep_u": (B, clutter_points_per_step), and under
        domain_rand "image_noise" (B, 3, H, W) (`_image`)."""
        p = self.p
        b = state.obj_idx.shape[0]
        hand = self._hand(state)
        obj_pose = self._obj_pose(state.phys.obj)
        surf = self.lib.surface_points[state.obj_idx]                     # (B, NP, 3)
        surf_w = surf @ obj_pose[:, :3, :3].transpose(-1, -2) + obj_pose[:, None, :3, 3]
        cam = hand @ self.t_cam
        cam_inv = se3_inverse(hand @ self.t_cam)
        occ_static = self._occluder_depth(state, hand, cam)
        occ = occ_static
        if p.num_clutter:
            csurf_w = self._clutter_surface_world(state)
            cd = render_depth_points(p.camera, cam_inv, csurf_w)
            occ = torch.minimum(occ_static, torch.where(cd > 0, cd, torch.inf))
        vis_depth = visible_target_depth(p.camera, cam_inv, surf_w, occ_depth=occ)
        pts_cam, pts_valid = depth_to_points(p.camera, vis_depth, p.new_points_per_step)
        pts_w = pts_cam @ cam[:, :3, :3].transpose(-1, -2) + cam[:, None, :3, 3]

        keep_u = (draws["keep_u"].to(self.device) if draws is not None
                  else self._rand(generator, (b, p.new_points_per_step)))
        pc = accumulate_points(state.pc, keep_u, pts_w, pts_valid, state.env_step,
                               p.pt_accumulate_ratio)
        if p.num_clutter and p.clutter_points_per_step:
            # the visible clutter surface enters the cloud labelled as
            # obstacle, occluded by the static occluders and by the target
            td = render_depth_points(p.camera, cam_inv, surf_w)
            occ_c = torch.minimum(occ_static, torch.where(td > 0, td, torch.inf))
            vis_c = visible_target_depth(p.camera, cam_inv, csurf_w, occ_depth=occ_c)
            cpts_cam, cvalid = depth_to_points(p.camera, vis_c, p.clutter_points_per_step)
            cpts_w = cpts_cam @ cam[:, :3, :3].transpose(-1, -2) + cam[:, None, :3, 3]
            ckeep_u = (draws["clutter_keep_u"].to(self.device) if draws is not None
                       else self._rand(generator, (b, p.clutter_points_per_step)))
            pc = accumulate_points(pc, ckeep_u, cpts_w, cvalid, state.env_step,
                                   p.pt_accumulate_ratio, label=OBSTACLE_LABEL)
        if draws is not None:
            idx = draws["idx"].to(self.device, torch.int64)
        else:
            u = self._rand(generator, (b, p.uniform_num_pts))
            n = torch.clamp(num_valid(pc), min=1)[:, None]
            idx = torch.minimum((u * n).to(torch.int64), n - 1)
        point_state, n_pts = build_point_state(pc, idx, se3_inverse(hand))
        if p.use_image:
            image = self._image(state, cam_inv, surf_w, occ, generator, draws)
        else:
            image = torch.zeros((b, 5, 1, 1), device=self.device)

        goal_rel = se3_inverse(hand) @ self._goal_world(state)
        obs = Observation(point_state=point_state, num_points=n_pts,
                          joint_pos=state.phys.arm.q, ef_pose=hand,
                          goal_pose=pack_pose_rot_first(goal_rel), image=image)
        return dataclasses.replace(state, pc=pc), obs, vis_depth

    # ------------------------------------------------------------------
    def _grid_cells(self):
        """The 9 cell centres (9, 2) of the 4 x 4 clutter grid lines, cell
        3 i + j at (x centre i, y centre j)."""
        p, dev = self.p, self.device
        gx = torch.linspace(*p.clutter_grid_x, 4, device=dev)
        gy = torch.linspace(*p.clutter_grid_y, 4, device=dev)
        cx, cy = (gx[:-1] + gx[1:]) / 2, (gy[:-1] + gy[1:]) / 2
        return torch.stack(torch.meshgrid(cx, cy, indexing="ij"), dim=-1).reshape(-1, 2)

    def _rand_index(self, generator, shape):
        """Uniform library indices of `shape`."""
        n = self.lib.num_objects
        return torch.clamp((self._rand(generator, shape) * n).to(torch.int64), max=n - 1)

    @f32_matmuls
    def sample_scene(self, batch: int, generator=None, draws=None, obj_idx=None):
        """Randomise `batch` scenes (reference: env/panda_scene.py:995-1035,
        777-827): a yawed object in the spawn box and an arm start on a
        sphere shell around it, looking at it, solved with IK from the
        anchor seeds. With num_clutter = K > 0 the target and K clutter
        objects land on distinct cells of a jittered 3 x 3 grid instead:
        a deterministic minimum separation (the reference rejection-samples
        pairwise distances, reference: env/panda_scene.py:1008-1024).
        `draws` replaces the random values: a dict of (B,) tensors x, y,
        yaw, theta, phi, r, (B, 3) jitter and obj_idx, and with clutter
        (B, 9) perm (a permutation of the cells), (B, K + 1, 2)
        cell_jitter, (B, K) clutter_idx and clutter_yaw. `obj_idx` (an int
        or (B,)) fixes the target object in place of the drawn one.
        Returns a scene dict for `reset_scene`."""
        p, dev = self.p, self.device
        k = p.num_clutter
        if draws is not None:
            d = {name: v.to(dev) for name, v in draws.items()}
        else:
            def u(lo, hi, shape=(batch,)):
                return lo + self._rand(generator, shape) * (hi - lo)
            d = {"x": u(*p.spawn_x), "y": u(*p.spawn_y), "yaw": u(-math.pi, math.pi),
                 "theta": u(0.0, 2 * math.pi / 3), "phi": u(math.pi / 2, 3 * math.pi / 2),
                 "r": u(p.init_near, p.init_far), "jitter": u(-0.03, 0.03, (batch, 3)),
                 "obj_idx": self._rand_index(generator, (batch,))}
            if k:
                d.update(perm=torch.argsort(self._rand(generator, (batch, 9)), dim=1),
                         cell_jitter=u(-p.clutter_jitter, p.clutter_jitter, (batch, k + 1, 2)),
                         clutter_idx=self._rand_index(generator, (batch, k)),
                         clutter_yaw=u(-math.pi, math.pi, (batch, k)))
        if obj_idx is not None:
            d["obj_idx"] = torch.as_tensor(obj_idx, device=dev).expand(batch)
        obj_idx = d["obj_idx"].to(torch.int64)
        yaw = d["yaw"]
        zero = torch.zeros_like(yaw)
        quat = torch.stack([torch.cos(yaw / 2), zero, zero, torch.sin(yaw / 2)], dim=-1)
        if k:
            chosen = (self._grid_cells()[d["perm"][:, :k + 1].to(torch.int64)]
                      + d["cell_jitter"])                             # (B, K + 1, 2)
            x, y = chosen[:, 0, 0], chosen[:, 0, 1]
            clutter_idx = d["clutter_idx"].to(torch.int64)
            c_yaw = d["clutter_yaw"]
            c_zero = torch.zeros_like(c_yaw)
            clutter_quat = torch.stack([torch.cos(c_yaw / 2), c_zero, c_zero,
                                        torch.sin(c_yaw / 2)], dim=-1)
            clutter_pos = torch.cat([chosen[:, 1:],
                                     self.lib.rest_height[clutter_idx][..., None]], dim=-1)
        else:
            x, y = d["x"], d["y"]
            clutter_idx = torch.zeros((batch, 0), dtype=torch.int64, device=dev)
            clutter_quat = torch.zeros((batch, 0, 4), device=dev)
            clutter_pos = torch.zeros((batch, 0, 3), device=dev)
        pos = torch.stack([x, y, self.lib.rest_height[obj_idx] + 2e-3], dim=-1)

        theta, phi = d["theta"], d["phi"]
        offset = d["r"][:, None] * torch.stack(
            [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
             torch.cos(theta)], dim=-1)
        trans = pos + offset + d["jitter"]
        trans = torch.stack([torch.clamp(trans[:, 0], 0.0, 0.5),
                             torch.clamp(trans[:, 1], -0.3, 0.3),
                             torch.clamp(trans[:, 2], 0.2, 0.6)], dim=-1)
        z_axis = pos - trans
        z_axis = z_axis / torch.clamp(torch.linalg.vector_norm(z_axis, dim=-1, keepdim=True),
                                      min=1e-6)
        up = const((0.0, 0.0, -1.0), dev).expand_as(z_axis)
        x_axis = torch.linalg.cross(up, z_axis, dim=-1)
        x_norm = torch.linalg.vector_norm(x_axis, dim=-1, keepdim=True)
        x_axis = torch.where(x_norm > 1e-3, x_axis / torch.clamp(x_norm, min=1e-6),
                             const((1.0, 0.0, 0.0), dev))
        y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
        rot = torch.stack([x_axis, y_axis, z_axis], dim=-1)
        q_init, ik_ok = ik_from_seeds(trans, rot)
        q_init = torch.where(ik_ok[:, None], q_init, const(panda.DEFAULT_JOINTS, dev))
        return {"obj_idx": obj_idx, "obj_pos": pos, "obj_quat": quat, "joints": q_init,
                "ik_ok": ik_ok, "clutter_idx": clutter_idx, "clutter_pos": clutter_pos,
                "clutter_quat": clutter_quat}

    @f32_matmuls
    def reset_scene(self, scene, generator=None, draws=None):
        """Deterministic reset of a batch from a scene dict (the
        scene-file protocol, reference: env/panda_scene.py:336-343): obj_idx
        (B,), obj_pos (B, 3), obj_quat (B, 4), joints (B, 7), optional
        ik_ok (B,), and with clutter clutter_idx (B, K), clutter_pos
        (B, K, 3), clutter_quat (B, K, 4), as `sample_scene` or the JAX
        package's `sample_scene` (vmapped, numpy leaves) give them. A scene
        without clutter keys parks the clutter bodies at z = 1e3, where
        they cannot touch the episode. The object settles for
        `settle_substeps` substeps of the batched physics (one K7 launch),
        jointly with the clutter bodies when there are any (physics/multi.py)
        so that initial penetrations relax before step 0. `draws`: the
        first observation's, as `_observe_impl` takes them, and under
        domain_rand "vis_seed" (B,), the episode's visual seed (else drawn
        from `generator`; 0 without domain_rand). Returns (state, obs)."""
        p, dev = self.p, self.device
        t = lambda k, dtype=torch.float32: _tensor(scene[k], dev, dtype)
        obj_idx = t("obj_idx", torch.int64)
        b = obj_idx.shape[0]
        ik_ok = (t("ik_ok", torch.bool) if "ik_ok" in scene
                 else torch.ones(b, dtype=torch.bool, device=dev))
        q = torch.cat([t("joints"), torch.full((b, 2), 0.04, device=dev)], dim=1)
        zeros3 = torch.zeros(b, 3, device=dev)
        phys = PhysicsState(
            arm=ArmState(q=q, qd=torch.zeros(b, 7, device=dev), q_target=q),
            obj=BodyState(pos=t("obj_pos"), quat=t("obj_quat"), linvel=zeros3, angvel=zeros3),
            contact_force=torch.zeros(b, device=dev),
            gripper_contact=torch.zeros(b, dtype=torch.bool, device=dev),
        )
        k = p.num_clutter
        far = torch.zeros(b, k, 3, device=dev)
        far[..., 2] = 1e3
        ident = torch.zeros(b, k, 4, device=dev)
        ident[..., 0] = 1.0
        clutter_idx = (t("clutter_idx", torch.int64) if k and "clutter_idx" in scene
                       else torch.zeros(b, k, dtype=torch.int64, device=dev))
        clutter_pos = t("clutter_pos") if k and "clutter_pos" in scene else far
        clutter_quat = t("clutter_quat") if k and "clutter_quat" in scene else ident
        zeros_k = torch.zeros(b, k, 3, device=dev)
        if k:
            idx = torch.cat([obj_idx[:, None], clutter_idx], dim=1)
            phys, clut, _ = multi_physics_step(
                p.physics, phys, self.lib.spheres[idx], self.lib.coarse_spheres[idx],
                self.lib.mass[idx], self.lib.inertia[idx],
                BodyState(pos=clutter_pos, quat=clutter_quat, linvel=zeros_k, angvel=zeros_k),
                substeps=p.settle_substeps)
            clutter_pos, clutter_quat = clut.pos, clut.quat
        else:
            phys = fast_physics_step(p.physics, phys, self.lib.spheres[obj_idx],
                                     self.lib.mass[obj_idx], self.lib.inertia[obj_idx],
                                     substeps=p.settle_substeps)
        false = torch.zeros(b, dtype=torch.bool, device=dev)
        vis_seed = torch.zeros(b, dtype=torch.int64, device=dev)
        if p.domain_rand:
            vis_seed = (draws["vis_seed"].to(dev, torch.int64) if draws is not None else
                        self._draw(torch.randint, generator, (b,), 0, VIS_SEED_HIGH))
        state = EnvState(
            phys=phys, pc=create_pc_state(b, p.pc_capacity, dev), obj_idx=obj_idx,
            env_step=torch.zeros(b, dtype=torch.int32, device=dev),
            init_obj_z=phys.obj.pos[:, 2],
            goal_obj=torch.eye(4, device=dev).repeat(b, 1, 1),
            collided=false, collided_before=false, done=false,
            valid_scene=torch.ones(b, dtype=torch.bool, device=dev),
            clutter_idx=clutter_idx, clutter_pos=clutter_pos, clutter_quat=clutter_quat,
            clutter_linvel=zeros_k, clutter_angvel=zeros_k,
            plan=q[:, None, :7].repeat(1, PLAN_STEPS, 1),
            plan_ok=torch.ones(b, dtype=torch.bool, device=dev),
            plan_step=torch.zeros(b, dtype=torch.int32, device=dev),
            vis_seed=vis_seed,
        )
        state = self._update_goal(state)
        if p.use_planner:
            state = self.replan(state)
        state, obs, _ = self._observe_impl(state, generator, draws)

        # scene validity (reference: core/utils.py:132-149): tcp distance in
        # range, enough target points, IK solvable, a reachable grasp, and
        # a plan (the reference drops episodes whose planner fails,
        # reference: core/train_online.py:227-229)
        hand = self._hand(state)
        tcp = hand[:, :3, 3] + hand[:, :3, :3] @ const(TCP_OFFSET, dev)
        dist = torch.linalg.vector_norm(phys.obj.pos - tcp, dim=-1)
        goal_w, _, grasp_found = nearest_grasp_goal(
            hand, self._obj_pose(state.phys.obj), self.lib.grasps[obj_idx],
            self.lib.grasp_valid[obj_idx], clutter_spheres=self._clutter_mask_spheres(state))
        _, goal_reachable = ik_from_seeds(goal_w[:, :3, 3], goal_w[:, :3, :3], iters=20)
        # the reference's 100-point check scales with the camera's pixels
        min_pts = max(8, (50 * p.camera.height * p.camera.width) // 4096)
        valid = (ik_ok & (dist > 0.15) & (dist < 0.6) & (obs.num_points > min_pts)
                 & grasp_found & goal_reachable & state.plan_ok)
        return dataclasses.replace(state, valid_scene=valid), obs

    @f32_matmuls
    def reset(self, batch: int, generator=None, draws=None, obj_idx=None):
        """Randomised reset of `batch` envs: up to `reset_tries` scene
        candidates, the first valid one kept per env
        (reference: core/train_online.py:180-188). `draws`, if given, is a
        list of one (scene draws, observation draws) pair per try;
        `obj_idx` fixes the target object (`sample_scene`)."""
        state = obs = None
        for r in range(max(self.p.reset_tries, 1)):
            scene_d, obs_d = (None, None) if draws is None else draws[r]
            scene = self.sample_scene(batch, generator, scene_d, obj_idx)
            st, ob = self.reset_scene(scene, generator, obs_d)
            if state is None:
                state, obs = st, ob
            else:
                keep_old = state.valid_scene
                state, obs = _where(keep_old, state, st), _where(keep_old, obs, ob)
        return state, obs

    # ------------------------------------------------------------------
    def _update_goal(self, state: EnvState) -> EnvState:
        """Re-query the nearest reachable grasp unless a collision froze
        it (reference: env/panda_scene.py:1280-1286)."""
        obj_pose = self._obj_pose(state.phys.obj)
        goal_w, _, found = nearest_grasp_goal(
            self._hand(state), obj_pose, self.lib.grasps[state.obj_idx],
            self.lib.grasp_valid[state.obj_idx],
            clutter_spheres=self._clutter_mask_spheres(state))
        goal_obj = se3_inverse(obj_pose) @ goal_w
        keep_old = state.collided_before | ~found
        return dataclasses.replace(
            state, goal_obj=torch.where(keep_old[:, None, None], state.goal_obj, goal_obj))

    def _apply_action(self, state: EnvState, action):
        """Task-space delta -> IK -> servo targets
        (reference: env/panda_scene.py:740-775)."""
        action = torch.minimum(torch.maximum(action, -self.action_high), self.action_high)
        target = self._hand(state) @ unpack_action(action)
        q_arm, _, _ = dls_ik(state.phys.arm.q[:, :7], target[:, :3, 3], target[:, :3, :3],
                             iters=self.p.step_ik_iters)
        return self._with_targets(
            state, torch.cat([q_arm, torch.full_like(q_arm[:, :2], 0.04)], dim=1))

    def _physics_multi(self, state: EnvState, substeps=None) -> EnvState:
        """The target, the clutter bodies and the arm through
        physics/multi.py; the collision event is the physical robot-obstacle
        contact (reference: env/panda_scene.py:1078-1095): gripper contact
        with the target or a clutter body."""
        idx = self._body_indices(state)
        lib = self.lib
        phys, clut, hits = multi_physics_step(
            self.p.physics, state.phys, lib.spheres[idx], lib.coarse_spheres[idx],
            lib.mass[idx], lib.inertia[idx], self._clutter_bodies(state), substeps=substeps)
        state = dataclasses.replace(state, clutter_pos=clut.pos, clutter_quat=clut.quat,
                                    clutter_linvel=clut.linvel, clutter_angvel=clut.angvel)
        return self._with_physics(state, phys, phys.gripper_contact | hits)

    def _with_physics(self, state: EnvState, phys, collided) -> EnvState:
        return dataclasses.replace(state, phys=phys, collided=collided,
                                   collided_before=state.collided_before | collided)

    def _physics_batched(self, state: EnvState, substeps=None) -> EnvState:
        """The batched physics: physics/fast.py (K7 on the card), or
        physics/multi.py with clutter."""
        if self.p.num_clutter:
            return self._physics_multi(state, substeps)
        idx = state.obj_idx
        phys = fast_physics_step(self.p.physics, state.phys, self.lib.spheres[idx],
                                 self.lib.mass[idx], self.lib.inertia[idx], substeps=substeps)
        return self._with_physics(state, phys, phys.gripper_contact)

    def _physics(self, state: EnvState, substeps=None) -> EnvState:
        """The per-env contact model of the JAX package's `_physics`:
        physics/step.py with the base pose, or physics/multi.py with
        clutter."""
        if self.p.num_clutter:
            return self._physics_multi(state, substeps)
        idx = state.obj_idx
        phys = physics_step(self.p.physics, state.phys, self.lib.spheres[idx],
                            self.lib.mass[idx], self.lib.inertia[idx], self.base_pose,
                            substeps=substeps)
        return self._with_physics(state, phys, phys.gripper_contact)

    def _termination(self, state: EnvState, depth_img):
        """Depth heuristic, max steps, fallen target
        (reference: env/panda_scene.py:496-521)."""
        p = self.p
        h, w = p.camera.height, p.camera.width
        d = torch.where(depth_img > 0, depth_img, 10.0)
        roi = d[:, int(38.0 * h / 64):, int(24.0 * w / 64): int(48.0 * w / 64)]
        depth_h = ((roi < 0.045).sum(dim=(1, 2)) > 10) & p.termination_heuristics
        fallen = (state.phys.obj.pos[:, 2] - state.init_obj_z) < -p.fall_height
        timeout = state.env_step >= p.max_steps
        return depth_h | fallen | timeout

    # ------------------------------------------------------------------
    @f32_matmuls
    def step_batched(self, state: EnvState, actions, generator=None, draws=None,
                     requery_goal=None):
        """One policy step of every env: (state, obs, reward, done, info).

        `requery_goal` (B,) bool re-picks the nearest grasp this step (the
        reference re-queries only for explore episodes,
        reference: core/train_online.py:253); None re-picks for all.
        `draws`: the observation's, as `_observe_impl` takes them."""
        return self._step(self._physics_batched, state, actions, generator, draws, requery_goal)

    @f32_matmuls
    def step(self, state: EnvState, actions, generator=None, draws=None):
        """The JAX package's per-env `step` for each of B envs: the action,
        `substeps` substeps of the per-env contact model (physics/step.py,
        or physics/multi.py with clutter), the goal re-query, the
        observation and termination. Returns (state, obs, reward, done,
        info) as `step_batched` does."""
        return self._step(self._physics, state, actions, generator, draws)

    def _step(self, physics, state, actions, generator, draws, requery_goal=None):
        state = self._apply_action(state, actions)
        state = physics(state)
        new_goal = self._update_goal(state)
        if requery_goal is None:
            state = new_goal
        else:
            state = dataclasses.replace(state, goal_obj=torch.where(
                requery_goal[:, None, None], new_goal.goal_obj, state.goal_obj))
        state, obs, vis_depth = self._observe_impl(state, generator, draws)
        done = self._termination(state, vis_depth)
        state = dataclasses.replace(state, env_step=state.env_step + 1,
                                    plan_step=state.plan_step + 1, done=state.done | done)
        info = {
            "collided": state.collided,
            "goal_dist": torch.linalg.vector_norm(obs.goal_pose[:, 4:7], dim=-1),
            "point_num": obs.num_points,
            "obj_z": state.phys.obj.pos[:, 2],
        }
        return state, obs, torch.zeros(actions.shape[0], device=self.device), state.done, info

    @staticmethod
    def _with_targets(state: EnvState, q_target) -> EnvState:
        return dataclasses.replace(state, phys=dataclasses.replace(
            state.phys, arm=dataclasses.replace(state.phys.arm, q_target=q_target)))

    @f32_matmuls
    def step_joint(self, state: EnvState, q_targets, generator=None, draws=None):
        """The joint-space action variant (PandaJointSpace, reference:
        env/panda_scene.py:744-747): absolute 9-dof targets q_targets (B, 9)
        bypass the task-space IK; the batched physics, the goal re-query
        and the observation follow, with no termination. Returns (state,
        obs)."""
        state = self._update_goal(self._physics_batched(self._with_targets(state, q_targets)))
        state, obs, _ = self._observe_impl(state, generator, draws)
        return dataclasses.replace(state, env_step=state.env_step + 1,
                                   plan_step=state.plan_step + 1), obs

    @f32_matmuls
    def retract_batched(self, state: EnvState):
        """Close the fingers for 2 x substeps, lift 10 x 3 cm, score the
        lift (reference: env/panda_scene.py:455-494), through the batched
        physics. Returns (state, lifted (B,) float)."""
        return self._retract(self._physics_batched, state, 2 * self.p.physics.substeps)

    @f32_matmuls
    def retract(self, state: EnvState):
        """The JAX package's per-env `retract` for each of B envs: close the
        fingers for 300 substeps, then lift 10 x 3 cm, each through the
        per-env contact model (`step`'s), and score the lift. Returns
        (state, reward (B,) float)."""
        return self._retract(self._physics, state, 300)

    def _retract(self, physics, state: EnvState, close_substeps: int):
        p = self.p
        q_t = state.phys.arm.q_target.clone()
        q_t[:, 7:9] = 0.0
        state = physics(self._with_targets(state, q_t), substeps=close_substeps)
        lift = const((0.0, 0.0, p.retract_step_dz), self.device)
        for _ in range(p.retract_lift_steps):
            hand = self._hand(state)
            q_arm, _, _ = dls_ik(state.phys.arm.q[:, :7], hand[:, :3, 3] + lift,
                                 hand[:, :3, :3], iters=p.step_ik_iters)
            state = physics(self._with_targets(
                state, torch.cat([q_arm, torch.zeros_like(q_arm[:, :2])], dim=1)))
        lifted = (state.phys.obj.pos[:, 2] - state.init_obj_z) > p.lift_height
        return state, lifted.to(torch.float32)

    # ------------------------------------------------------------------
    def plan_inputs(self, state: EnvState) -> dict:
        """`plan_to_goal`'s arguments for every env: the current joints, the
        grasp goal, the table, the clutter's spheres in the world frame as
        obstacles (none in single-object scenes), and the target's own
        spheres in the world frame, which repel the approach."""
        obj_pose = self._obj_pose(state.phys.obj)
        sph = self.lib.spheres[state.obj_idx]
        target = torch.cat([sph[..., :3] @ obj_pose[:, :3, :3].transpose(-1, -2)
                            + obj_pose[:, None, :3, 3], sph[..., 3:]], dim=-1)
        return dict(q0=state.phys.arm.q[:, :7], goal_pose=self._goal_world(state),
                    obstacle_spheres=self._clutter_spheres_world(state),
                    table_z=self.p.physics.table_z, target_spheres=target)

    @f32_matmuls
    def replan(self, state: EnvState) -> EnvState:
        """(Re)plan every env's expert trajectory from its current joints
        to its current grasp goal around the clutter (the reference replans
        mid-episode for DAgger, reference: env/panda_scene.py:920-993)."""
        plan, ok = plan_to_goal(**self.plan_inputs(state))
        return dataclasses.replace(state, plan=plan, plan_ok=ok,
                                   plan_step=torch.zeros_like(state.plan_step))

    @f32_matmuls
    def expert_action(self, state: EnvState):
        """The expert's (B, 6) actions: the plan's next waypoint with
        `use_planner`, else the goal servo."""
        if self.p.use_planner:
            return plan_action(self._hand(state), state.plan, state.plan_step)
        return servo_expert_action(self._hand(state), self._goal_world(state))

    @f32_matmuls
    def expert_steps(self, state: EnvState):
        """The expert's step count (B,): the plan's length with
        `use_planner`, else the servo's rough remaining count."""
        if self.p.use_planner:
            return torch.full(state.env_step.shape, float(PLAN_STEPS), device=self.device)
        rel = se3_inverse(self._hand(state)) @ self._goal_world(state)
        return expert_plan_length(rel, self.p.max_steps)
