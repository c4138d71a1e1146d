"""The clutter env (num_clutter = 2 dynamic bodies, physics/multi.py) on the
CPU against the JAX package's, from the same states and random draws, at
the flagship dryrun tier's sizes (`__graft_entry__.py:183-246`: 10
substeps, a 32 x 32 camera, 16 obstacle points a step) with the goal
servo on the YCB proxy library; tests/test_clutter_expert.py's env
contracts held by the port at the full EnvParams sizes; and a CPU smoke
of the clutter train tier. sample_scene, reset_scene and the clutter
grasp mask are held in tests/test_torch_clutter_reset.py, the other entry
points in test_torch_clutter_step.py, test_torch_clutter_retract.py and
test_torch_clutter_plan.py (each file within a minute).

Bounds and why:
- step_batched, each of two calls from the port's reset carried to the
  JAX package (`torch_env_common.jax_state`), then from the JAX state: the
  bounds of tests/test_torch_env.py's step_batched (the arm within two
  servo quanta; the objects within the contact scan's bounds), for the
  clutter bodies too, done and collided (gripper contact or a clutter
  hit) equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.envs import EnvParams as JaxEnvParams
from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu.physics.types import PhysicsParams as JaxPhysicsParams
from gaddpg_tpu.render.camera import CameraParams as JaxCameraParams
from gaddpg_tpu_torch.envs.assets import AssetSpec, box_asset, build_library
from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv
from gaddpg_tpu_torch.expert.chomp import PLAN_STEPS
from gaddpg_tpu_torch.physics.types import PhysicsParams
from gaddpg_tpu_torch.render.camera import CameraParams
from gaddpg_tpu_torch.render.pointcloud import OBSTACLE_LABEL, TARGET_LABEL
from test_torch_env import A_DT, _reservoir_share
from torch_env_common import (
    assert_phys_close, env_observe_draws, jax_state, make_envs, port_state,
)

SEEDS = (0, 1, 2, 3)
K = 2
# the flagship dryrun tier's env sizes, the goal servo
SIZES = dict(uniform_num_pts=58, pc_capacity=128, new_points_per_step=32,
             clutter_points_per_step=16, settle_substeps=20, max_steps=3, reset_tries=2,
             retract_lift_steps=2, use_planner=False, num_clutter=K)
BODY_BOUNDS = {"pos": 2e-5, "quat": 2e-5, "linvel": 2e-4, "angvel": 2e-3}


def clutter_params(jax_side=False, **kw):
    """The flagship tier's EnvParams (the JAX package's with `jax_side`)."""
    if jax_side:
        return JaxEnvParams(physics=JaxPhysicsParams(substeps=10),
                            camera=JaxCameraParams(width=32, height=32), **{**SIZES, **kw})
    return EnvParams(physics=PhysicsParams(substeps=10), camera=CameraParams(width=32, height=32),
                     **{**SIZES, **kw})


@pytest.fixture(scope="module")
def envs():
    return make_envs(jassets.library_from_index("ycb", "train"), clutter_params(True),
                     clutter_params())


def assert_clutter_close(st, jst, bounds=BODY_BOUNDS):
    np.testing.assert_array_equal(st.clutter_idx.numpy(), np.asarray(jst.clutter_idx))
    for name, tol in bounds.items():
        np.testing.assert_allclose(getattr(st, f"clutter_{name}").numpy(),
                                   np.asarray(getattr(jst, f"clutter_{name}")), atol=tol, rtol=0,
                                   err_msg=f"clutter {name}")


def obstacle_counts(labels, count):
    """Obstacle-labelled points among each reservoir's valid entries."""
    labels, count = np.asarray(labels), np.asarray(count)
    valid = np.arange(labels.shape[1])[None] < np.minimum(count, labels.shape[1])[:, None]
    return ((labels == OBSTACLE_LABEL) & valid).sum(axis=1)


def assert_counts_close(a, b):
    assert (np.abs(a - b) <= 0.01 * b + 2).all(), (a, b)


@pytest.fixture(scope="module")
def start(envs):
    """The port's reset of 4 envs (seeded) carried to the JAX package."""
    st, _ = envs[1].reset(len(SEEDS), torch.Generator().manual_seed(8))
    return st, jax_state(st)


@pytest.fixture(scope="module")
def jax_steps(envs, start):
    """Two JAX step_batched calls from the reset with the servo's actions."""
    jenv, _ = envs
    jst = start[1]
    jstep = jax.jit(jenv.step_batched)
    out = []
    for i in range(2):
        acts = jax.vmap(jenv.expert_action)(jst)
        keys = jnp.stack([jax.random.PRNGKey(1000 * i + s) for s in SEEDS])
        new = jstep(jst, acts, keys)
        out.append((jst, acts, keys, *new[:2], *new[3:]))
        jst = new[0]
    return out


def test_step_batched_matches_jax(envs, jax_steps):
    jenv, env = envs
    shares = []
    for jprev, acts, keys, jst, jobs, jdone, jinfo in jax_steps:
        draws = env_observe_draws(jenv, jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys),
                                  jst.pc.count)
        st, obs, _, done, info = env.step_batched(port_state(jprev),
                                                  torch.as_tensor(np.array(acts)), draws=draws)
        np.testing.assert_allclose(st.phys.arm.q_target.numpy(),
                                   np.asarray(jst.phys.arm.q_target), atol=1e-5)
        assert_phys_close(st.phys, jst.phys, {**BODY_BOUNDS, "fingers": 2e-5,
                                              "arm_q": 2 * A_DT * 2e-3})
        assert_clutter_close(st, jst)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(st.collided.numpy(), np.asarray(jst.collided))
        n, jn = obs.num_points.numpy(), np.asarray(jobs.num_points)
        assert_counts_close(n, jn)
        assert_counts_close(obstacle_counts(st.pc.labels, st.pc.count),
                            obstacle_counts(jst.pc.labels, jst.pc.count))
        shares += _reservoir_share(obs, jst, jobs)
        np.testing.assert_allclose(info["obj_z"].numpy(), np.asarray(jinfo["obj_z"]), atol=2e-5)
    assert max(shares) <= 0.03, shares


def test_obstacle_labels_in_point_state(envs, jax_steps):
    """Obstacle points enter the point state labelled -1; the target-point
    count (the validity check's) counts target points alone."""
    jenv, env = envs
    jprev, acts, keys, jst = jax_steps[-1][:4]
    draws = env_observe_draws(jenv, jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys),
                              jst.pc.count)
    st, obs, *_ = env.step_batched(port_state(jprev), torch.as_tensor(np.array(acts)),
                                   draws=draws)
    flags = obs.point_state[:, 3].numpy()
    assert set(np.unique(flags)) <= {OBSTACLE_LABEL, TARGET_LABEL, 1.0}
    assert (flags == OBSTACLE_LABEL).any()
    cap = st.pc.labels.shape[1]
    valid = torch.arange(cap) < torch.clamp(st.pc.count, max=cap)[:, None]
    np.testing.assert_array_equal(obs.num_points.numpy(),
                                  ((st.pc.labels == TARGET_LABEL) & valid).sum(dim=1).numpy())


# ---- tests/test_clutter_expert.py's env contracts, on the port --------------------------

@pytest.fixture(scope="module")
def full():
    """EnvParams(num_clutter=2, the planner, one reset try) on a box, four
    envs reset from a seeded generator."""
    env = PandaGraspEnv(EnvParams(num_clutter=2, use_planner=True, reset_tries=1),
                        box_asset(0.05, 0.05, 0.12), device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(4, gen)
    return env, gen, state, obs


def test_reset_contract(full):
    _, _, state, obs = full
    assert state.clutter_idx.shape == (4, 2) and state.clutter_pos.shape == (4, 2, 3)
    assert state.plan.shape == (4, PLAN_STEPS, 7)
    assert obs.point_state.shape == (4, 4, 1030)
    sep = (state.clutter_pos[:, 0, :2] - state.clutter_pos[:, 1, :2]).norm(dim=-1)
    assert (sep > 0.05).all(), sep


def test_clutter_points_labeled_in_obs(full):
    env, _, state, _ = full
    gen = torch.Generator().manual_seed(7)
    for _ in range(4):  # a few steps accumulate both classes
        state, obs, _, _, info = env.step_batched(state, torch.zeros(4, 6), gen)
        flags = obs.point_state[:, 3]
        if (flags == OBSTACLE_LABEL).any():
            break
    assert set(flags.unique().tolist()) <= {0.0, 1.0, OBSTACLE_LABEL}
    assert (flags == OBSTACLE_LABEL).any(), "no obstacle points seen"
    assert (info["point_num"] > 0).any()


def test_clutter_collision_event(full):
    env, _, state, _ = full
    hand = env._hand(state)
    assert not env._clutter_collision(state, hand).any()
    pos = state.clutter_pos.clone()
    pos[:, 0] = hand[:, :3, 3] + (hand[:, :3, :3] @ torch.tensor([0.0, 0.0, 0.03]))
    assert env._clutter_collision(dataclasses.replace(state, clutter_pos=pos), hand).all()


def test_clutter_is_dynamic(full):
    env, _, state, _ = full
    pos = state.clutter_pos.clone()
    pos[:, 0, 2] += 0.10
    lifted = dataclasses.replace(state, clutter_pos=pos)
    stepped = env._physics(lifted)                      # 150 ms of simulation
    drop = lifted.clutter_pos[:, 0, 2] - stepped.clutter_pos[:, 0, 2]
    assert (drop > 0.05).all(), drop
    hold = (stepped.clutter_pos[:, 1] - state.clutter_pos[:, 1]).norm(dim=-1)
    assert (hold < 0.01).all(), hold
    assert not stepped.collided.any()                   # a falling obstacle is no robot event


def test_clutter_occludes_target(full):
    env, _, state, _ = full
    hand = env._hand(state)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    _, obs_clear, _ = env._observe_impl(state, gen())
    front = hand[:, :3, 3] + hand[:, :3, :3] @ torch.tensor([0.0, 0.0, 0.1])
    blocked = dataclasses.replace(
        state, clutter_pos=front[:, None].expand_as(state.clutter_pos).clone(),
        pc=dataclasses.replace(state.pc, points=torch.zeros_like(state.pc.points),
                               count=torch.zeros_like(state.pc.count),
                               cursor=torch.zeros_like(state.pc.cursor)))
    _, obs_blocked, _ = env._observe_impl(blocked, gen())
    assert (obs_blocked.num_points < torch.clamp(obs_clear.num_points, min=1)).all()


def test_online_training_smoke_in_dynamic_clutter(tmp_path):
    """One collect and one train_iter of the clutter tier on the CPU:
    td3_clutter.yaml at toy scale, the flagship tier's env sizes with the
    planner, boxes and a cylinder (the JAX tier's procedural meshes are
    not ported)."""
    from gaddpg_tpu_torch import replay
    from gaddpg_tpu_torch.train import Trainer, load_config

    cfg = load_config("experiments/cfgs/td3_clutter.yaml", overrides={
        "num_remotes": 4, "batch_size": 4, "updates_per_step": 1, "RL_MEMORY_SIZE": 64,
        "ONPOLICY_MEMORY_SIZE": 64, "max_steps": 3, "extend_steps": 1,
        "output_dir": str(tmp_path)}, policy="DDPG")
    assert cfg.env.num_clutter == 2 and cfg.env.use_planner and cfg.dagger
    cfg = dataclasses.replace(cfg, env=clutter_params(use_planner=True))
    lib = build_library([AssetSpec("box", "box", (0.06, 0.06, 0.14), 0.2),
                         AssetSpec("cyl", "cylinder", (0.035, 0.12), 0.3)])
    tr = Trainer(cfg, lib=lib, device="cpu")
    for _ in range(5):  # tiny clutter scenes are often invalid
        stats = tr.collect()
        inserted = replay.upper_idx(tr.buffer) + replay.upper_idx(tr.online_buffer)
        if inserted:
            break
    assert inserted > 0 and all(np.isfinite(v) for v in stats.values())
    metrics = tr.train_iter()
    assert all(np.isfinite(v) for v in metrics.values())
