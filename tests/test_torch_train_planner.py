"""The rollout's DAgger replan under the CHOMP expert (`dagger=True`,
`EnvParams(use_planner=True)`), held step by step from the JAX rollout's
own carry, as tests/test_torch_train.py::test_rollout_steps_from_the_jax_carry
holds the servo expert's rollout (same dryrun sizes, schedule and draws).

The JAX rollout program runs its `lax.scan` body as one jitted step per
iteration (the scan itself takes minutes to compile on this CPU with the
planner inside), from a reset made by the port and carried over into the
JAX package's `EnvState`. Each step's carry (the states going into
`step_batched`, after the JAX DAgger replan, the actions, the keys, and
what the step returns) is recorded through a debug callback. Then the
port's `RolloutWorker._step` runs from the JAX carry as it stood before
that step's DAgger replan (the reset at step 0, then the previous step's
output with finished envs frozen), with the same observations, done
flags and draws, so that the port's own replan runs: the envs it
replanned and their plan_step exactly as JAX's (plan_step after the
step), every DAgger replan against the JAX one by
tests/torch_env_common.py's chaos rule (PLAN_TOL, or CHAOS_FACTOR times
JAX's own spread under one-ulp nudges of the arm's joints), `plan_ok`
exact, the plans of the other envs bit for bit; masks, flags and
actions against the JAX transition (the expert's actions within 1e-5
where the plans agree); and the env step against the JAX step at
tests/test_torch_env.py's bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu.agents.state import create_agent_state as jax_create_agent_state
from gaddpg_tpu.envs import EnvParams as JaxEnvParams
from gaddpg_tpu.envs import PandaGraspEnv as JaxPandaGraspEnv
from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu.envs import grasp_env as jax_grasp_env
from gaddpg_tpu.physics import types as jax_types
from gaddpg_tpu.physics.types import PhysicsParams as JaxPhysicsParams
from gaddpg_tpu.render.camera import CameraParams as JaxCameraParams
from gaddpg_tpu.render.pointcloud import PointCloudState as JaxPointCloudState
from gaddpg_tpu.train import config as jax_config
from gaddpg_tpu.train.rollout import RolloutWorker as JaxRolloutWorker
from gaddpg_tpu_torch.agents import AgentConfig, from_flax
from gaddpg_tpu_torch.envs.assets import LIBRARY_FIELDS, library_from_arrays
from gaddpg_tpu_torch.envs.grasp_env import PandaGraspEnv
from gaddpg_tpu_torch.expert.chomp import PLAN_STEPS
from gaddpg_tpu_torch.physics.types import map_tensors
from gaddpg_tpu_torch.train import RolloutWorker, load_config
from test_torch_train import (
    A_DT, EXPLORE, N_ENVS, NOISE, ROLLOUT, _port_obs, env_params, port_env_params, to_numpy,
)
from torch_env_common import (
    PLAN_TOL, assert_phys_close, nudged_joints, plan_bounds, point_state_mismatch, port_state,
)

SEED = 1
NUDGES = 16
_JAX_CLASSES = {"phys": jax_types.PhysicsState, "arm": jax_types.ArmState,
                "obj": jax_types.BodyState, "pc": JaxPointCloudState}


def _to_jax(cls, port, extra=None):
    """The JAX dataclass `cls` from a port dataclass of the same fields."""
    kw = dict(extra or {})
    for f in dataclasses.fields(cls):
        if f.name in kw:
            continue
        v = getattr(port, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = _to_jax(_JAX_CLASSES[f.name], v)
        else:
            x = v.numpy()
            kw[f.name] = jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
    return cls(**kw)


def _jax_carry(port_reset):
    """Run the JAX rollout from the port's reset; returns (JAX worker's
    env, its transitions, valid mask and stats as numpy, the per-step
    carry, the port's step draws, the port AgentState, the reset state
    and observations as numpy)."""
    jax_lib = jassets.box_asset(0.06, 0.06, 0.14)
    jparams = env_params(JaxEnvParams, JaxPhysicsParams, JaxCameraParams, planner=True)
    jenv = JaxPandaGraspEnv(jparams, jax_lib)
    jcfg = dataclasses.replace(jax_config.load_config(overrides=ROLLOUT), env=jparams)
    acfg = JaxAgentConfig()
    jstate = jax_create_agent_state(jax.random.PRNGKey(SEED), acfg, npoints=64)
    worker = JaxRolloutWorker(jenv, acfg, jcfg)

    states, obs = port_reset
    n = N_ENVS
    k = dict(clutter_idx=jnp.zeros((n, 0), jnp.int32), clutter_pos=jnp.zeros((n, 0, 3)),
             clutter_quat=jnp.zeros((n, 0, 4)), clutter_linvel=jnp.zeros((n, 0, 3)),
             clutter_angvel=jnp.zeros((n, 0, 3)), vis_seed=jnp.zeros(n, jnp.int32))
    reset = (_to_jax(jax_grasp_env.EnvState, states, k),
             _to_jax(jax_grasp_env.Observation, obs, {"image": jnp.zeros((n, 5, 1, 1))}))

    counts, steps = {}, []

    def record_count(key, n_valid):
        counts[tuple(np.asarray(key).tolist())] = int(n_valid)

    original = jax_grasp_env.build_point_state

    def recording(pc, key, ef_pose_inv, num_pts=1024):
        jax.debug.callback(record_count, key, jnp.minimum(pc.count, pc.points.shape[0]))
        return original(pc, key, ef_pose_inv, num_pts)

    step_batched = jenv.step_batched

    def recording_step(states, actions, keys, requery_goal=None):
        out = step_batched(states, actions, keys, requery_goal=requery_goal)
        jax.debug.callback(lambda *a: steps.append(to_numpy(a)), states, actions, keys, out[0],
                           out[1], out[3], out[4]["collided"])
        return out

    scan = jax.lax.scan

    def stepwise_scan(f, init, xs=None, **kw):
        """The rollout's scan as a loop of one jitted step."""
        if f.__name__ != "step_fn":
            return scan(f, init, xs, **kw)
        body, carry, ys = jax.jit(f), init, []
        for x in xs:
            carry, y = body(carry, x)
            ys.append(y)
        return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)

    key = jax.random.PRNGKey(100 + SEED)
    jax_grasp_env.build_point_state, jax.lax.scan = recording, stepwise_scan
    worker._reset_all, jenv.step_batched = (lambda key, num_envs: reset), recording_step
    try:
        out = to_numpy(worker._rollout(jstate, key, jnp.asarray(EXPLORE), jnp.asarray(NOISE)))
    finally:
        jax_grasp_env.build_point_state, jax.lax.scan = original, scan
        del worker._reset_all, jenv.step_batched

    p = jparams
    tensor = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    draws = []
    kk = jax.random.split(key, 4)[2]
    for _ in range(jcfg.rollout_horizon):
        kk, k1, k2, k3, k4, k5, k_step = jax.random.split(kk, 7)
        keep, idx = [], []
        for sk in jax.random.split(k_step, n):
            k1o, k2o, _ = jax.random.split(jax.random.fold_in(sk, 1), 3)
            keep.append(np.asarray(jax.random.uniform(k1o, (p.new_points_per_step,))))
            c = counts[tuple(np.asarray(k2o).tolist())]
            idx.append(np.asarray(jax.random.randint(k2o, (p.uniform_num_pts,), 0, max(c, 1))))
        perturb = jnp.concatenate([jax.random.uniform(k4, (n, 3), minval=-0.04, maxval=0.04),
                                   jax.random.uniform(k5, (n, 3), minval=-0.2, maxval=0.2)], -1)
        draws.append((tensor(jax.random.uniform(k1, (n, 6))),
                      tensor(jax.random.uniform(k2, (n,))), tensor(jax.random.uniform(k3, (n,))),
                      tensor(perturb), {"keep_u": tensor(np.stack(keep)),
                                        "idx": tensor(np.stack(idx))}))
    kf2 = jax.random.split(jax.random.split(key, 4)[1])[1]
    init_steps = tensor(jax.random.randint(kf2, (n,), jcfg.expert_init_min_step,
                                           max(jcfg.expert_init_max_step, 1)))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    state = from_flax(np_tree(jstate.feat_params), np_tree(jstate.feat_stats),
                      np_tree(jstate.policy_params), AgentConfig(), device="cpu")
    return jenv, out, steps, draws, init_steps, state, to_numpy(reset)


def test_planner_dagger_rollout_steps_from_the_jax_carry():
    jax_lib = jassets.box_asset(0.06, 0.06, 0.14)
    lib = library_from_arrays(jax_lib.names, **{f: np.asarray(getattr(jax_lib, f))
                                                 for f in LIBRARY_FIELDS})
    params = port_env_params(planner=True)
    env = PandaGraspEnv(params, lib, device="cpu")
    cfg = dataclasses.replace(load_config(overrides=ROLLOUT), env=params)
    assert cfg.dagger and params.use_planner
    worker = RolloutWorker(env, AgentConfig(), cfg, device="cpu")
    reset = env.reset(N_ENVS, torch.Generator().manual_seed(SEED))
    (jenv, (j_eps, j_valid, _, j_stats), steps, draws, init_steps, state,
     (pre, obs)) = _jax_carry(reset)
    replan = jax.jit(jax.vmap(jenv.replan))

    ctx = {"explore_env": torch.as_tensor(np.array(j_stats["explore_env"])),
           "expert_init_steps": init_steps.to(torch.int64),
           "plan_len": torch.full((N_ENVS,), float(PLAN_STEPS)), "noise_scale": NOISE}
    done = np.zeros(N_ENVS, bool)
    replans, shares = 0, []
    for t, (jst, j_act, keys, jnew, jobs, jdone, jcollided) in enumerate(steps):
        # `pre` is the JAX carry before this step's DAgger replan, `jst`
        # the states after it: the envs JAX replanned
        redo = ((np.asarray(jst.plan_step) != np.asarray(pre.plan_step))
                | (np.asarray(jst.plan) != np.asarray(pre.plan)).any(axis=(1, 2)))
        st, ob, dn, tr, keep = worker._step(state, ctx, t, port_state(pre), _port_obs(obs),
                                            torch.as_tensor(done), draws[t])
        # the port's own replan: the same envs, plans by the chaos rule
        # against JAX's own one-ulp spread, the other plans as carried
        np.testing.assert_array_equal(st.plan_ok.numpy(), jst.plan_ok, err_msg=str(t))
        np.testing.assert_array_equal(st.plan.numpy()[~redo], jst.plan[~redo], err_msg=str(t))
        agree = np.ones(N_ENVS, bool)  # envs whose DAgger replans agree within PLAN_TOL
        if redo.any():
            replans += int(redo.sum())
            nudged = np.asarray(replan(nudged_joints(pre, NUDGES, t)).plan).reshape(
                NUDGES, N_ENVS, PLAN_STEPS, 7)
            err, spread, bound = plan_bounds(st.plan.numpy(), jst.plan, nudged)
            print(f"step {t}: DAgger replans {np.nonzero(redo)[0].tolist()}, departures "
                  f"{err[redo].tolist()}, JAX one-ulp spreads {spread[redo].tolist()}")
            assert (err[redo] <= bound[redo]).all()
            agree = ~redo | (err <= PLAN_TOL)
        for k in ("expert_flags", "perturb_flags", "timestep", "target_idx", "state_pose",
                  "goal"):
            np.testing.assert_array_equal(tr[k].numpy(), j_eps[k][:, t], err_msg=f"{k} {t}")
        for k in ("expert_action", "action"):
            np.testing.assert_allclose(tr[k].numpy()[agree], j_eps[k][agree, t], rtol=0,
                                       atol=1e-5, err_msg=f"{k} {t}")
        np.testing.assert_array_equal(keep.numpy(), ~done)
        np.testing.assert_array_equal(~done & j_stats["valid_scene"], j_valid[:, t])
        # the env step from the carry; finished envs keep theirs
        kept = lambda new, old: jax.tree_util.tree_map(  # noqa: E731
            lambda a, b: np.where(done.reshape(-1, *[1] * (np.ndim(a) - 1)), b, a), new, old)
        jnew_k = kept(jnew, jst)
        # the env step where the expert's actions agree (a chaotic replan
        # moves its env's action, and so its step, elsewhere)
        m, mt = agree, torch.as_tensor(agree)
        sub = jax.tree_util.tree_map(lambda x: x[m], jnew_k.phys)
        np.testing.assert_allclose(st.phys.arm.q_target.numpy()[m], sub.arm.q_target,
                                   atol=1e-5, err_msg=str(t))
        assert_phys_close(map_tensors(st.phys, lambda x: x[mt]), sub,
                          {"pos": 2e-5, "quat": 2e-5, "linvel": 2e-4, "angvel": 2e-3,
                           "fingers": 2e-5, "arm_q": 2 * A_DT * 2e-3})
        np.testing.assert_array_equal(st.plan_step.numpy(), jnew_k.plan_step)
        np.testing.assert_array_equal(tr["collide"].numpy()[m], jcollided[m])
        live = ~done & agree
        for k in ("ef_pose", "goal_pose"):
            np.testing.assert_allclose(getattr(ob, k).numpy()[live], getattr(jobs, k)[live],
                                       rtol=0, atol=2e-5, err_msg=f"{k} {t}")
        shares.append(point_state_mismatch(ob.point_state[torch.as_tensor(live)],
                                           jobs.point_state[live]))
        np.testing.assert_array_equal(dn.numpy()[m], (done | jdone)[m], err_msg=str(t))
        # the next carry: the JAX rollout's own step, finished envs frozen
        pre, obs = jnew_k, kept(jobs, obs)
        done = done | jdone
    assert replans >= 1, "no DAgger replan on a live env"
    assert max(shares) <= 0.03, shares
