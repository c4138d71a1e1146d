"""The env with the CHOMP planner expert (`EnvParams(use_planner=True)`,
the default) in the port against the JAX package, on the CPU, at the
dryrun's small sizes (a 32x32 camera, 58 sampled points, 10 substeps,
a 20-substep settle) on the YCB proxy library.

Bounds and why:
- `reset_scene` from the same scenes and observation draws: `valid_scene`
  and `plan_ok` equal (the planner's verdict enters `valid_scene`), and
  each env's plan against JAX's by tests/torch_env_common.py's chaos
  rule (`plan_bounds`: PLAN_TOL = 1e-5, or, where the reference's own
  plan is chaotic, CHAOS_FACTOR times its spread): the spread is JAX's
  `replan` from its reset state with the arm's joints nudged by one ulp
  (NUDGES times). On these scenes 7 of 8 plans agree to 1e-6 (JAX's own
  spread 7e-7) and one, whose plan fails (`plan_ok` False), departs by
  1.7e-3 where JAX's nudges spread it by 1.7e-3: the target spheres'
  hinge flips within the descent.
- `replan` of the port from the JAX reset state itself, by the same rule.
- the planner expert from the JAX reset state: `expert_action`
  (`plan_action` on the plan) within 1e-5, `expert_steps` equal
  (PLAN_STEPS).
- one `step_batched` from the JAX reset state with those actions:
  `plan_step` equal to JAX's (+1), `plan` and `plan_ok` carried bit for
  bit; `retract_batched` leaves the plan fields as they are, as the JAX
  package's does (gaddpg_tpu/envs/grasp_env.py:775-813).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.envs import EnvParams as JaxEnvParams
from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu.physics.types import PhysicsParams as JaxPhysicsParams
from gaddpg_tpu.render.camera import CameraParams as JaxCameraParams
from gaddpg_tpu_torch.envs.grasp_env import EnvParams
from gaddpg_tpu_torch.expert.chomp import PLAN_STEPS
from gaddpg_tpu_torch.physics.types import PhysicsParams
from gaddpg_tpu_torch.render.camera import CameraParams
from torch_env_common import (
    make_envs, nudged_joints, observe_draws, plan_bounds, port_state, scenes,
)

SEEDS = tuple(range(8))
SMALL = dict(uniform_num_pts=58, pc_capacity=128, new_points_per_step=32, settle_substeps=20)
NUDGES = 8


@pytest.fixture(scope="module")
def envs():
    jparams = JaxEnvParams(physics=JaxPhysicsParams(substeps=10),
                           camera=JaxCameraParams(width=32, height=32), **SMALL)
    params = EnvParams(physics=PhysicsParams(substeps=10),
                       camera=CameraParams(width=32, height=32), **SMALL)
    assert jparams.use_planner and params.use_planner
    return make_envs(jassets.library_from_index("ycb", "train"), jparams, params)


@pytest.fixture(scope="module")
def reset(envs):
    jenv, env = envs
    sc = scenes(jenv, SEEDS)
    keys = jnp.stack([jax.random.PRNGKey(100 + s) for s in SEEDS])
    jst, job = jax.jit(jax.vmap(jenv.reset_scene))(sc, keys)
    p = env.p
    draws = observe_draws(jax.vmap(lambda k: jax.random.fold_in(k, 17))(keys), jst.pc.count,
                          p.pc_capacity, p.new_points_per_step, p.uniform_num_pts)
    st, ob = env.reset_scene(sc, draws=draws)
    return jst, st


@pytest.fixture(scope="module")
def nudged(envs, reset):
    """JAX's own replans (NUDGES, B, S, 7) from its reset states with the
    arm's joints nudged by one ulp."""
    jenv, _ = envs
    rep = nudged_joints(reset[0], NUDGES, 0)
    return np.asarray(jax.jit(jax.vmap(jenv.replan))(rep).plan).reshape(
        NUDGES, len(SEEDS), PLAN_STEPS, 7)


def _check_plans(label, plan, jst, nudged):
    err, spread, bound = plan_bounds(plan.numpy(), jst.plan, nudged)
    print(f"{label}: departures {err.tolist()}, JAX's own one-ulp spreads {spread.tolist()}, "
          f"bounds {bound.tolist()}")
    assert (err <= bound).all()


def test_planner_reset_matches_jax(reset, nudged):
    jst, st = reset
    np.testing.assert_array_equal(st.valid_scene.numpy(), np.asarray(jst.valid_scene))
    np.testing.assert_array_equal(st.plan_ok.numpy(), np.asarray(jst.plan_ok))
    assert st.plan_ok.any() and not st.plan_ok.all()  # both verdicts occur
    assert not (st.valid_scene & ~st.plan_ok).any()   # a failed plan voids the scene
    _check_plans("reset plans", st.plan, jst, nudged)
    np.testing.assert_array_equal(st.plan_step.numpy(), np.asarray(jst.plan_step))


def test_replan_from_the_jax_state_matches_jax(envs, reset, nudged):
    _, env = envs
    jst = reset[0]
    st = env.replan(port_state(jst))
    _check_plans("replans", st.plan, jst, nudged)
    np.testing.assert_array_equal(st.plan_ok.numpy(), np.asarray(jst.plan_ok))
    assert (st.plan_step == 0).all()


def test_planner_expert_and_plan_step_match_jax(envs, reset):
    jenv, env = envs
    jst = reset[0]
    st = port_state(jst)
    acts = env.expert_action(st)
    j_acts = jax.vmap(jenv.expert_action)(jst)
    np.testing.assert_allclose(acts.numpy(), np.asarray(j_acts), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(env.expert_steps(st).numpy(),
                                  np.asarray(jax.vmap(jenv.expert_steps)(jst)))
    assert (env.expert_steps(st) == PLAN_STEPS).all()
    keys = jnp.stack([jax.random.PRNGKey(200 + s) for s in SEEDS])
    j_new = jax.jit(jenv.step_batched)(jst, j_acts, keys)[0]
    new = env.step_batched(st, torch.as_tensor(np.array(j_acts)), torch.Generator().manual_seed(0))[0]
    np.testing.assert_array_equal(new.plan_step.numpy(), np.asarray(j_new.plan_step))
    assert (new.plan_step == 1).all()
    for k in ("plan", "plan_ok"):
        np.testing.assert_array_equal(getattr(new, k).numpy(), np.asarray(getattr(j_new, k)))
    retracted, _ = env.retract_batched(new)
    for k in ("plan", "plan_ok", "plan_step"):
        assert torch.equal(getattr(retracted, k), getattr(new, k)), k
