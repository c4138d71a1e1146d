"""The CHOMP planner among clutter on the CPU against the JAX package's:
`replan` with the clutter bodies' 2 x 32 spheres as obstacles (the port's
`plan_inputs` passes them as the JAX `replan` does), from the port's
clutter reset at the flagship dryrun tier's sizes carried to the JAX
package by `torch_env_common.jax_state`; and the clutter env's joint-space
`step_joint` from tests/test_torch_clutter_step.py's states.

Bounds and why: each env's plan by tests/torch_env_common.py's chaos
rule (`plan_bounds`: PLAN_TOL = 1e-5, or, where the reference's own plan
is chaotic, CHAOS_FACTOR times its spread over NUDGES replans from the
arm's joints nudged by one ulp), `plan_ok` equal, `plan_step` reset to 0.
`step_joint` (absolute targets, one policy step of 10 substeps, the JAX
draws) by tests/test_torch_clutter_step.py's step bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu_torch.expert.chomp import PLAN_STEPS
from test_torch_clutter_env import clutter_params
from test_torch_clutter_step import (  # noqa: F401  (module fixtures)
    assert_step_close, envs, keys_of, start,
)
from torch_env_common import env_observe_draws, jax_state, make_envs, nudged_joints, plan_bounds

B = 6
NUDGES = 8


@pytest.fixture(scope="module")
def replans():
    jenv, env = make_envs(jassets.library_from_index("ycb", "train"),
                          clutter_params(True, use_planner=True),
                          clutter_params(use_planner=True))
    st, _ = env.reset(B, torch.Generator().manual_seed(9))
    jst = jax_state(st)
    jreplan = jax.jit(jax.vmap(jenv.replan))
    ref = jreplan(jst)
    nudged = np.stack([np.asarray(jreplan(nudged_joints(jst, 1, seed)).plan)
                       for seed in range(NUDGES)])
    return env, st, env.replan(st), ref, nudged


def test_clutter_obstacles_reach_the_planner(replans):
    env, st, *_ = replans
    obst = env.plan_inputs(st)["obstacle_spheres"]
    assert obst.shape == (B, 2 * env.lib.spheres.shape[1], 4)
    assert (obst[..., 3] > 0).any(dim=1).all()
    np.testing.assert_allclose(obst.numpy(), env._clutter_spheres_world(st).numpy())


def test_clutter_replan_matches_jax(replans):
    _, _, new, ref, nudged = replans
    err, spread, bound = plan_bounds(new.plan.numpy(), ref.plan, nudged)
    print(f"clutter replans: departures {err.tolist()}, JAX's own one-ulp spreads "
          f"{spread.tolist()}, bounds {bound.tolist()}")
    assert (err <= bound).all()
    np.testing.assert_array_equal(new.plan_ok.numpy(), np.asarray(ref.plan_ok))
    assert new.plan.shape == (B, PLAN_STEPS, 7) and (new.plan_step == 0).all()


def test_step_joint_matches_jax(envs, start):
    jenv, env = envs
    st, jst = start
    q_t = st.phys.arm.q.clone()
    q_t[:, 1] += 0.05
    q_t[:, 7:] = 0.02
    keys = keys_of(400)
    jnew, jobs = jax.jit(jenv.step_joint)(jst, jnp.asarray(q_t.numpy()), keys)
    draws = env_observe_draws(jenv, jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys),
                              jnew.pc.count)
    new, obs = env.step_joint(st, q_t, draws=draws)
    assert_step_close(new, obs, jnew, jobs)
    assert (new.env_step == st.env_step + 1).all() and torch.equal(new.done, st.done)
