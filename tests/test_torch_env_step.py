"""The env's per-env entry points in single-object scenes on the CPU
against the JAX package's: `step` and `retract` through the per-env
contact model (physics/step.py with the base pose, not the batched K7
path), at the dryrun tier's sizes (10 substeps, a 32 x 32 camera) with
the goal servo on the YCB proxy library, from the port's reset carried to
the JAX package (tests/test_torch_clutter_step.py's states and rules).

Bounds and why: `step` (one policy step of 10 substeps, the JAX draws)
by tests/test_torch_env.py's step bounds; `retract` (a close of 300
substeps, then 2 lifts) by tests/test_torch_clutter_step.py's chaos rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaddpg_tpu.envs import assets as jassets
from test_torch_clutter_env import clutter_params
from test_torch_clutter_step import (  # noqa: F401  (module fixtures)
    B, NUDGES, assert_retract_close, assert_step_close, at_grasp, keys_of, nudged_bodies,
    start,
)
from torch_env_common import env_observe_draws, make_envs


@pytest.fixture(scope="module")
def envs():
    return make_envs(jassets.library_from_index("ycb", "train"),
                     clutter_params(True, num_clutter=0), clutter_params(num_clutter=0))


def test_step_matches_jax(envs, start):
    jenv, env = envs
    st, jst = start
    assert st.clutter_pos.shape == (B, 0, 3)
    acts = env.expert_action(st)
    keys = keys_of(600)
    jnew, jobs, _, jdone, _ = jax.jit(jax.vmap(jenv.step))(jst, jnp.asarray(acts.numpy()), keys)
    draws = env_observe_draws(jenv, jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys),
                              jnew.pc.count)
    new, obs, _, done, _ = env.step(st, acts, draws=draws)
    assert_step_close(new, obs, jnew, jobs)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_retract_matches_jax(envs, at_grasp):
    jenv, env = envs
    st, jst = at_grasp
    jretract = jax.jit(jax.vmap(jenv.retract))
    keys = keys_of(700)
    jnew, jlift = jretract(jst, keys)
    new, lift = env.retract(st)
    rng = np.random.RandomState(2)
    assert_retract_close(new, lift.numpy(), jnew, jlift, (
        jretract(nudged_bodies(jst, rng), keys) for _ in range(NUDGES)))
