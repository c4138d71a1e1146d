"""The clutter env's per-env `retract` on the CPU against the JAX
package's, from a common grasp (tests/test_torch_clutter_step.py's
states: the arm solved by IK onto each env's grasp goal, the fingers
open around the target), num_clutter = 2 at the flagship dryrun tier's
sizes: a close of 300 substeps, then 2 lifts of 10, each through the
per-env model (physics/multi.py with clutter).

Bounds and why: tests/test_torch_clutter_step.py's rule for its
`retract_batched`, over this longer horizon: each body within the step
bounds, or off them only where the JAX package's own retracts from 8
one-ulp nudges of every body float leave the bounds and reach a quarter
of the port's departure, in fewer than all envs; a lift may differ only
where a nudged JAX retract flips it.
"""

import jax
import numpy as np

from test_torch_clutter_step import (  # noqa: F401  (module fixtures)
    NUDGES, assert_retract_close, at_grasp, envs, keys_of, nudged_bodies, start,
)


def test_retract_matches_jax(envs, at_grasp):
    """The per-env `retract`: 300 close substeps and the lift through the
    per-env model, for each env."""
    jenv, env = envs
    st, jst = at_grasp
    jretract = jax.jit(jax.vmap(jenv.retract))
    keys = keys_of(500)
    jnew, jlift = jretract(jst, keys)
    new, lift = env.retract(st)
    rng = np.random.RandomState(1)
    assert_retract_close(new, lift.numpy(), jnew, jlift, (
        jretract(nudged_bodies(jst, rng), keys) for _ in range(NUDGES)))
