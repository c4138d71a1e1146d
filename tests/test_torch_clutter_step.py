"""The clutter env's other entry points on the CPU against the JAX
package's, from common states: the per-env `step` and the batched
`retract_batched` (the per-env `retract` is in
tests/test_torch_clutter_retract.py, the joint-space `step_joint` in
tests/test_torch_clutter_plan.py), with
num_clutter = 2 at the flagship dryrun tier's sizes (the goal servo, the
YCB proxy library). The states are the port's reset from a seeded
generator, carried to the JAX package by `torch_env_common.jax_state`;
the retracts start from a grasp: the arm solved by IK onto each env's
grasp goal, the fingers open around the target.

Bounds and why:
- `step` (one policy step of 10 substeps, the JAX draws): tests/test_torch_env.py's step bounds (the arm within two servo
  quanta; the bodies within the contact scan's bounds, the clutter's
  too), the servo targets within 1e-5 (the DLS IK), done, collided and the
  target-point count as there;
- `retract_batched` (a close of 2 x 10 substeps, then 2 lifts of 10):
  longer than the 20
  substeps the JAX suite's bounds hold for, and a squeeze between two pads
  is unstable: a pinched box chatters between them, and the sign of the
  rounding noise where the two pad forces cancel sets its phase (one env
  here: the port and the JAX package chatter with the same amplitude and
  opposite phase, 1.8e-4 m apart after 40 substeps). So each body must be
  within the step bounds, or off them only where the JAX package's own
  retracts from 8 one-ulp nudges of every body float leave the bounds and
  reach a quarter of the port's departure (chip_smoke.py's K7 rule), in
  fewer than all envs; a lift may differ only where a nudged JAX retract
  flips it; the arm within two servo quanta.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu_torch.robot.ik import ik_from_seeds
from test_torch_clutter_env import BODY_BOUNDS, assert_clutter_close, clutter_params
from test_torch_env import A_DT
from torch_env_common import (
    assert_phys_close, env_observe_draws, jax_retract_batched, jax_state, make_envs,
)

B = 4
STEP_BOUNDS = {**BODY_BOUNDS, "fingers": 2e-5, "arm_q": 2 * A_DT * 2e-3}


@pytest.fixture(scope="module")
def envs():
    return make_envs(jassets.library_from_index("ycb", "train"), clutter_params(True),
                     clutter_params())


@pytest.fixture(scope="module")
def start(envs):
    """The port's reset of B envs (seeded) and the JAX copy of it."""
    _, env = envs
    st, _ = env.reset(B, torch.Generator().manual_seed(5))
    return st, jax_state(st)


@pytest.fixture(scope="module")
def at_grasp(envs, start):
    """The reset states with each arm on its grasp goal, fingers open."""
    _, env = envs
    st = start[0]
    goal = env._goal_world(st)
    q, ok = ik_from_seeds(goal[:, :3, 3], goal[:, :3, :3])
    assert ok.sum() >= 2
    q = torch.cat([torch.where(ok[:, None], q, st.phys.arm.q[:, :7]),
                   torch.full((B, 2), 0.04)], dim=1)
    arm = dataclasses.replace(st.phys.arm, q=q, q_target=q.clone(), qd=torch.zeros(B, 7))
    st = dataclasses.replace(st, phys=dataclasses.replace(st.phys, arm=arm))
    return st, jax_state(st)


def keys_of(seed):
    return jnp.stack([jax.random.PRNGKey(seed + s) for s in range(B)])


def assert_step_close(st, obs, jst, jobs):
    np.testing.assert_allclose(st.phys.arm.q_target.numpy(), np.asarray(jst.phys.arm.q_target),
                               atol=1e-5)
    assert_phys_close(st.phys, jst.phys, STEP_BOUNDS)
    assert_clutter_close(st, jst)
    np.testing.assert_array_equal(st.collided.numpy(), np.asarray(jst.collided))
    np.testing.assert_array_equal(st.env_step.numpy(), np.asarray(jst.env_step))
    n, jn = obs.num_points.numpy(), np.asarray(jobs.num_points)
    assert (np.abs(n - jn) <= 0.01 * jn + 2).all(), (n, jn)


def test_step_matches_jax(envs, start):
    """The per-env `step` (multi-body physics with clutter) for each env."""
    jenv, env = envs
    st, jst = start
    acts = env.expert_action(st)
    keys = keys_of(300)
    jnew, jobs, _, jdone, _ = jax.jit(jax.vmap(jenv.step))(jst, jnp.asarray(acts.numpy()), keys)
    draws = env_observe_draws(jenv, jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys),
                              jnew.pc.count)
    new, obs, _, done, _ = env.step(st, acts, draws=draws)
    assert_step_close(new, obs, jnew, jobs)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def nudged_bodies(jst, gen):
    """The JAX states with every float of the target's and the clutter's
    states (position, orientation, velocities) moved by one ulp, up or down
    at random (numpy RandomState `gen`)."""
    def one_ulp(x):
        x = np.array(x)
        return jnp.asarray(np.nextafter(x, (x + gen.choice([-1.0, 1.0], x.shape))
                                        .astype(np.float32)))
    obj = jst.phys.obj
    obj = obj.replace(**{f: one_ulp(getattr(obj, f)) for f in BODY_BOUNDS})
    return jst.replace(phys=jst.phys.replace(obj=obj),
                       **{f"clutter_{f}": one_ulp(getattr(jst, f"clutter_{f}"))
                          for f in BODY_BOUNDS})


def body_fields(state):
    """{field: (B, M, ...)} of every body, the target first, as numpy."""
    def arr(x):
        return x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return {f: np.concatenate([arr(getattr(state.phys.obj, f))[:, None],
                               arr(getattr(state, f"clutter_{f}"))], axis=1)
            for f in BODY_BOUNDS}


def assert_retract_close(port, lift, ref, ref_lift, nudged_runs):
    """Every body of the port's retract `port` within BODY_BOUNDS of the
    JAX package's `ref`, and the lifts equal; or, where not, the reference
    chaotic there: one of its own retracts from NUDGES one-ulp nudges of
    every body float (`nudged_runs`, an iterator of (state, lift), drawn
    only until every such body and lift is explained) leaves the bounds at
    that body and reaches at least a quarter of the port's departure, or
    flips that lift; in fewer than all envs."""
    got, want = body_fields(port), body_fields(ref)
    off = {f: np.abs(got[f] - want[f]).max(axis=-1) for f in BODY_BOUNDS}    # (B, M)
    lift, ref_lift = np.asarray(lift), np.asarray(ref_lift)
    todo = {f: off[f] > tol for f, tol in BODY_BOUNDS.items()}
    flip = lift != ref_lift
    off_envs = set(np.nonzero(flip)[0].tolist())
    for f in BODY_BOUNDS:
        off_envs |= set(np.nonzero(todo[f].any(axis=1))[0].tolist())
    assert len(off_envs) < len(lift), (off, lift, ref_lift)
    for state, n_lift in nudged_runs:
        if not flip.any() and not any(t.any() for t in todo.values()):
            break
        spread = body_fields(state)
        for f, tol in BODY_BOUNDS.items():
            reach = np.abs(spread[f] - want[f]).max(axis=-1)
            todo[f] &= ~((reach > tol) & (reach >= 0.25 * off[f]))
        flip &= np.asarray(n_lift) == ref_lift
    assert not flip.any(), (lift, ref_lift)
    for f in BODY_BOUNDS:
        assert not todo[f].any(), (f, off[f])


NUDGES = 8


def test_retract_batched_matches_jax(envs, at_grasp):
    jenv, env = envs
    st, jst = at_grasp
    jnew, jlift = jax_retract_batched(jenv, jst)
    new, lift = env.retract_batched(st)
    rng = np.random.RandomState(0)
    assert_retract_close(new, lift.numpy(), jnew, jlift, (
        jax_retract_batched(jenv, nudged_bodies(jst, rng)) for _ in range(NUDGES)))
    np.testing.assert_allclose(new.phys.arm.q.numpy(), np.asarray(jnew.phys.arm.q),
                               atol=2 * A_DT * 2e-3)
