"""The port's CHOMP expert (`gaddpg_tpu_torch/expert/chomp.py`) against
the JAX package's (`gaddpg_tpu/expert/chomp.py`) on the CPU, from the
same float32 inputs.

Bounds and why:
- `_MINV` and the descent's blend steps: bit for bit (both round the
  same float64 inverse, and the float32 values of `jnp.linspace`).
- `obstacle_cost` and its gradient (against `jax.grad`): 1e-5 relative
  to each batch's largest value (float32 sums of up to 22 x 3 hinge
  terms in another order; the test prints the measured departures). A
  probe exactly at a sphere
  centre is only held finite on both sides: there the gradient's
  direction is the float32 rounding of a zero difference.
- `plan_to_goal` on a batch of scenes (the free-space goal of
  tests/test_clutter_expert.py:28, its obstacle goal of :44, the elbow
  re-route of tests/test_arm_collision.py:76, a goal buried under the
  table, and a goal inside a target object's spheres), each run also
  from NUDGES one-ulp nudges of its start joints on the JAX side, which
  measure the reference's own float32 spread. The branch choice (the
  standoff joints q_stand) and the reached pose (the insertion's end)
  agree on every scene and start within 1e-5. The plan is held by
  tests/torch_env_common.py's chaos rule (`plan_bounds`). Where the
  nudges leave JAX's plan within PLAN_TOL, `ok` is exact and the plan
  within PLAN_TOL: 1.0e-6 is the largest nudge spread measured there and
  3e-7 the port's departure, so PLAN_TOL = 1e-5 holds both with room. A
  scene whose nudges move JAX's own plan past PLAN_TOL is chaotic: a
  hinge of the obstacle cost flips within the 30 preconditioned steps.
  The elbow re-route is (its obstacle sits on an arm probe of the
  mid-plan, so the first gradient's direction is rounding noise: nudges
  move JAX's plan by 5.3 rad, and its `ok` is False from 4 of the 17
  starts, True from the others), and so is the
  goal inside the target's spheres (nudges move the plan by 5.3e-3, the
  port departs by 1.5e-3). There the port's plan must lie within
  CHAOS_FACTOR times JAX's own one-ulp spread of JAX's plan, and its
  `ok` must be a value the nudged JAX plans take. The test prints each
  scene's spread and departure, and fails if the free-space, obstacle or
  buried scene is chaotic.
- The descent alone (`approach_descent`) from the JAX plan's own
  q_stand, against the JAX plan's interior waypoints, by the same rule.
- `plan_action`: 1e-5 (an FK, an inverse and an euler conversion).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.expert import chomp as jchomp
from gaddpg_tpu.robot import panda as jpanda
from gaddpg_tpu_torch.envs.assets import box_asset
from gaddpg_tpu_torch.expert import chomp
from gaddpg_tpu_torch.robot import panda
from torch_env_common import PLAN_TOL, plan_bounds

NUDGES = 16
GRAD_TOL = 1e-5
NOBS, NS = 2, 32  # obstacle and target sphere slots of every scene (radius 0 pads)


def _goal_at(pos):
    """Top-down grasp pose at pos (tests/test_clutter_expert.py:21)."""
    g = np.eye(4, dtype=np.float32)
    g[:3, :3] = np.diag([1.0, -1.0, -1.0])
    g[:3, 3] = pos
    return g


def _scenes():
    """(names, goals (S, 4, 4), obstacles (S, NOBS, 4), targets (S, NS, 4))."""
    q0 = torch.as_tensor(np.array(jpanda.DEFAULT_JOINTS, np.float32))
    names = ["free", "obstacle", "elbow", "buried", "target"]
    goals = np.stack([_goal_at(p) for p in ([0.5, 0.0, 0.2], [0.55, 0.0, 0.15],
                                            [0.55, 0.15, 0.1], [0.5, 0.0, -0.1],
                                            [0.5, 0.05, 0.1])])
    obst = np.zeros((5, NOBS, 4), np.float32)
    target = np.zeros((5, NS, 4), np.float32)
    obst[1, 0] = [0.42, 0.05, 0.35, 0.06]
    # tests/test_arm_collision.py:58: a sphere on the elbow's mid-plan
    # position of the free-space plan (the port's plan: it is JAX's to 1e-6)
    with torch.no_grad():
        free_plan, _ = chomp.plan_to_goal(q0[None], torch.as_tensor(goals[2:3]),
                                          torch.zeros(1, 0, 4))
    elbow = panda.arm_collision_points(free_plan[0, chomp.APPROACH_STEPS // 2])[6]
    obst[2, 0] = [*elbow.numpy(), 0.05]
    # a 5 x 5 x 14 cm box standing under the target scene's grasp
    box = box_asset(0.05, 0.05, 0.14).spheres[0].numpy()
    target[4] = box + np.array([0.5, 0.05, 0.07, 0.0], np.float32)
    return names, goals, obst, target


@pytest.fixture(scope="module")
def plans():
    """The scenes from DEFAULT_JOINTS, then each from NUDGES one-ulp
    nudges of it: JAX plans (one vmapped compile) and the port's."""
    names, goals, obst, target = _scenes()
    rng = np.random.RandomState(0)
    q0 = np.asarray(jpanda.DEFAULT_JOINTS, np.float32)
    starts = [q0] + [np.nextafter(q0, (q0 + rng.choice([-1.0, 1.0], 7)).astype(np.float32))
                     for _ in range(NUDGES)]
    rows = [(s, q) for s in range(len(names)) for q in starts]
    q = np.stack([r[1] for r in rows])
    idx = np.array([r[0] for r in rows])
    plan_fn = jax.jit(jax.vmap(lambda q, g, o, t: jchomp.plan_to_goal(q, g, o,
                                                                       target_spheres=t)))
    j_plan, j_ok = (np.asarray(x) for x in plan_fn(q, goals[idx], obst[idx], target[idx]))
    with torch.no_grad():
        p_plan, p_ok = chomp.plan_to_goal(torch.as_tensor(q), torch.as_tensor(goals[idx]),
                                          torch.as_tensor(obst[idx]),
                                          target_spheres=torch.as_tensor(target[idx]))
    return dict(names=names, goals=goals, obst=obst, target=target, q=q, idx=idx,
                j_plan=j_plan, j_ok=j_ok, p_plan=p_plan.numpy(), p_ok=p_ok.numpy())


def test_constants_match_jax():
    np.testing.assert_array_equal(chomp._MINV, np.asarray(jchomp._MINV))
    np.testing.assert_array_equal(chomp._ALPHAS, np.asarray(jnp.linspace(0.0, 1.0, 16))[1:-1, None])
    np.testing.assert_array_equal(chomp._BETAS, np.asarray(jnp.linspace(0.0, 1.0, 5))[1:, None])
    np.testing.assert_array_equal(chomp._TARGET_FADE, np.asarray(jchomp._target_fade(16)))
    np.testing.assert_array_equal(torch.as_tensor(chomp._PROBES, dtype=torch.float32).numpy(),
                                  np.asarray(jchomp._PROBES))
    assert (chomp.STANDOFF_DIST, chomp.APPROACH_STEPS, chomp.INSERT_STEPS, chomp.PLAN_STEPS,
            chomp.PROBE_RADIUS) == (jchomp.STANDOFF_DIST, jchomp.APPROACH_STEPS,
                                    jchomp.INSERT_STEPS, jchomp.PLAN_STEPS, jchomp.PROBE_RADIUS)


def test_arm_collision_points_frames_form():
    """The `frames=` form gives the `q` form's points bit for bit."""
    q = torch.as_tensor(np.random.RandomState(3).uniform(-1, 1, (5, 4, 7)).astype(np.float32))
    np.testing.assert_array_equal(panda.arm_collision_points(frames=panda.fk_all(q)).numpy(),
                                  panda.arm_collision_points(q).numpy())


def _cost_case(case):
    """(q (B, 7), spheres (B, NOBS, 4), table_z, margin) of one case."""
    rng = np.random.RandomState({"spheres": 1, "padding": 2, "centre": 3, "table": 4}[case])
    lo, hi = np.asarray(jpanda.JOINT_LOWER), np.asarray(jpanda.JOINT_UPPER)
    q = rng.uniform(lo * 0.6, hi * 0.6, (16, 7)).astype(np.float32)
    with torch.no_grad():
        probes = chomp._probe_world(torch.as_tensor(q)).numpy()  # (16, 22, 3)
    # spheres near random probes, so that the hinges are live
    pick = probes[np.arange(16)[:, None], rng.randint(0, 22, (16, 3))]
    spheres = np.concatenate([pick + rng.normal(0, 0.03, pick.shape),
                              rng.uniform(0.02, 0.08, (16, 3, 1))], -1).astype(np.float32)
    table_z, margin = 0.0, 0.01
    if case == "padding":
        spheres[:, 1:, 3] = 0.0
    elif case == "centre":
        spheres[:, 0, :3] = probes[:, 5]  # a probe exactly at a sphere centre
    elif case == "table":
        table_z, margin = 0.35, 0.005
    return q, spheres, table_z, margin


@pytest.mark.parametrize("case", ["spheres", "padding", "centre", "table"])
def test_obstacle_cost_and_gradient_match_jax(case):
    q, spheres, table_z, margin = _cost_case(case)

    def jcost(qq, sph):
        return jchomp.obstacle_cost(qq, sph, margin=margin, table_z=table_z)

    j_c = np.asarray(jax.vmap(jcost)(q, spheres))
    j_g = np.asarray(jax.vmap(jax.grad(jcost))(q, spheres))
    qt = torch.as_tensor(q).requires_grad_(True)
    c = chomp.obstacle_cost(qt, torch.as_tensor(spheres), margin=margin, table_z=table_z)
    g, = torch.autograd.grad(c.sum(), qt)
    c, g = c.detach().numpy(), g.numpy()
    assert (j_c > 0).sum() >= 8, j_c  # live hinges
    print(f"{case}: cost off by {np.abs(c - j_c).max() / np.abs(j_c).max():.2e}, gradient by "
          f"{np.abs(g - j_g).max() / np.abs(j_g).max():.2e} of the largest")
    np.testing.assert_allclose(c, j_c, rtol=0, atol=GRAD_TOL * np.abs(j_c).max())
    assert np.isfinite(g).all() and np.isfinite(j_g).all()
    if case == "centre":
        return
    np.testing.assert_allclose(g, j_g, rtol=0, atol=GRAD_TOL * np.abs(j_g).max())
    if case == "table":  # the table hinge carries cost and gradient here
        with torch.no_grad():
            free = chomp.obstacle_cost(torch.as_tensor(q), torch.as_tensor(spheres),
                                       margin=margin, table_z=-1.0)
        assert (c - free.numpy()).max() > 1e-3


def _scene_rows(plans, s):
    return np.nonzero(plans["idx"] == s)[0]


def _rule(plans, s, plan):
    """(departure, JAX's own one-ulp spread, bound) of `plan` (S, 7)
    against JAX's plan on scene s from DEFAULT_JOINTS."""
    jp = plans["j_plan"][_scene_rows(plans, s)]
    return tuple(float(x[0]) for x in plan_bounds(plan[None], jp[:1], jp[1:, None]))


def test_plan_to_goal_matches_jax(plans):
    names, jp, pp = plans["names"], plans["j_plan"], plans["p_plan"]
    assert pp.shape == jp.shape == (len(plans["q"]), chomp.PLAN_STEPS, 7)
    chaotic = []
    for s, name in enumerate(names):
        rows = _scene_rows(plans, s)
        r0 = rows[0]
        # the branch choice and the reached pose, from every start
        for k in (chomp.APPROACH_STEPS - 1, chomp.PLAN_STEPS - 1):
            np.testing.assert_allclose(pp[rows, k], jp[rows, k], rtol=0, atol=PLAN_TOL,
                                       err_msg=f"{name}: waypoint {k}")
        err, spread, bound = _rule(plans, s, pp[r0])
        print(f"{name}: JAX one-ulp spread {spread:.3g}, port departure {err:.3g}, "
              f"ok JAX {plans['j_ok'][rows].astype(int).tolist()} "
              f"port {plans['p_ok'][rows].astype(int).tolist()}")
        assert err <= bound, (name, err)
        if spread > PLAN_TOL:
            chaotic.append(name)
            assert plans["p_ok"][r0] in set(plans["j_ok"][rows].tolist()), name
            continue
        np.testing.assert_array_equal(plans["p_ok"][rows], plans["j_ok"][rows], err_msg=name)
        np.testing.assert_allclose(pp[rows], jp[rows], rtol=0, atol=PLAN_TOL, err_msg=name)
    print(f"chaotic scenes: {chaotic}")
    assert not {"free", "obstacle", "buried"} & set(chaotic), chaotic
    ok = dict(zip(names, plans["j_ok"][[_scene_rows(plans, s)[0] for s in range(len(names))]]))
    assert ok["free"] and ok["obstacle"] and ok["target"] and not ok["buried"], ok


def test_descent_from_the_jax_standoff(plans):
    """`approach_descent` from the JAX plan's own q_stand, against the JAX
    plan's interior waypoints, by the chaos rule."""
    jp, idx = plans["j_plan"], plans["idx"]
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))  # noqa: E731
    with torch.no_grad():
        free = chomp.approach_descent(t(plans["q"]), t(jp[:, chomp.APPROACH_STEPS - 1]),
                                      t(plans["obst"][idx]), t(plans["target"][idx]))
    # JAX's plans with the port's descent in place of their interior
    mixed = jp.copy()
    mixed[:, 1:chomp.APPROACH_STEPS - 1] = free.numpy()
    err = np.abs(mixed - jp).max(axis=(1, 2))
    for s, name in enumerate(plans["names"]):
        rows = _scene_rows(plans, s)
        print(f"{name}: descent departure {err[rows].max():.3g}")
        e0, spread, bound = _rule(plans, s, mixed[rows[0]])
        assert e0 <= bound, (name, e0)
        if spread <= PLAN_TOL:
            assert err[rows].max() <= PLAN_TOL, (name, err[rows])


def test_plan_action_matches_jax(plans):
    rng = np.random.RandomState(5)
    rows = rng.randint(0, len(plans["q"]), 12)
    plan = plans["j_plan"][rows]
    steps = rng.randint(0, chomp.PLAN_STEPS + 2, 12).astype(np.int32)
    q = plan[np.arange(12), np.minimum(steps, chomp.PLAN_STEPS - 1)] + rng.normal(
        0, 0.02, (12, 7)).astype(np.float32)
    hand = np.asarray(jax.vmap(jpanda.fk_hand)(q))
    want = np.asarray(jax.vmap(jchomp.plan_action)(hand, plan, steps))
    with torch.no_grad():
        got = chomp.plan_action(torch.as_tensor(hand), torch.as_tensor(plan),
                                torch.as_tensor(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
