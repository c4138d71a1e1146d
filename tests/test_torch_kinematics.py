"""Rotations, SE(3) helpers, Panda FK and DLS IK of the port against the
JAX package on identical float32 inputs made from seeded numpy.

Bounds: 1e-6 for the closed-form functions (float32 rounding of a few
products); 1e-5 on q for `dls_ik` from the same seed (10 iterations
through an arccos, a sin and an unrolled Cholesky, each rounded in
another order); `ik_from_seeds` with the same success flags, and q
within 1e-4 wherever the same seed wins. The winning seed is an argmin
over 14 branches, several of which converge to the float32 noise floor,
so rounding may flip it between near-tied branches (1e-6 apart); such
flips are counted and checked to be near-ties, and the port's answer
must still reach the target as `tests/test_robot.py` requires (position
within 1e-2 after a successful solve; pose error of a single-seed solve
below 1e-3 / 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.geometry import rotations as jrot
from gaddpg_tpu.geometry import se3 as jse3
from gaddpg_tpu.robot import ik as jik
from gaddpg_tpu.robot import panda as jpanda
from gaddpg_tpu_torch.geometry import rotations as rot
from gaddpg_tpu_torch.geometry import se3
from gaddpg_tpu_torch.robot import ik, panda
from gaddpg_tpu_torch.utils.constants import const

TOL = 1e-6


def _np(x):
    return np.array(x, dtype=np.float32)


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=0)


def _random_joints(rng, n, frac=0.6):
    lo, hi = np.asarray(jpanda.JOINT_LOWER), np.asarray(jpanda.JOINT_UPPER)
    return rng.uniform(lo * frac, hi * frac, (n, 7)).astype(np.float32)


@pytest.mark.parametrize("name", ["quat_normalize", "quat_mul", "quat_conj", "quat_to_mat",
                                  "mat_to_quat", "mat_to_euler", "euler_to_quat",
                                  "euler_to_mat", "quat_rotate"])
def test_rotations_match_jax(name):
    rng = np.random.RandomState(0)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    e = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    v = rng.randn(64, 3).astype(np.float32)
    m = _np(jrot.quat_to_mat(q1))
    args = {"quat_normalize": (q1 * 3.0,), "quat_mul": (q1, q2), "quat_conj": (q1,),
            "quat_to_mat": (q1,), "mat_to_quat": (m,), "mat_to_euler": (m,),
            "euler_to_quat": (e,), "euler_to_mat": (e,), "quat_rotate": (q1, v)}[name]
    ref = getattr(jrot, name)(*map(jnp.asarray, args))
    out = getattr(rot, name)(*map(torch.as_tensor, args))
    _close(out, ref)


@pytest.mark.parametrize("name", ["se3_from_quat_pos", "se3_inverse", "pack_pose_rot_first",
                                  "unpack_action"])
def test_se3_matches_jax(name):
    rng = np.random.RandomState(1)
    q = _quats(rng, 32)
    t = rng.randn(32, 3).astype(np.float32)
    T = _np(jse3.se3_from_quat_pos(q, t))
    a = rng.uniform(-0.1, 0.1, (32, 6)).astype(np.float32)
    args = {"se3_from_quat_pos": (q, t), "se3_inverse": (T,), "pack_pose_rot_first": (T,),
            "unpack_action": (a,)}[name]
    ref = getattr(jse3, name)(*map(jnp.asarray, args))
    _close(getattr(se3, name)(*map(torch.as_tensor, args)), ref)


def test_constants_equal():
    for name in ("JOINT_LOWER", "JOINT_UPPER", "DEFAULT_JOINTS", "ANCHOR_SEEDS",
                 "ARM_POINT_RADII"):
        np.testing.assert_array_equal(const(getattr(panda, name), "cpu").numpy(),
                                      np.asarray(getattr(jpanda, name)), err_msg=name)
    np.testing.assert_array_equal(panda._ORIGINS, jpanda._ORIGINS)
    np.testing.assert_array_equal(panda._T_HAND, jpanda._T_HAND)


def test_fk_matches_jax():
    import jax

    q = _random_joints(np.random.RandomState(2), 16, frac=1.0)
    qt = torch.as_tensor(q)
    _close(panda.fk_all(qt), jax.vmap(jpanda.fk_all)(jnp.asarray(q)))
    _close(panda.fk_hand(qt), jax.vmap(jpanda.fk_hand)(jnp.asarray(q)))
    _close(panda.arm_collision_points(qt), jax.vmap(jpanda.arm_collision_points)(jnp.asarray(q)))


def _targets(rng, n):
    """Reachable hand poses: FK of random joints."""
    q = _random_joints(rng, n)
    T = _np(np.stack([np.asarray(jpanda.fk_hand(jnp.asarray(x))) for x in q]))
    return T[:, :3, 3].copy(), T[:, :3, :3].copy()


def test_dls_ik_matches_jax():
    """The env's regime: a warm start within 0.1 rad per joint of a
    solution (a policy step moves the hand at most 6 cm and 30 degrees).
    From far-off seeds an unconverged solve near the joint limits
    amplifies float32 rounding (1e-6 after one iteration, 1e-3 after
    ten, in both packages alike), so the 1e-5 bound holds where the
    solve converges."""
    import jax

    rng = np.random.RandomState(3)
    q_goal = _random_joints(rng, 8)
    T = _np(np.stack([np.asarray(jpanda.fk_hand(jnp.asarray(x))) for x in q_goal]))
    pos, rotm = T[:, :3, 3].copy(), T[:, :3, :3].copy()
    seeds = (q_goal + rng.uniform(-0.1, 0.1, (8, 7))).astype(np.float32)
    q_ref, perr_ref, rerr_ref = jax.vmap(lambda s, p, r: jik.dls_ik(s, p, r, iters=10))(
        seeds, pos, rotm)
    q, perr, rerr = ik.dls_ik(*map(torch.as_tensor, (seeds, pos, rotm)), iters=10)
    _close(q, q_ref, 1e-5)
    _close(perr, perr_ref, 1e-5)
    _close(rerr, rerr_ref, 1e-5)


def test_dls_ik_converges_as_the_reference():
    """tests/test_robot.py::test_single_seed_converges_near on the port."""
    q0 = np.array(jpanda.DEFAULT_JOINTS, np.float32)
    T = panda.fk_hand(torch.as_tensor(q0 + 0.1)[None])
    _, perr, rerr = ik.dls_ik(torch.as_tensor(q0)[None], T[:, :3, 3], T[:, :3, :3])
    assert float(perr) < 1e-3 and float(rerr) < 1e-2


def test_ik_from_seeds_matches_jax():
    """Same success flags. The winner is the argmin of pos + rot error
    over 14 seeds, and converged seeds score at the float32 noise floor
    (2e-7 to 4e-7), so rounding may pick another of them: where both
    packages pick the same seed, q agrees within 1e-4; where they differ
    (counted), both winners must score within 1e-6 of the best score in
    each package (a near-tie) and reach the target."""
    import jax

    rng = np.random.RandomState(4)
    pos, rotm = _targets(rng, 16)
    pos[:3] += 0.5  # three out of reach
    q_ref, ok_ref = jax.vmap(lambda p, r: jik.ik_from_seeds(p, r))(pos, rotm)
    q, ok = ik.ik_from_seeds(torch.as_tensor(pos), torch.as_tensor(rotm))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert not ok[:3].any() and ok[3:].sum() >= 11
    # per-seed scores in both packages
    seeds = np.asarray(jpanda.ANCHOR_SEEDS)
    _, pe, re = jax.vmap(lambda p, r: jax.vmap(lambda s: jik.dls_ik(s, p, r))(seeds))(pos, rotm)
    score_ref = np.asarray(pe + re)
    _, pe, re = ik.dls_ik(torch.as_tensor(seeds)[None].expand(16, 14, 7),
                          torch.as_tensor(pos)[:, None].expand(16, 14, 3),
                          torch.as_tensor(rotm)[:, None].expand(16, 14, 3, 3))
    score = (pe + re).numpy()
    win_ref, win = score_ref.argmin(axis=1), score.argmin(axis=1)
    flips = 0
    for i in np.flatnonzero(ok.numpy()):
        if win[i] == win_ref[i]:
            np.testing.assert_allclose(q[i].numpy(), np.asarray(q_ref[i]), atol=1e-4)
            continue
        flips += 1
        for sc in (score, score_ref):
            assert max(sc[i, win[i]], sc[i, win_ref[i]]) <= sc[i].min() + 1e-6
        np.testing.assert_allclose(panda.fk_hand(q[i][None])[0, :3, 3].numpy(), pos[i],
                                   atol=1e-2)
    assert flips < ok.sum().item(), "every target picked another seed"
