"""The rest of the JAX package's public API in the port, each function
against its JAX counterpart on seeded numpy inputs:

- `ops.sampling`: `regularize_point_count` on the JAX function's own
  draws (valid None, partly valid, fewer valid rows than picks, more
  picks than rows), and the `valid=` mask of `furthest_point_sampling`
  and `ball_query` (exact indices; the mask runs the plain version, as
  the JAX package's mask runs XLA);
- `robot.panda`: `fk_camera`, `fk_fingers`, `hand_jacobian`,
  `PandaKinematics` and `base=` of `fk_all`, `arm_collision_points` and
  `fk_hand`;
- `geometry.se3`'s seven helpers and `rotations.axis_angle_to_quat`;
- `agents.state.multistep_lr` at and around each milestone;
- `agents.ddpg.ddpg_update` and `agents.bc.bc_update`, the built updates
  of `make_ddpg_update` / `make_bc_update`, bit for bit;
- the package exports of `ops`, `robot`, `geometry` and `agents`.

Bounds: 1e-6 for the geometry (float32 rounding of a few products, as
tests/test_torch_kinematics.py), 1e-5 for the Jacobian (forward-mode
derivatives through seven chained products), 1e-6 relative for the
learning rate (optax multiplies in float32, the port in float64).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.agents import state as jstate
from gaddpg_tpu.geometry import rotations as jrot
from gaddpg_tpu.geometry import se3 as jse3
from gaddpg_tpu.ops import sampling as jsampling
from gaddpg_tpu.robot import panda as jpanda
from gaddpg_tpu_torch import agents, geometry, ops, robot
from gaddpg_tpu_torch.geometry import rotations as rot
from gaddpg_tpu_torch.geometry import se3
from gaddpg_tpu_torch.ops import sampling
from gaddpg_tpu_torch.robot import panda

TOL = 1e-6
JAC_TOL = 1e-5


def _f32(x):
    return np.array(x, dtype=np.float32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=0)


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(rng, n):
    return _f32(jse3.se3_from_quat_pos(_quats(rng, n), rng.randn(n, 3).astype(np.float32)))


def _joints(rng, n):
    lo, hi = np.asarray(jpanda.JOINT_LOWER), np.asarray(jpanda.JOINT_UPPER)
    return rng.uniform(lo, hi, (n, 7)).astype(np.float32)


# -- ops.sampling --------------------------------------------------------------------

def _valid_mask(rng, b, n, kind):
    if kind == "none":
        return None
    if kind == "partly":
        return rng.rand(b, n) < 0.7
    return np.arange(n)[None, :] < rng.randint(1, 6, (b, 1))  # "few": 1-5 valid rows


@pytest.mark.parametrize("kind,npoints", [("none", 24), ("partly", 24), ("few", 24),
                                          ("partly", 50)])
def test_regularize_point_count_matches_jax(kind, npoints):
    """Every pick and row equal to the JAX function's on its own draws."""
    rng = np.random.RandomState(10)
    b, n = 4, 40
    pc = rng.randn(b, n, 4).astype(np.float32)
    valid = _valid_mask(rng, b, n, kind)
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    fn = functools.partial(jsampling.regularize_point_count, npoints=npoints)
    if valid is None:
        want_pc, want_idx = jax.vmap(lambda k, p: fn(k, p))(keys, jnp.asarray(pc))
    else:
        want_pc, want_idx = jax.vmap(lambda k, p, v: fn(k, p, valid=v))(
            keys, jnp.asarray(pc), jnp.asarray(valid))
    draws = {"gumbel": [], "extra": [], "repl": []}
    for k in keys:  # the JAX function's draws, as it makes them
        k1, k2 = jax.random.split(k)
        draws["gumbel"].append(np.asarray(jax.random.gumbel(k1, (n,))))
        draws["extra"].append(np.asarray(jax.random.randint(k2, (max(npoints - n, 0),), 0, n)))
        draws["repl"].append(np.asarray(jax.random.randint(k2, (npoints,), 0, n)))
    draws = {k: torch.from_numpy(np.stack(v)) for k, v in draws.items()}
    got_pc, got_idx = sampling.regularize_point_count(
        torch.from_numpy(pc), npoints, None if valid is None else torch.from_numpy(valid),
        draws=draws)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_pc.numpy(), np.asarray(want_pc))
    if valid is not None:  # every pick is a valid row
        assert np.take_along_axis(valid, got_idx.numpy(), 1).all()


def test_regularize_point_count_draws_from_a_generator():
    """Without draws: seeded, valid rows only, distinct while enough are valid."""
    pc = torch.randn(3, 30, 3, generator=torch.Generator().manual_seed(0))
    valid = torch.arange(30)[None].expand(3, -1) < 20
    a = sampling.regularize_point_count(pc, 16, valid, generator=torch.Generator().manual_seed(1))
    b = sampling.regularize_point_count(pc, 16, valid, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[1], b[1]) and bool((a[1] < 20).all())
    assert all(len(set(row.tolist())) == 16 for row in a[1])


def _clouds(rng, b=3, n=64, s=12):
    xyz = (rng.randn(b, n, 3) * 0.05).astype(np.float32)
    xyz[:, n // 2:] = xyz[:, :1]  # repeated points: exact ties for FPS
    centres = xyz[:, rng.randint(0, n, s)]
    valid = rng.rand(b, n) < 0.6
    valid[:, 0] = True
    return xyz, centres, valid


@pytest.mark.parametrize("masked", [True, False])
def test_fps_and_ball_query_valid_match_jax(masked):
    """Exact indices with a partial mask and with an all-true one; the
    masked path launches no kernel (on the CPU nothing launches)."""
    rng = np.random.RandomState(11)
    xyz, centres, valid = _clouds(rng)
    if not masked:
        valid = np.ones_like(valid)
    fps = jax.vmap(lambda p, v: jsampling.furthest_point_sampling(p, 20, valid=v))
    bq = jax.vmap(lambda c, p, v: jsampling.ball_query(c, p, 0.04, 16, valid=v))
    got = sampling.furthest_point_sampling(torch.from_numpy(xyz), 20,
                                           valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(fps(xyz, valid)))
    got = sampling.ball_query(torch.from_numpy(centres), torch.from_numpy(xyz), 0.04, 16,
                              valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(bq(centres, xyz, valid)))
    if not masked:  # all true: the unmasked function's indices
        np.testing.assert_array_equal(
            sampling.furthest_point_sampling(torch.from_numpy(xyz), 20).numpy(),
            np.asarray(fps(xyz, valid)))


def test_valid_mask_is_checked():
    xyz = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="valid"):
        sampling.furthest_point_sampling(xyz, 4, valid=torch.ones(2, 7, dtype=torch.bool))
    with pytest.raises(ValueError, match="valid"):
        sampling.ball_query(xyz[:, :3], xyz, 0.1, 4, valid=torch.ones(2, 8))


# -- robot.panda ---------------------------------------------------------------------

def test_fk_base_camera_and_fingers_match_jax():
    rng = np.random.RandomState(12)
    q = _joints(rng, 16)
    base = _poses(rng, 16)
    finger = rng.uniform(0.0, 0.04, (16, 2)).astype(np.float32)
    jq, jb = jnp.asarray(q), jnp.asarray(base)
    tq, tb = torch.from_numpy(q), torch.from_numpy(base)
    _close(panda.fk_all(tq, tb), jax.vmap(jpanda.fk_all)(jq, jb))
    _close(panda.fk_hand(tq, tb), jax.vmap(jpanda.fk_hand)(jq, jb))
    _close(panda.arm_collision_points(tq, tb),
           jax.vmap(lambda a, b: jpanda.arm_collision_points(a, b))(jq, jb))
    _close(panda.fk_camera(tq), jax.vmap(jpanda.fk_camera)(jq))
    _close(panda.fk_camera(tq, tb), jax.vmap(jpanda.fk_camera)(jq, jb))
    _close(panda.fk_fingers(tq, torch.from_numpy(finger)),
           jax.vmap(jpanda.fk_fingers)(jq, jnp.asarray(finger)))
    _close(panda.fk_fingers(tq, torch.from_numpy(finger), tb),
           jax.vmap(jpanda.fk_fingers)(jq, jnp.asarray(finger), jb))
    # one base for every arm broadcasts
    _close(panda.fk_hand(tq, tb[0]), jax.vmap(lambda a: jpanda.fk_hand(a, jb[0]))(jq))


def test_hand_jacobian_matches_jax():
    q = _joints(np.random.RandomState(13), 8)
    want = np.stack([np.asarray(jpanda.hand_jacobian(jnp.asarray(x))) for x in q])
    _close(panda.hand_jacobian(torch.from_numpy(q)), want, JAC_TOL)
    _close(panda.hand_jacobian(torch.from_numpy(q[0])), want[0], JAC_TOL)


def test_panda_kinematics_namespace():
    k = panda.PandaKinematics
    for name in ("joint_lower", "joint_upper", "default_joints", "anchor_seeds"):
        np.testing.assert_array_equal(np.asarray(getattr(k, name), np.float32),
                                      np.asarray(getattr(jpanda.PandaKinematics, name)))
    q = torch.from_numpy(_joints(np.random.RandomState(14), 2))
    for name in ("fk_hand", "fk_all", "fk_camera"):
        assert torch.equal(getattr(k, name)(q), getattr(panda, name)(q))
    f = torch.full((2, 2), 0.02)
    assert torch.equal(k.fk_fingers(q, f), panda.fk_fingers(q, f))


# -- geometry ------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["se3_mul", "se3_transform_points", "pack_pose", "unpack_pose",
                                  "unpack_pose_rot_first", "inv_relative_pose",
                                  "se3_log_pose_delta", "axis_angle_to_quat"])
def test_geometry_matches_jax(name):
    rng = np.random.RandomState(15)
    a, b = _poses(rng, 32), _poses(rng, 32)
    pts = rng.randn(32, 10, 3).astype(np.float32)
    packed = _f32(jse3.pack_pose(b))
    rot_first = _f32(jse3.pack_pose_rot_first(b))
    small = _f32(jse3.unpack_action(rng.uniform(-0.1, 0.1, (32, 6)).astype(np.float32)))
    axis = rng.randn(32, 3).astype(np.float32) * 2.0
    angle = rng.uniform(-np.pi, np.pi, 32).astype(np.float32)
    args = {"se3_mul": (a, b), "se3_transform_points": (a, pts), "pack_pose": (a,),
            "unpack_pose": (packed,), "unpack_pose_rot_first": (rot_first,),
            "inv_relative_pose": (_f32(jse3.pack_pose(a)), packed),
            "se3_log_pose_delta": (small,), "axis_angle_to_quat": (axis, angle)}[name]
    module = (jrot, rot) if name == "axis_angle_to_quat" else (jse3, se3)
    want = getattr(module[0], name)(*map(jnp.asarray, args))
    _close(getattr(module[1], name)(*map(torch.from_numpy, args)), want)


# -- agents --------------------------------------------------------------------------

MILESTONES = (30, 10, 20, 20)  # unsorted and repeated: optax keys them in a dict


def test_multistep_lr_matches_optax():
    want = jstate.multistep_lr(3e-4, MILESTONES, 0.5)
    got = agents.multistep_lr(3e-4, MILESTONES, 0.5)
    for step in sorted({0, 1} | {m + d for m in MILESTONES for d in (-1, 0, 1)} | {1000}):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0,
                                   err_msg=str(step))
    assert got(25) == 3e-4 * 0.5 * 0.5


def test_ddpg_update_and_bc_update_are_the_built_updates():
    """ddpg_update / bc_update step a state exactly as make_ddpg_update /
    make_bc_update do, on a batch with every mask live."""
    from gaddpg_tpu_torch.agents.state import state_counts, state_tensors
    from test_torch_learner import CFG, NPOINTS, _torch_batch, make_batch

    cfg = agents.AgentConfig(**CFG)
    batch = _torch_batch(make_batch(3))
    draws = torch.rand((len(batch["time"]), 6), generator=torch.Generator().manual_seed(4))
    start = agents.create_agent_state(cfg, npoints=NPOINTS,
                                      generator=torch.Generator().manual_seed(5), device="cpu")
    for conv, make, kw in ((agents.ddpg_update, agents.make_ddpg_update, {"noise_draws": draws}),
                           (agents.bc_update, agents.make_bc_update, {})):
        a, b = start.to("cpu"), start.to("cpu")
        ma = conv(cfg, "cpu")(a, batch, **kw)
        mb = make(cfg, "cpu")(b, batch, **kw)
        assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
        assert state_counts(a) == state_counts(b) and state_counts(a)[0] == 1
        assert all(torch.equal(x, y) for x, y in zip(state_tensors(a), state_tensors(b)))
        assert conv(cfg, "cpu").mesh is None


def test_public_exports():
    """The names the JAX package's ops, robot, geometry and agents export."""
    import gaddpg_tpu.agents as jagents
    import gaddpg_tpu.geometry as jgeometry
    import gaddpg_tpu.ops as jops
    import gaddpg_tpu.robot as jrobot

    for jmod, mod in ((jops, ops), (jrobot, robot), (jgeometry, geometry)):
        names = {n for n in vars(jmod) if not n.startswith("_")
                 and not isinstance(getattr(jmod, n), type(jmod))}
        assert names <= set(vars(mod)), sorted(names - set(vars(mod)))
    for name in ("ddpg_update", "bc_update", "extract_feature", "create_agent_state",
                 "AgentConfig", "AgentState"):
        assert hasattr(jagents, name) and hasattr(agents, name), name
