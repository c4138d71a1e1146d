"""The port's batched physics on the CPU (K7's plain version) against the
JAX package's `fast_physics_step`, both its XLA scan and its Pallas
kernel in interpret mode.

The contact-rich batch is `tests/test_pallas_physics.py::make_states`
(objects at the closing gripper and on the table), run for 60 substeps
and held to that file's bounds (`:59-66`): pos and quat 2e-5, linvel
2e-4, angvel 2e-3, fingers 2e-5, arm q 1e-6, gripper contact equal. The
free-fall case holds pos and linvel to 1e-5 as that file does;
`arm_trajectory`, `fk_hand_batched` and the passive clamp to 1e-6
(float32 rounding of a few products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.physics import fast as jfast
from gaddpg_tpu.physics.contact import clamp_passive_delta as jclamp
from gaddpg_tpu.physics.types import PhysicsParams as JaxPhysicsParams
from gaddpg_tpu_torch.ops import contact_scan as cs
from gaddpg_tpu_torch.physics import fast, types
from gaddpg_tpu_torch.physics.contact import clamp_passive_delta
from test_pallas_physics import make_states

P = types.PhysicsParams()
JP = JaxPhysicsParams()
BOUNDS = {"pos": 2e-5, "quat": 2e-5, "linvel": 2e-4, "angvel": 2e-3, "fingers": 2e-5,
          "arm_q": 1e-6}


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def to_port(st):
    """A port PhysicsState from a JAX one."""
    return types.PhysicsState(
        arm=types.ArmState(q=_t(st.arm.q), qd=_t(st.arm.qd), q_target=_t(st.arm.q_target)),
        obj=types.BodyState(pos=_t(st.obj.pos), quat=_t(st.obj.quat),
                            linvel=_t(st.obj.linvel), angvel=_t(st.obj.angvel)),
        contact_force=_t(st.contact_force), gripper_contact=_t(st.gripper_contact),
    )


def assert_state_close(out, ref, bounds=BOUNDS):
    pairs = {"pos": (out.obj.pos, ref.obj.pos), "quat": (out.obj.quat, ref.obj.quat),
             "linvel": (out.obj.linvel, ref.obj.linvel),
             "angvel": (out.obj.angvel, ref.obj.angvel),
             "fingers": (out.arm.q[:, 7:9], ref.arm.q[:, 7:9]),
             "arm_q": (out.arm.q[:, :7], ref.arm.q[:, :7])}
    for name, tol in bounds.items():
        a, b = pairs[name]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out.gripper_contact.numpy(), np.asarray(ref.gripper_contact))


def test_params_equal():
    assert P == types.PhysicsParams(**{k: getattr(JP, k) for k in vars(JP)})
    assert hash(P) == hash(types.PhysicsParams())


@pytest.fixture(scope="module")
def contact_rich():
    st, sph, mass, inertia = make_states()
    ref = jfast.fast_physics_step(JP, st, sph, mass, inertia, substeps=60, scan_impl="xla")
    return st, sph, mass, inertia, ref


def test_fast_physics_step_matches_xla_scan(contact_rich):
    st, sph, mass, inertia, ref = contact_rich
    out = fast.fast_physics_step(P, to_port(st), _t(sph), _t(mass), _t(inertia), substeps=60)
    assert_state_close(out, ref)
    np.testing.assert_allclose(out.arm.qd.numpy(), np.asarray(ref.arm.qd), atol=1e-6)


def test_contact_scan_matches_pallas_interpret(contact_rich):
    """The plain version on the very inputs the JAX package packs for its
    Pallas kernel (`physics/fast.py::_pallas_contact_scan`), against that
    kernel in interpret mode; and the port's packing gives the same
    inputs (the JAX one pads B to its 8-env tile)."""
    from gaddpg_tpu.geometry.rotations import quat_mul as jquat_mul
    from gaddpg_tpu.ops import pallas_physics as pp

    st, sph, mass, inertia, _ = contact_rich
    n, b = 60, mass.shape[0]
    q_traj, _ = jfast.arm_trajectory(JP, st.arm.q[:, :7], st.arm.qd, st.arm.q_target[:, :7], n)
    hp, hq = jfast.fk_hand_batched(jnp.concatenate([st.arm.q[None, :, :7], q_traj]))
    hand_ang = (jquat_mul(hq[1:] - hq[:-1], hq[:-1] * jnp.array([1.0, -1, -1, -1]))
                * (2.0 / JP.dt))[..., 1:]
    captured = {}
    real = pp.contact_scan_pallas

    def spy(p, n_, *args, interpret=False):
        captured["args"] = [np.array(a) for a in args]
        return real(p, n_, *args, interpret=interpret)

    pp.contact_scan_pallas = spy
    try:
        ref = jfast._pallas_contact_scan(JP, n, st.obj, st.arm, sph, mass, inertia, hp[1:],
                                         hq[1:], (hp[1:] - hp[:-1]) / JP.dt, hand_ang,
                                         interpret=True)
    finally:
        pp.contact_scan_pallas = real
    args = [_t(a) for a in captured["args"]]
    out = cs.contact_scan_reference(P, n, *args)[:b]
    for name, (sl, tol) in {"pos": (slice(0, 3), 2e-5), "quat": (slice(3, 7), 2e-5),
                            "linvel": (slice(7, 10), 2e-4), "angvel": (slice(10, 13), 2e-3),
                            "fingers": (slice(13, 15), 2e-5)}.items():
        want = np.asarray(ref[list(BOUNDS).index(name)])
        np.testing.assert_allclose(out[:, sl].numpy(), want, atol=tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out[:, 15].numpy() > 0.5, np.asarray(ref[5]))
    ours = fast.pack_contact_scan(P, n, to_port(st), _t(sph), _t(mass), _t(inertia),
                                  args[1][:, :b])
    theirs = [args[0][:b], args[1][:, :b], args[2][:, :b], *(a[:b] for a in args[3:])]
    for a, want in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), want.numpy())


def test_wrapper_on_cpu_runs_the_plain_version(contact_rich):
    st, sph, mass, inertia, _ = contact_rich
    n = 10
    q_traj, _ = fast.arm_trajectory(P, _t(st.arm.q[:, :7]), _t(st.arm.qd),
                                    _t(st.arm.q_target[:, :7]), n)
    hand = torch.randn(n, 3, 13, generator=torch.Generator().manual_seed(0)) * 0.01
    hand[..., 3] += 1.0
    args = [a.contiguous() for a in fast.pack_contact_scan(
        P, n, to_port(st), _t(sph), _t(mass), _t(inertia), hand)]
    before = cs.contact_scan.launches
    assert torch.equal(cs.contact_scan(P, n, *args), cs.contact_scan_reference(P, n, *args))
    assert cs.contact_scan.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        cs.contact_scan(P, n, args[0], args[1], args[2][:, :, :16], *args[3:])


def test_free_fall_matches():
    st, sph, mass, inertia = make_states(2)
    st = st.replace(obj=st.obj.replace(pos=st.obj.pos + jnp.array([0.0, 0.0, 2.0])))
    ref = jfast.fast_physics_step(JP, st, sph, mass, inertia, substeps=40, scan_impl="xla")
    out = fast.fast_physics_step(P, to_port(st), _t(sph), _t(mass), _t(inertia), substeps=40)
    np.testing.assert_allclose(out.obj.pos.numpy(), np.asarray(ref.obj.pos), atol=1e-5)
    np.testing.assert_allclose(out.obj.linvel.numpy(), np.asarray(ref.obj.linvel), atol=1e-5)
    assert not out.gripper_contact.any()


def test_padded_sphere_sets_match():
    """Sets of fewer than 32 spheres: the port pads them to the kernel's
    32 lanes (radius 0, parked at z = 1e6); the JAX XLA scan runs them as
    they are."""
    st, sph, mass, inertia = make_states()
    sph = sph[:, :20]
    ref = jfast.fast_physics_step(JP, st, sph, mass, inertia, substeps=60, scan_impl="xla")
    out = fast.fast_physics_step(P, to_port(st), _t(sph), _t(mass), _t(inertia), substeps=60)
    assert_state_close(out, ref)


def test_arm_trajectory_and_hand_fk_match():
    rng = np.random.RandomState(0)
    q0 = rng.uniform(-1, 1, (3, 7)).astype(np.float32)
    qd0 = rng.uniform(-0.5, 0.5, (3, 7)).astype(np.float32)
    tgt = (q0 + rng.uniform(-0.3, 0.3, (3, 7))).astype(np.float32)
    traj_ref, qd_ref = jfast.arm_trajectory(JP, q0, qd0, tgt, 75)
    traj, qd = fast.arm_trajectory(P, _t(q0), _t(qd0), _t(tgt), 75)
    np.testing.assert_allclose(traj.numpy(), np.asarray(traj_ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(qd.numpy(), np.asarray(qd_ref), atol=1e-6, rtol=0)
    pos_ref, quat_ref = jfast.fk_hand_batched(jnp.asarray(traj_ref))
    pos, quat = fast.fk_hand_batched(_t(traj_ref))
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(quat.numpy(), np.asarray(quat_ref), atol=1e-6, rtol=0)


def test_clamp_passive_delta_matches():
    rng = np.random.RandomState(1)
    dv = rng.randn(64, 2, 3).astype(np.float32) * 0.1
    v = rng.randn(64, 2, 3).astype(np.float32)
    v[:4] = 0.0  # at rest
    caps = np.array([[0.05], [0.5]], np.float32)
    ref = jclamp(jnp.asarray(dv), jnp.asarray(v), jnp.asarray(caps))
    out = clamp_passive_delta(_t(dv), _t(v), _t(caps))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
