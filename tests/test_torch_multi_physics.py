"""The port's multi-body physics (physics/multi.py) on the CPU against the
JAX package's, and tests/test_multi_physics.py's behavioural contracts
held by the port itself.

Bounds and why:
- `multi_physics_step` from four contact-rich envs of a target and two
  clutter boxes (clutter parked far away; the target pushed into a box;
  a box stacked on the target; a box in the closing gripper), over 20
  substeps: every body's pos and quat within 2e-5 (the JAX suite's
  step-vs-fast bound, tests/test_multi_physics.py:76-107), linvel 2e-4
  and angvel 2e-3 and the fingers 2e-5 (the contact scan's bounds,
  tests/test_pallas_physics.py:59-66), the arm 1e-6 (its trajectory is
  the same program as physics/fast.py's), the gripper-contact and
  clutter-hit flags equal. Contact is chaotic at the edge of slipping,
  so the horizon stays short;
- `_pair_forces` on overlapping random pairs within 1e-6 absolute plus
  1e-5 relative: sums over up to 144 sphere pairs of forces up to the
  100 N pair cap, in another order;
- the contracts with test_multi_physics.py's own numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.envs.assets import AssetSpec as JaxAssetSpec
from gaddpg_tpu.envs.assets import build_library as jax_build_library
from gaddpg_tpu.physics import multi as jmulti
from gaddpg_tpu.physics.types import ArmState as JArmState
from gaddpg_tpu.physics.types import BodyState as JBodyState
from gaddpg_tpu.physics.types import PhysicsParams as JaxPhysicsParams
from gaddpg_tpu.physics.types import PhysicsState as JPhysicsState
from gaddpg_tpu_torch.envs.assets import LIBRARY_FIELDS, library_from_arrays
from gaddpg_tpu_torch.physics.fast import fast_physics_step, fk_hand_batched
from gaddpg_tpu_torch.physics.multi import _pair_forces, multi_physics_step
from gaddpg_tpu_torch.physics.step import physics_step
from gaddpg_tpu_torch.physics.types import ArmState, BodyState, PhysicsParams, PhysicsState
from gaddpg_tpu_torch.robot.panda import DEFAULT_JOINTS

P = PhysicsParams()
JP = JaxPhysicsParams()
SPECS = (("tgt_box", "box", (0.05, 0.05, 0.10), 0.2), ("clut_box", "box", (0.06, 0.06, 0.08), 0.3))
FAR = ((5.0, 5.0, 5.0), (-5.0, 5.0, 5.0))


@pytest.fixture(scope="module")
def libs():
    """(JAX library, the port's copy of it)."""
    jlib = jax_build_library([JaxAssetSpec(*s) for s in SPECS])
    lib = library_from_arrays(jlib.names, **{k: np.asarray(getattr(jlib, k))
                                             for k in LIBRARY_FIELDS})
    return jlib, lib


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def arm_q(b=1):
    return np.tile(np.concatenate([DEFAULT_JOINTS, [0.04, 0.04]]), (b, 1)).astype(np.float32)


def phys(obj_pos, linvel=None, q=None, q_target=None):
    """A port PhysicsState of len(obj_pos) envs at rest unless told."""
    b = len(obj_pos)
    q = arm_q(b) if q is None else q
    return PhysicsState(
        arm=ArmState(q=_t(q), qd=torch.zeros(b, 7), q_target=_t(q if q_target is None
                                                              else q_target)),
        obj=BodyState(pos=_t(obj_pos), quat=_t([[1.0, 0, 0, 0]] * b),
                      linvel=_t(np.zeros((b, 3)) if linvel is None else linvel),
                      angvel=torch.zeros(b, 3)),
        contact_force=torch.zeros(b), gripper_contact=torch.zeros(b, dtype=torch.bool))


def bodies(positions):
    """A port clutter BodyState (B, K) at rest, unrotated."""
    pos = _t(positions)
    quat = torch.zeros(*pos.shape[:2], 4)
    quat[..., 0] = 1.0
    return BodyState(pos=pos, quat=quat, linvel=torch.zeros_like(pos),
                     angvel=torch.zeros_like(pos))


def pack(lib, idx):
    """(spheres, coarse, mass, inertia) of each env's bodies idx (B, M)."""
    idx = torch.as_tensor(idx)
    return lib.spheres[idx], lib.coarse_spheres[idx], lib.mass[idx], lib.inertia[idx]


def to_jax(st, clut):
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return (JPhysicsState(arm=JArmState(q=j(st.arm.q), qd=j(st.arm.qd),
                                        q_target=j(st.arm.q_target)),
                          obj=JBodyState(pos=j(st.obj.pos), quat=j(st.obj.quat),
                                         linvel=j(st.obj.linvel), angvel=j(st.obj.angvel)),
                          contact_force=j(st.contact_force),
                          gripper_contact=j(st.gripper_contact)),
            JBodyState(pos=j(clut.pos), quat=j(clut.quat), linvel=j(clut.linvel),
                       angvel=j(clut.angvel)))


def hand_position(b=1):
    return fk_hand_batched(_t(arm_q(b)[:, :7]))[0]


def contact_rich(lib):
    """Four envs of a target and two clutter boxes: far clutter; the
    target shoved into a box; a box stacked on the target and one beside
    it; a box in the closing, moving gripper."""
    hp = hand_position()[0].tolist()
    q_t = arm_q(4)
    q_t[3, 1] += 0.1
    q_t[3, 7:] = 0.0
    st = phys([[0.55, 0.0, 0.0501], [0.565, 0.0, 0.0501], [0.55, 0.0, 0.0501],
               [0.55, 0.3, 0.0501]],
              linvel=[[0.1, 0, 0], [0.5, 0, 0], [0, 0, 0], [0, 0, 0]], q_target=q_t)
    clut = bodies([FAR, [[0.63, 0.0, 0.0401], [0.45, -0.10, 0.0401]],
                   [[0.55, 0.0, 0.1301], [0.55, 0.12, 0.0401]],
                   [hp, [0.45, -0.10, 0.0401]]])
    return st, clut, pack(lib, [[0, 1, 1]] * 4)


@pytest.fixture(scope="module")
def multi_pair(libs):
    jlib, lib = libs
    st, clut, (sph, coarse, mass, inertia) = contact_rich(lib)
    n = 20
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = jax.jit(lambda s, c, a, b, m, i: jmulti.multi_physics_step(JP, s, a, b, m, i, c,
                                                                     substeps=n))(
        *to_jax(st, clut), j(sph), j(coarse), j(mass), j(inertia))
    return multi_physics_step(P, st, sph, coarse, mass, inertia, clut, substeps=n), ref


def test_multi_physics_step_matches_jax(multi_pair):
    (st, clut, hit), (jst, jclut, jhit) = multi_pair
    tol = {"pos": 2e-5, "quat": 2e-5, "linvel": 2e-4, "angvel": 2e-3}
    for name, atol in tol.items():
        for got, want in ((getattr(st.obj, name), getattr(jst.obj, name)),
                          (getattr(clut, name), getattr(jclut, name))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0,
                                       err_msg=name)
    np.testing.assert_allclose(st.arm.q[:, 7:].numpy(), np.asarray(jst.arm.q[:, 7:]), atol=2e-5)
    np.testing.assert_allclose(st.arm.q[:, :7].numpy(), np.asarray(jst.arm.q[:, :7]), atol=1e-6)
    np.testing.assert_allclose(st.arm.qd.numpy(), np.asarray(jst.arm.qd), atol=1e-6)
    np.testing.assert_array_equal(st.gripper_contact.numpy(), np.asarray(jst.gripper_contact))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert hit.tolist() == [False, False, False, True]
    # the pushed box moves, the stacked one rests on the target
    assert float(clut.linvel[1, 0, 0]) > 0.0 and float(clut.pos[2, 0, 2]) > 0.12


def test_pair_forces_match_jax():
    rng = np.random.RandomState(5)
    b, m, nc = 3, 3, 4
    pos = rng.uniform(-0.02, 0.02, (b, m, 3)).astype(np.float32)
    quat = rng.randn(b, m, 4).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    coarse = np.concatenate([rng.uniform(-0.01, 0.01, (b, m, nc, 3)),
                             rng.uniform(0.0, 0.02, (b, m, nc, 1))], axis=-1).astype(np.float32)
    coarse[:, :, -1, 3] = 0.0                                   # a padding sphere per body
    lin = (rng.randn(b, m, 3) * 0.05).astype(np.float32)
    ang = (rng.randn(b, m, 3) * 0.5).astype(np.float32)
    mass = rng.uniform(0.1, 0.4, (b, m)).astype(np.float32)
    inertia = rng.uniform(1e-4, 1e-3, (b, m, 3)).astype(np.float32)
    args = (pos, quat, lin, ang, coarse, mass, inertia)
    got = _pair_forces(P, *(torch.as_tensor(a) for a in args))
    want = jmulti._pair_forces(JP, *(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-5)
    assert float(got[0].abs().max()) > 1.0
    # Newton's third law: the forces of each env sum to 0
    np.testing.assert_allclose(got[0].sum(dim=1).numpy(), 0.0, atol=1e-4)


# ---- tests/test_multi_physics.py's contracts, on the port -----------------------------------

def test_step_matches_fast(libs):
    """physics/step.py against physics/fast.py (the plain contact scan on
    the CPU) on a contact-rich start, 50 substeps, 2e-5."""
    _, lib = libs
    q_t = arm_q()
    q_t[:, 1] += 0.1
    q_t[:, 7:] = 0.0
    st = phys([[0.55, 0.0, 0.0501]], linvel=[[0.05, 0.0, 0.0]], q_target=q_t)
    fast = fast_physics_step(P, st, lib.spheres[:1], lib.mass[:1], lib.inertia[:1], substeps=50)
    slow = physics_step(P, st, lib.spheres[:1], lib.mass[:1], lib.inertia[:1], torch.eye(4),
                        substeps=50)
    for name, a, b in (("pos", slow.obj.pos, fast.obj.pos), ("quat", slow.obj.quat, fast.obj.quat),
                       ("linvel", slow.obj.linvel, fast.obj.linvel),
                       ("angvel", slow.obj.angvel, fast.obj.angvel),
                       ("arm.q", slow.arm.q, fast.arm.q), ("arm.qd", slow.arm.qd, fast.arm.qd)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5, err_msg=name)
    assert bool(slow.gripper_contact[0]) == bool(fast.gripper_contact[0])


def test_far_clutter_matches_fast_path(libs):
    _, lib = libs
    st = phys([[0.55, 0.0, 0.0501]], linvel=[[0.1, 0.0, 0.0]])
    ref = fast_physics_step(P, st, lib.spheres[:1], lib.mass[:1], lib.inertia[:1])
    out, _, hit = multi_physics_step(P, st, *pack(lib, [[0, 1, 1]]), bodies([FAR]))
    np.testing.assert_allclose(out.obj.pos.numpy(), ref.obj.pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.obj.linvel.numpy(), ref.obj.linvel.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.arm.q.numpy(), ref.arm.q.numpy(), atol=1e-6)
    assert not bool(hit[0])


def test_settled_clutter_stays_put(libs):
    _, lib = libs
    st = phys([[0.55, 0.0, 0.0501]])
    clut = bodies([[[0.55, 0.12, 0.0401], [0.45, -0.10, 0.0401]]])
    p0 = clut.pos.clone()
    for _ in range(3):
        st, clut, _ = multi_physics_step(P, st, *pack(lib, [[0, 1, 1]]), clut)
    drift = (clut.pos - p0).norm(dim=-1)
    assert float(drift.max()) < 3e-3, drift


def test_sustained_push_displaces_clutter(libs):
    # the target's forward velocity replenished each policy step, as an
    # arm-driven shove would: the box ahead must be plowed forward
    _, lib = libs
    st = phys([[0.565, 0.0, 0.0501]], linvel=[[0.5, 0.0, 0.0]])
    clut = bodies([[[0.63, 0.0, 0.0401]]])
    x0 = float(clut.pos[0, 0, 0])
    for _ in range(10):
        st.obj.linvel[:, 0] = 0.5
        st, clut, _ = multi_physics_step(P, st, *pack(lib, [[0, 1]]), clut)
    assert float(clut.pos[0, 0, 0]) - x0 > 8e-3
    assert abs(float(clut.pos[0, 0, 2])) < 0.5 and abs(float(st.obj.pos[0, 2])) < 0.5
    assert float(clut.linvel.norm()) < P.max_linvel


def test_free_space_x_momentum_conserved(libs):
    # a collision high above the table: the pair forces are the only
    # coupling along x, antisymmetric by construction
    _, lib = libs
    st = phys([[0.50, 0.0, 2.0]], linvel=[[0.8, 0.0, 0.0]])
    clut = bodies([[[0.58, 0.0, 2.0]]])
    m_t, m_c = float(lib.mass[0]), float(lib.mass[1])
    px0 = m_t * 0.8
    st, clut, _ = multi_physics_step(P, st, *pack(lib, [[0, 1]]), clut)
    px1 = m_t * float(st.obj.linvel[0, 0]) + m_c * float(clut.linvel[0, 0, 0])
    assert abs(px1 - px0) / px0 < 0.03, (px0, px1)
    assert float(clut.linvel[0, 0, 0]) > 0.05


def test_overlap_relaxes_without_ejection(libs):
    _, lib = libs
    st = phys([[0.55, 0.0, 0.0501]])
    clut = bodies([[[0.585, 0.0, 0.0401]]])                       # 2 cm interpenetrated
    for _ in range(4):
        st, clut, _ = multi_physics_step(P, st, *pack(lib, [[0, 1]]), clut)
        assert float(st.obj.linvel.norm()) < 0.5 and float(clut.linvel.norm()) < 0.5
    assert float(clut.pos[0, 0, 0] - st.obj.pos[0, 0]) >= 0.035 - 1e-3
    assert float(st.obj.pos[0, 2]) < 0.3 and float(clut.pos[0, 0, 2]) < 0.3


def test_stacked_clutter_holds(libs):
    _, lib = libs
    st = phys([[0.55, 0.0, 0.0501]])
    clut = bodies([[[0.55, 0.0, 0.1301]]])
    for _ in range(5):
        st, clut, _ = multi_physics_step(P, st, *pack(lib, [[0, 1]]), clut)
    assert abs(float(clut.pos[0, 0, 0]) - 0.55) < 2e-3
    assert 0.115 < float(clut.pos[0, 0, 2]) < 0.155, clut.pos
    assert float(clut.linvel[0, 0].norm()) < 5e-3
    assert float(clut.angvel[0, 0].norm()) < 0.05
    assert abs(float(st.obj.pos[0, 0]) - 0.55) < 5e-3


def _sphere_pair(pos):
    r = 0.02
    quat = torch.tensor([1.0, 0, 0, 0]).expand(1, 2, 4)
    coarse = torch.zeros(1, 2, 1, 4)
    coarse[..., 3] = r
    return (torch.tensor([pos]), quat, coarse, torch.full((1, 2), 0.2),
            torch.full((1, 2, 3), 0.2 * 0.4 * r * r))


def test_pair_friction_stick_and_slide():
    r = 0.02
    pos, quat, coarse, mass, inertia = _sphere_pair([[0.0, 0.0, 0.0], [0.0, 0.0, 2 * r - 0.001]])
    zeros = torch.zeros(1, 2, 3)

    def ft_at(vx):
        lv = zeros.clone()
        lv[0, 1, 0] = vx
        f, _ = _pair_forces(P, pos, quat, lv, zeros, coarse, mass, inertia)
        return float(f[0, 1, 0]), float(f[0, 0, 2])

    ft, fn = ft_at(0.5)                      # fast slide: kinetic Coulomb
    assert abs(-ft - P.friction_mu * (-fn)) < 1e-3 * abs(fn), (ft, fn)
    ft_a, _ = ft_at(0.002)                   # slow slide: stick, linear in v
    ft_b, _ = ft_at(0.01)
    assert abs(ft_b / ft_a - 5.0) < 0.5, (ft_a, ft_b)
    assert abs(ft_b) < 0.5 * P.friction_mu * abs(fn)
    assert abs(ft_b) < 0.9 * 0.01 / (P.dt * 2.0 / 0.2)   # rotation softens the stick


def test_pair_rolling_stiction_torque():
    r = 0.02
    zeros = torch.zeros(1, 2, 3)
    av = zeros.clone()
    av[0, 1, 1] = 2.0
    pos, quat, coarse, mass, inertia = _sphere_pair([[0.0, 0.0, 0.0], [0.0, 0.0, 2 * r - 0.001]])
    f, tau = _pair_forces(P, pos, quat, zeros, av, coarse, mass, inertia)
    fn = -float(f[0, 0, 2])
    budget = P.friction_mu * fn * P.obj_obj_roll_patch
    assert float(tau[0, 1, 1]) < 0.0
    assert -float(tau[0, 1, 1]) < budget + P.friction_mu * fn * 2 * r
    # angular momentum about the origin is conserved
    l_dot = (torch.linalg.cross(pos[0, 0], f[0, 0], dim=-1) + tau[0, 0]
             + torch.linalg.cross(pos[0, 1], f[0, 1], dim=-1) + tau[0, 1])
    np.testing.assert_allclose(l_dot.numpy(), 0.0, atol=1e-5)
    apart = _sphere_pair([[0.0, 0.0, 0.0], [0.0, 0.0, 4 * r]])
    _, tau0 = _pair_forces(P, apart[0], quat, zeros, av, coarse, mass, inertia)
    np.testing.assert_allclose(tau0.numpy(), 0.0, atol=1e-9)


def test_gripper_clutter_contact_event(libs):
    _, lib = libs
    hp = hand_position()[0].tolist()
    st = phys([[0.55, 0.3, 0.0501]])
    clut = bodies([[hp]])                                          # a box at the hand
    p0 = clut.pos.clone()
    st, clut, hit = multi_physics_step(P, st, *pack(lib, [[0, 1]]), clut, substeps=20)
    assert bool(hit[0])
    assert not bool(st.gripper_contact[0])                        # the target is far away
    assert float((clut.pos - p0).norm()) > 1e-4
