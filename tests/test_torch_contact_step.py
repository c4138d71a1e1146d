"""The port's per-env contact model (physics/contact.py, physics/step.py)
on the CPU against the JAX package's, and test_physics.py's behavioural
contracts held by the port itself.

Bounds and why:
- each contact.py function, `quat_integrate` and the step's rotation
  helpers at 1e-6 absolute plus 1e-6 relative, on the same numpy inputs
  (seeded) vmapped over the envs on the JAX side: float32 rounding of a
  few products and sums in another order; the normal forces run up to
  the 400 N table cap, where one float32 ulp is 3e-5. The angular
  velocity from two rotation matrices divides a difference of their
  product's entries by dt: one ulp of an entry (6e-8) over dt = 2 ms is
  3e-5, its bound;
- `physics_step` (20 substeps from contact-rich states: objects at the
  closing gripper and on the table, tests/test_pallas_physics.py's, and
  a box between closing pads) at
  the JAX suite's step-vs-fast bounds, pos, quat and the arm's joints
  2e-5 (tests/test_multi_physics.py:76-107), linvel 2e-4 and angvel 2e-3
  as the contact scan's (tests/test_pallas_physics.py:59-66), the
  gripper-contact flag equal;
- the contracts (settle, no energy pumping, free fall, friction stops a
  slide, torsional friction, fingers and arm track their targets) with
  tests/test_physics.py's own numbers, at its pinned dt = 1 ms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.geometry import rotations as jrot
from gaddpg_tpu.physics import contact as jcontact
from gaddpg_tpu.physics import step as jstep
from gaddpg_tpu.physics.types import PhysicsParams as JaxPhysicsParams
from gaddpg_tpu.robot.panda import fk_hand as jfk_hand
from gaddpg_tpu_torch.envs.assets import box_asset, cylinder_asset
from gaddpg_tpu_torch.geometry.rotations import quat_integrate, quat_normalize, quat_to_mat
from gaddpg_tpu_torch.physics import contact, step
from gaddpg_tpu_torch.physics.types import ArmState, BodyState, PhysicsParams, PhysicsState
from gaddpg_tpu_torch.robot.panda import DEFAULT_JOINTS, fk_hand
from test_pallas_physics import make_states
from test_torch_physics import assert_state_close, to_port

P = PhysicsParams()
JP = JaxPhysicsParams()
TOL = dict(atol=1e-6, rtol=1e-6)
B, N = 4, 32


def _t(x):
    return torch.as_tensor(np.array(x))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.fixture(scope="module")
def inputs():
    """Seeded spheres straddling boxes and the table, box poses and
    velocities, and a body's dynamics (float32)."""
    rng = np.random.RandomState(0)
    f = lambda *a: a[0].astype(np.float32)  # noqa: E731
    quat = rng.randn(B, 4)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    box_t = rng.uniform(-0.1, 0.1, (B, 3)) + [0.5, 0.0, 0.05]
    rot = quat_to_mat(_t(f(quat))).numpy()
    pose = np.tile(np.eye(4), (B, 1, 1))
    pose[:, :3, :3], pose[:, :3, 3] = rot, box_t
    centers = box_t[:, None, :] + rng.uniform(-0.06, 0.06, (B, N, 3))
    centers[:, :4, 2] = rng.uniform(-0.01, 0.02, (B, 4))       # some at the table
    radii = rng.uniform(0.005, 0.02, (B, N))
    radii[:, -3:] = 0.0                                          # padding spheres
    return {
        "centers": f(centers), "radii": f(radii), "pose": f(pose),
        "lin": f(rng.randn(B, 3) * 0.1), "ang": f(rng.randn(B, 3)),
        "v": f(rng.randn(B, 3) * 0.05), "w": f(rng.randn(B, 3) * 0.5),
        "com": f(box_t + rng.randn(B, 3) * 0.01), "mass": f(rng.uniform(0.1, 0.5, B)),
        "inertia": f(rng.uniform(1e-4, 1e-3, (B, 3))), "quat": f(quat),
        "omega": f(rng.randn(B, 3) * 3.0),
    }


def both_contacts(d, he=P.finger_half_extents, max_force=50.0):
    """(port, JAX) contacts: the table plane and a box, concatenated."""
    c = contact.concat_contacts(
        contact.sphere_plane_contacts(_t(d["centers"]), _t(d["radii"]), 0.0, max_force=400.0),
        contact.sphere_box_contacts(_t(d["centers"]), _t(d["radii"]), _t(d["pose"]), he,
                                    (_t(d["lin"]), _t(d["ang"])), max_force=max_force))

    def one(cen, rad, pose, lin, ang):
        return jcontact.concat_contacts(
            jcontact.sphere_plane_contacts(cen, rad, 0.0, max_force=400.0),
            jcontact.sphere_box_contacts(cen, rad, pose, jnp.asarray(he), (lin, ang),
                                         max_force=max_force))

    ref = jax.vmap(one)(*(jnp.asarray(d[k]) for k in ("centers", "radii", "pose", "lin", "ang")))
    return c, ref


def test_contacts_match(inputs):
    d = inputs
    c, ref = both_contacts(d)
    for f in contact.Contacts._fields:
        close(getattr(c, f), getattr(ref, f))
    assert (c.pen > 0).any() and (c.pen[:, N:] > 0).any()   # live table and box contacts
    assert (c.pen[:, N - 3:N] == -1.0).all()                 # padding never contacts


def test_box_sdf_normal_matches(inputs):
    rng = np.random.RandomState(1)
    p = rng.uniform(-0.05, 0.05, (B, 64, 3)).astype(np.float32)
    p[:, :8] *= 0.1                                          # deep inside: the face branch
    p[:, 8, :] = [0.011, 0.0, 0.0]                           # ties on the inside branch
    he = (0.011, 0.009, 0.027)
    sdf, n = contact.box_sdf_normal(_t(p), he)
    rsdf, rn = jax.vmap(lambda x: jcontact.box_sdf_normal(x, jnp.asarray(he)))(jnp.asarray(p))
    close(sdf, rsdf)
    close(n, rn)
    assert (sdf < 0).any() and (sdf > 0).any()


def test_normal_forces_and_friction_match(inputs):
    d = inputs
    c, ref = both_contacts(d)
    body_v = _t(d["v"])[:, None, :] + torch.randn(B, c.pen.shape[1], 3,
                                                   generator=torch.Generator().manual_seed(2)) * 0.01
    damp = torch.full(c.pen.shape, 30.0)
    fn = contact.normal_forces(c, body_v, P.contact_stiffness, damp)
    rfn = jax.vmap(lambda cc, bv, dc: jcontact.normal_forces(cc, bv, JP.contact_stiffness, dc))(
        ref, jnp.asarray(body_v.numpy()), jnp.asarray(damp.numpy()))
    close(fn, rfn)
    assert (fn > 0).any()

    rot = quat_to_mat(quat_normalize(_t(d["quat"])))
    inv_iw = rot @ torch.diag_embed(1.0 / _t(d["inertia"])) @ rot.transpose(-1, -2)
    n_active = (c.pen > 0).sum(dim=1)
    budget = None
    ref_budget = None
    for _ in range(2):  # the first pass from the full cone, the second from what is left
        out = contact.friction_impulses(c, fn, _t(d["v"]), _t(d["w"]), _t(d["com"]),
                                        _t(d["mass"]), inv_iw, P.friction_mu, P.dt, n_active,
                                        budget=budget)

        def one(cc, f, v, w, com, m, iw, na, bud):
            return jcontact.friction_impulses(cc, f, v, w, com, m, iw, JP.friction_mu, JP.dt, na,
                                              budget=bud)

        args = (ref, rfn, *(jnp.asarray(d[k]) for k in ("v", "w", "com", "mass")),
                jnp.asarray(inv_iw.numpy()), jnp.asarray(n_active.numpy()))
        if ref_budget is None:
            want = jax.vmap(lambda *a: one(*a, None))(*args)
        else:
            want = jax.vmap(one)(*args, ref_budget)
        for a, b in zip(out, want):
            close(a, b)
        budget, ref_budget = out[2], want[2]
    assert (out[0].abs() > 0).any()


def test_quat_integrate_and_rotation_helpers_match(inputs):
    d = inputs
    close(quat_integrate(_t(d["quat"]), _t(d["omega"]), 2e-3),
          jrot.quat_integrate(jnp.asarray(d["quat"]), jnp.asarray(d["omega"]), 2e-3))
    r_old = quat_to_mat(_t(d["quat"]))
    r_new = quat_to_mat(quat_integrate(_t(d["quat"]), _t(d["omega"]), 2e-3))
    close(step._rot_delta_to_omega(r_new, r_old, 2e-3),
          jax.vmap(lambda a, b: jstep._rot_delta_to_omega(a, b, 2e-3))(
              jnp.asarray(r_new.numpy()), jnp.asarray(r_old.numpy())), atol=3e-5, rtol=1e-6)
    q = np.tile(np.concatenate([DEFAULT_JOINTS, [0.03, 0.02]]), (B, 1)).astype(np.float32)
    q[:, :7] += np.random.RandomState(3).uniform(-0.3, 0.3, (B, 7))
    hand = fk_hand(_t(q[:, :7]))
    got = step.gripper_box_poses(hand, _t(q[:, 7]), _t(q[:, 8]), P)
    want = jax.vmap(lambda h, a, b: jstep.gripper_box_poses(h, a, b, JP))(
        jnp.asarray(hand.numpy()), jnp.asarray(q[:, 7]), jnp.asarray(q[:, 8]))
    for a, b in zip(got, want):
        close(a, b)


def grasp_states():
    """tests/test_pallas_physics.py's three contact-rich envs and a fourth
    with the box between the pads, aligned with the hand, the fingers
    closing on it from 27 mm: a pad contact within a few substeps."""
    st, sph, mass, inertia = make_states()
    hand = np.asarray(jax.vmap(jfk_hand)(st.arm.q[:1, :7]))[0]
    pad = hand[:3, 3] + hand[:3, :3] @ np.array([0.0, 0.0, JP.finger_z_center])
    quat = np.asarray(jrot.mat_to_quat(jnp.asarray(hand[:3, :3])))
    q = np.asarray(st.arm.q[:1]).copy()
    q[:, 7:] = 0.027
    cat = lambda a, b: jnp.concatenate([a, jnp.asarray(b, a.dtype)])  # noqa: E731
    st = st.replace(
        arm=st.arm.replace(q=cat(st.arm.q, q), qd=cat(st.arm.qd, np.zeros((1, 7))),
                           q_target=cat(st.arm.q_target, np.asarray(st.arm.q_target[:1]))),
        obj=st.obj.replace(pos=cat(st.obj.pos, pad[None]), quat=cat(st.obj.quat, quat[None]),
                           linvel=cat(st.obj.linvel, np.zeros((1, 3))),
                           angvel=cat(st.obj.angvel, np.zeros((1, 3)))),
        contact_force=cat(st.contact_force, [0.0]),
        gripper_contact=cat(st.gripper_contact, [False]))
    return st, cat(sph, sph[:1]), cat(mass, mass[:1]), cat(inertia, inertia[:1])


@pytest.fixture(scope="module")
def step_pair():
    st, sph, mass, inertia = grasp_states()
    n = 20
    run = jax.jit(jax.vmap(lambda s, a, m, i: jstep.physics_step(JP, s, a, m, i, jnp.eye(4),
                                                                    substeps=n)))
    ref = run(st, sph, mass, inertia)
    out = step.physics_step(P, to_port(st), _t(sph), _t(mass), _t(inertia), torch.eye(4),
                            substeps=n)
    return out, ref


def test_physics_step_matches_jax(step_pair):
    out, ref = step_pair
    assert_state_close(out, ref, {"pos": 2e-5, "quat": 2e-5, "linvel": 2e-4, "angvel": 2e-3,
                                  "fingers": 2e-5, "arm_q": 2e-5})
    np.testing.assert_allclose(out.arm.qd.numpy(), np.asarray(ref.arm.qd), atol=1e-6)
    np.testing.assert_allclose(out.contact_force.numpy(), np.asarray(ref.contact_force),
                               rtol=1e-3, atol=1e-3)
    assert out.gripper_contact[3] and (out.arm.q[3, 7:] > 0.02).all()   # the pads hold the box


# ---- tests/test_physics.py's contracts, on the port ----------------------------------------

PC = PhysicsParams(dt=1e-3, substeps=150, friction_iters=4)
CHUNK = 100  # substeps between the snapshots the contracts read
# one env per contract: (library, object position, linear and angular velocity)
CONTRACTS = {
    "settle": (box_asset(0.05, 0.05, 0.14, mass=0.2), (0.55, 0.0, 0.09), (0, 0, 0), (0, 0, 0)),
    "pumping": (cylinder_asset(0.033, 0.10, mass=0.35), (0.55, 0.0, 0.0501), (0, 0, 0), (0, 0, 0)),
    "free_fall": (box_asset(0.04, 0.04, 0.04, mass=0.1), (0.55, 0.0, 0.5), (0, 0, 0), (0, 0, 0)),
    "push": (box_asset(0.06, 0.06, 0.06, mass=0.3), (0.55, 0.0, 0.031), (0.5, 0, 0), (0, 0, 0)),
    "spin": (cylinder_asset(0.02, 0.10, mass=0.35), (0.55, 0.0, 0.0501), (0, 0, 0), (0, 0, 4.0)),
    "fingers": (box_asset(0.04, 0.04, 0.04, mass=0.1), (0.55, 0.0, 0.5), (0, 0, 0), (0, 0, 0)),
    "arm": (box_asset(0.04, 0.04, 0.04, mass=0.1), (0.55, 0.0, 0.5), (0, 0, 0), (0, 0, 0)),
}
ENV = {name: e for e, name in enumerate(CONTRACTS)}


@pytest.fixture(scope="module")
def contracts():
    """The contracts' envs as one batch (each env its own object; envs do
    not interact) at tests/test_physics.py's pinned dt = 1 ms, stepped for
    1200 substeps: the states after every CHUNK substeps, a list. The
    fingers' env closes its fingers, the arm's turns joint 0 by 0.3 rad."""
    rows = lambda i: torch.tensor([v[i] for v in CONTRACTS.values()],  # noqa: E731
                                  dtype=torch.float32)
    b = len(CONTRACTS)
    q = torch.tensor(np.concatenate([DEFAULT_JOINTS, [0.04, 0.04]]),
                     dtype=torch.float32).repeat(b, 1)
    q_target = q.clone()
    q_target[ENV["fingers"], 7:9] = 0.0
    q_target[ENV["arm"], 0] += 0.3
    quat = torch.tensor([1.0, 0, 0, 0]).repeat(b, 1)
    state = PhysicsState(arm=ArmState(q=q, qd=torch.zeros(b, 7), q_target=q_target),
                         obj=BodyState(pos=rows(1), quat=quat, linvel=rows(2), angvel=rows(3)),
                         contact_force=torch.zeros(b), gripper_contact=torch.zeros(b, dtype=torch.bool))
    libs = [v[0] for v in CONTRACTS.values()]
    sph, mass, inertia = (torch.cat([getattr(lib, k)[:1] for lib in libs])
                          for k in ("spheres", "mass", "inertia"))
    snaps = []
    for _ in range(1200 // CHUNK):
        state = step.physics_step(PC, state, sph, mass, inertia, substeps=CHUNK)
        snaps.append(state)
    return snaps


def at(snaps, substeps, name):
    """The contract env's object and arm after `substeps` substeps."""
    st = snaps[substeps // CHUNK - 1]
    return st.obj, st.arm, ENV[name]


def test_box_settles_at_rest_height(contracts):
    obj, _, e = at(contracts, 400, "settle")
    assert abs(float(obj.pos[e, 2]) - 0.07) < 2e-3
    assert float(obj.linvel[e].norm()) < 1e-2
    assert float(obj.angvel[e].norm()) < 1e-1


def test_no_energy_pumping(contracts):
    e = ENV["pumping"]
    zs = [float(at(contracts, n, "pumping")[0].pos[e, 2]) for n in (200, 400, 600, 800, 1000)]
    assert max(zs) - min(zs) < 1e-3, zs
    assert float(at(contracts, 1000, "pumping")[0].linvel[e].norm()) < 1e-2


def test_free_fall_gravity(contracts):
    obj, _, e = at(contracts, 100, "free_fall")
    assert abs(float(obj.pos[e, 2]) - (0.5 - 0.5 * 9.81 * 0.01)) < 2e-3


def test_sideways_push_friction_stops_slide(contracts):
    obj, _, e = at(contracts, 1200, "push")
    assert float(obj.linvel[e, 0].abs()) < 0.02, "friction failed to stop the slide"
    assert float(obj.angvel[e].norm()) < 0.2, "still rocking"
    assert abs(float(obj.pos[e, 2]) - 0.03) < 2e-3, "not resting on a face"


def test_torsional_friction_stops_spin(contracts):
    obj, _, e = at(contracts, 600, "spin")
    assert float(obj.angvel[e, 2].abs()) < 0.3, "spin not damped"
    assert abs(float(obj.pos[e, 0]) - 0.55) < 5e-3


def test_fingers_track_target_in_free_space(contracts):
    _, arm, e = at(contracts, 400, "fingers")
    np.testing.assert_allclose(arm.q[e, 7:9].numpy(), 0.0, atol=1e-4)


def test_arm_tracks_target(contracts):
    _, arm, e = at(contracts, 400, "arm")
    assert abs(float(arm.q[e, 0] - arm.q_target[e, 0])) < 1e-3
