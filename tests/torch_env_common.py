"""Shared pieces of the env parity tests (tests/test_torch_env*.py): the
JAX env and the port's on the same library, JAX scenes and the JAX
package's random draws as tensors for the port; the planner's chaos rule
(tests/test_torch_chomp.py, test_torch_env_planner.py and
test_torch_train_planner.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaddpg_tpu.envs import EnvParams as JaxEnvParams
from gaddpg_tpu.envs import PandaGraspEnv as JaxPandaGraspEnv
from gaddpg_tpu_torch.envs.assets import LIBRARY_FIELDS, library_from_arrays
from gaddpg_tpu_torch.envs.grasp_env import EnvParams, PandaGraspEnv, state_from_numpy


# A plan of the port against the JAX package's: within PLAN_TOL where
# one-ulp nudges of the reference's inputs leave its own plan within
# PLAN_TOL (1.0e-6 is the largest such spread measured, 3e-7 the port's
# departure); else a hinge of the obstacle cost flips within the 30
# preconditioned descent steps, the plan is chaotic, and the port's must
# lie within CHAOS_FACTOR times the reference's own spread
PLAN_TOL = 1e-5
CHAOS_FACTOR = 2.0


def plan_bounds(plan, ref, nudged):
    """(departure, spread, bound), each (B,): the plans `plan` (B, S, 7)
    against the reference plans `ref` (B, S, 7), the reference's own
    spread over its plans `nudged` (P, B, S, 7) from one-ulp nudges of its
    inputs, and the chaos rule's bound on the departure."""
    ref = np.asarray(ref)
    err = np.abs(np.asarray(plan) - ref).max(axis=(1, 2))
    spread = np.abs(np.asarray(nudged) - ref[None]).max(axis=(0, 2, 3))
    return err, spread, np.where(spread <= PLAN_TOL, PLAN_TOL, CHAOS_FACTOR * spread)


def nudged_joints(jst, count, seed):
    """`count` copies of the JAX env states `jst` along the batch, the
    arm's seven joints of each copy moved by one ulp, up or down at random
    (numpy's RandomState(seed))."""
    rep = jax.tree_util.tree_map(lambda x: np.concatenate([np.asarray(x)] * count), jst)
    q = np.array(rep.phys.arm.q)
    rng = np.random.RandomState(seed)
    q[:, :7] = np.nextafter(q[:, :7], (q[:, :7] + rng.choice([-1.0, 1.0], q[:, :7].shape)
                                       ).astype(np.float32))
    return rep.replace(phys=rep.phys.replace(arm=rep.phys.arm.replace(q=jnp.asarray(q))))


def make_envs(jax_lib, jax_params=None, params=None):
    """(JAX env, port env on the CPU), by default with `use_planner=False`,
    the port's library carried over from the JAX one."""
    lib = library_from_arrays(jax_lib.names, **{k: np.asarray(getattr(jax_lib, k))
                                                 for k in LIBRARY_FIELDS})
    return (JaxPandaGraspEnv(jax_params or JaxEnvParams(use_planner=False), jax_lib),
            PandaGraspEnv(params or EnvParams(use_planner=False), lib, device="cpu"))


def numpy_tree(x):
    """Nested dict of numpy leaves of a JAX dataclass pytree."""
    return jax.tree_util.tree_map(np.asarray, dataclasses.asdict(x))


def port_state(jax_state):
    return state_from_numpy(numpy_tree(jax_state), device="cpu")


def scenes(jenv, seeds):
    """Batched JAX scenes from `sample_scene(PRNGKey(s))`, one seed at a
    time (only its IK is compiled: quicker than compiling the vmap)."""
    one = [jenv.sample_scene(jax.random.PRNGKey(s)) for s in seeds]
    return jax.tree_util.tree_map(lambda *x: np.stack([np.asarray(a) for a in x]), *one)


def jax_retract_batched(jenv, states):
    """The JAX package's `retract_batched` (close the fingers for 2 x
    substeps, then `retract_lift_steps` x (IK 3 cm up, physics step),
    score the lift), with its steps unrolled in Python so that the close
    and one lift step compile once each (once per env) instead of as one
    scan."""
    close, lift = _jax_retract_parts(jenv)
    states = close(states)
    for _ in range(jenv.p.retract_lift_steps):
        states = lift(states)
    lifted = (states.phys.obj.pos[:, 2] - states.init_obj_z) > jenv.p.lift_height
    return states, np.asarray(lifted, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_retract_parts(jenv):
    """The jitted close and lift step of `jax_retract_batched` for `jenv`."""
    from gaddpg_tpu.robot.ik import dls_ik

    p = jenv.p

    def set_target(s, q_t):
        return s.replace(phys=s.phys.replace(arm=s.phys.arm.replace(q_target=q_t)))

    def close(s):
        s = set_target(s, s.phys.arm.q_target.at[:, 7:9].set(0.0))
        return jenv._physics_batched(s, substeps=2 * p.physics.substeps)

    def lift(s):
        def one(es):
            hand = jenv._hand(es)
            q, _, _ = dls_ik(es.phys.arm.q[:7], hand[:3, 3] + jnp.array([0.0, 0.0, p.retract_step_dz]),
                             hand[:3, :3], iters=p.step_ik_iters)
            return jnp.concatenate([q, jnp.zeros(2)])

        return jenv._physics_batched(set_target(s, jax.vmap(one)(s)))

    return jax.jit(close), jax.jit(lift)


def observe_draws(obs_keys, count, capacity=2048, n_new=512, n_pts=1024, n_clutter=0):
    """The draws the JAX `_observe_impl` makes from its per-env keys:
    keep-uniforms, with clutter (`n_clutter` obstacle points per step) the
    obstacle points' keep-uniforms, and the resample indices below
    max(num_valid, 1), where `count` is the JAX reservoir count after this
    observation."""
    keep, ckeep, idx = [], [], []
    for k, c in zip(obs_keys, np.asarray(count)):
        k1, k2, k3 = jax.random.split(k, 3)
        keep.append(np.asarray(jax.random.uniform(k1, (n_new,))))
        ckeep.append(np.asarray(jax.random.uniform(k3, (n_clutter,))))
        idx.append(np.asarray(jax.random.randint(k2, (n_pts,), 0, max(min(int(c), capacity), 1))))
    out = {"keep_u": torch.as_tensor(np.stack(keep)), "idx": torch.as_tensor(np.stack(idx))}
    if n_clutter:
        out["clutter_keep_u"] = torch.as_tensor(np.stack(ckeep))
    return out


def env_observe_draws(jenv, obs_keys, count):
    """`observe_draws` at the sizes of the JAX env `jenv`."""
    p = jenv.p
    return observe_draws(obs_keys, count, p.pc_capacity, p.new_points_per_step,
                         p.uniform_num_pts,
                         p.clutter_points_per_step if p.num_clutter else 0)


def jax_state(state):
    """A JAX EnvState from a port EnvState on the CPU: the inverse of
    `port_state`."""
    from gaddpg_tpu.envs.grasp_env import EnvState as JaxEnvState
    from gaddpg_tpu.physics import types as jtypes
    from gaddpg_tpu.render.pointcloud import PointCloudState as JaxPointCloudState

    def j(t, dtype=None):
        a = t.numpy()
        return jnp.asarray(a if dtype is None else a.astype(dtype))

    ph, arm, obj = state.phys, state.phys.arm, state.phys.obj
    fields = {f.name: j(getattr(state, f.name), np.int32 if getattr(state, f.name).dtype
                        in (torch.int64, torch.int32) else None)
              for f in dataclasses.fields(state) if f.name not in ("phys", "pc", "vis_seed")}
    return JaxEnvState(
        phys=jtypes.PhysicsState(
            arm=jtypes.ArmState(q=j(arm.q), qd=j(arm.qd), q_target=j(arm.q_target)),
            obj=jtypes.BodyState(pos=j(obj.pos), quat=j(obj.quat), linvel=j(obj.linvel),
                                 angvel=j(obj.angvel)),
            contact_force=j(ph.contact_force), gripper_contact=j(ph.gripper_contact)),
        pc=JaxPointCloudState(points=j(state.pc.points), labels=j(state.pc.labels),
                              count=j(state.pc.count), cursor=j(state.pc.cursor)),
        vis_seed=j(state.vis_seed, np.int32), **fields)


def point_state_mismatch(port_ps, jax_ps, tol=1e-4):
    """Share of the sampled points (columns past the 6 anchors) whose
    coordinates differ by more than `tol`; the anchors must be equal."""
    a, b = port_ps.numpy(), np.asarray(jax_ps)
    np.testing.assert_array_equal(a[:, :, :6], b[:, :, :6])
    bad = (np.abs(a[:, :, 6:] - b[:, :, 6:]) > tol).any(axis=1)
    return float(bad.mean())


def assert_phys_close(port, ref, bounds):
    """A port PhysicsState against a JAX one (numpy leaves)."""
    pairs = {"pos": (port.obj.pos, ref.obj.pos), "quat": (port.obj.quat, ref.obj.quat),
             "linvel": (port.obj.linvel, ref.obj.linvel),
             "angvel": (port.obj.angvel, ref.obj.angvel),
             "fingers": (port.arm.q[:, 7:9], ref.arm.q[:, 7:9]),
             "arm_q": (port.arm.q[:, :7], ref.arm.q[:, :7])}
    for name, tol in bounds.items():
        a, b = pairs[name]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(port.gripper_contact.numpy(), np.asarray(ref.gripper_contact))
