"""Helpers of the grasp-rig tests: the JAX package's close-and-hold rig
returning its displacements, a seed index written by the JAX package,
and the port's rig cut short for tests of the loaders' plumbing."""

import dataclasses

import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation

from gaddpg_tpu.data.procgen import export_proc_seed_index
from gaddpg_tpu.physics.fast import fast_physics_step
from gaddpg_tpu.physics.types import ArmState, BodyState, PhysicsParams, PhysicsState
from gaddpg_tpu.robot.panda import DEFAULT_JOINTS, fk_hand
from gaddpg_tpu_torch.data import mesh_import


def cut_rig(monkeypatch, close_substeps=10, hold_substeps=30):
    """The port's verification rig at close_substeps + hold_substeps
    (the labels of such a rig are not the pipeline's: for tests of what
    carries the labels, not of the labels)."""
    full = mesh_import.rig_displacements

    def short(objects, close=None, hold=None, params=None):
        return full(objects, close_substeps, hold_substeps, params)

    monkeypatch.setattr(mesh_import, "rig_displacements", short)


def jax_displacements(spheres, mass, inertia, grasps):
    """`_verify_grasps_impl` of gaddpg_tpu/data/mesh_import.py:218-287,
    returning the displacements instead of the labels (the same program,
    so the same compile)."""
    n_real = len(grasps)
    G = 16 * ((n_real + 15) // 16)
    grasps = np.concatenate([np.asarray(grasps, np.float64),
                             np.tile(np.eye(4), (G - n_real, 1, 1))])
    hand = np.asarray(fk_hand(DEFAULT_JOINTS))
    obj_T = hand @ np.linalg.inv(grasps)
    pos = obj_T[:, :3, 3].astype(np.float32)
    quat = np.roll(Rotation.from_matrix(obj_T[:, :3, :3]).as_quat(), 1, axis=-1)
    q_open = np.concatenate([np.asarray(DEFAULT_JOINTS), [0.04, 0.04]])
    q_closed = q_open.copy()
    q_closed[7:9] = 0.0
    state = PhysicsState(
        arm=ArmState(q=jnp.tile(jnp.asarray(q_open, jnp.float32), (G, 1)), qd=jnp.zeros((G, 7)),
                     q_target=jnp.tile(jnp.asarray(q_closed, jnp.float32), (G, 1))),
        obj=BodyState(pos=jnp.asarray(pos), quat=jnp.asarray(quat, jnp.float32),
                      linvel=jnp.zeros((G, 3)), angvel=jnp.zeros((G, 3))),
        contact_force=jnp.zeros(G), gripper_contact=jnp.zeros(G, bool))
    sph = jnp.tile(jnp.asarray(spheres, jnp.float32)[None], (G, 1, 1))
    m = jnp.full((G,), float(mass), jnp.float32)
    it = jnp.tile(jnp.asarray(inertia, jnp.float32)[None], (G, 1))
    base = PhysicsParams()
    state = fast_physics_step(dataclasses.replace(base, gravity=0.0, table_z=-10.0), state, sph,
                              m, it, substeps=250, scan_impl="xla")
    state = fast_physics_step(dataclasses.replace(base, table_z=-10.0), state, sph, m, it,
                              substeps=750, scan_impl="xla")
    return np.asarray(jnp.linalg.norm(state.obj.pos - jnp.asarray(pos), axis=-1))[:n_real]


def jax_seed_index(path, n_train, n_test, seed0, test_seed0=100000):
    """A seed index the JAX package writes (its rig, its manifest)."""
    export_proc_seed_index(str(path), n_train, n_test, seed0=seed0, test_seed0=test_seed0,
                           log_every=0)
    return str(path)
