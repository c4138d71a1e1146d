"""The clutter env's scenes and reset on the CPU against the JAX
package's (tests/test_torch_clutter_env.py's sizes: the flagship dryrun
tier's, the goal servo, the YCB proxy library), and the clutter-clear
grasp mask.

Bounds and why:
- sample_scene from the JAX package's own draws (its key splits): the
  grid cells, the target's and the clutter's poses within 1e-6 and their
  indices equal; the IK start reaches the same hand pose within 1e-2, as
  tests/test_torch_env.py holds it (the IK's argmin may pick another
  near-tied seed);
- reset_scene (the joint 20-substep settle through multi_physics_step):
  every body's physics fields within 2e-5 (the JAX suite's step-vs-fast
  bound), validity (the clutter-clear grasp mask included) and the
  target-point count equal, the goal within 1e-6, the reservoir by
  tests/test_torch_env.py's rule (at most 3% of the sampled points
  without a JAX reservoir point within 1e-4), the obstacle-labelled
  points of the reservoir within 1% + 2;
- clutter_clear_mask on seeded grasps and spheres equal to the JAX mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.expert import goals as jgoals
from gaddpg_tpu.robot.panda import fk_hand as jfk_hand
from gaddpg_tpu_torch.expert import goals
from gaddpg_tpu_torch.robot.panda import fk_hand
from test_torch_clutter_env import (  # noqa: F401  (module fixtures)
    K, SEEDS, assert_clutter_close, assert_counts_close, envs, obstacle_counts,
)
from test_torch_env import _reservoir_share
from torch_env_common import assert_phys_close, env_observe_draws, scenes


@pytest.fixture(scope="module")
def jax_scenes(envs):
    return scenes(envs[0], SEEDS)


@pytest.fixture(scope="module")
def reset(envs, jax_scenes):
    jenv, env = envs
    sc = jax_scenes
    keys = jnp.stack([jax.random.PRNGKey(100 + s) for s in SEEDS])
    jst, job = jax.jit(jax.vmap(jenv.reset_scene))(sc, keys)
    draws = env_observe_draws(jenv, jax.vmap(lambda k: jax.random.fold_in(k, 17))(keys),
                              jst.pc.count)
    st, ob = env.reset_scene(sc, draws=draws)
    return sc, jst, job, st, ob


def test_sample_scene_matches_jax_draws(envs, jax_scenes):
    jenv, env = envs
    n, jit = jenv.lib.num_objects, jenv.p.clutter_jitter
    split = [jax.random.split(jax.random.PRNGKey(s), 12) for s in SEEDS]

    def draw(f):
        return torch.as_tensor(np.stack([np.asarray(f(ks)) for ks in split]))

    def uniform(i, shape, lo, hi):
        return draw(lambda ks: jax.random.uniform(ks[i], shape, minval=lo, maxval=hi))

    d = {"obj_idx": draw(lambda ks: jax.random.randint(ks[0], (), 0, n)),
         "perm": draw(lambda ks: jax.random.permutation(ks[1], 9)),
         "cell_jitter": uniform(2, (K + 1, 2), -jit, jit),
         "clutter_idx": draw(lambda ks: jax.random.randint(ks[8], (K,), 0, n)),
         "clutter_yaw": uniform(9, (K,), -jnp.pi, jnp.pi),
         "yaw": uniform(3, (), -jnp.pi, jnp.pi), "theta": uniform(4, (), 0.0, 2 * jnp.pi / 3),
         "phi": uniform(5, (), jnp.pi / 2, 3 * jnp.pi / 2),
         "r": uniform(6, (), jenv.p.init_near, jenv.p.init_far),
         "jitter": uniform(7, (3,), -0.03, 0.03)}
    sc = jax_scenes
    mine = env.sample_scene(len(SEEDS), draws=d)
    for k in ("obj_idx", "clutter_idx", "ik_ok"):
        np.testing.assert_array_equal(mine[k].numpy(), sc[k], err_msg=k)
    for k in ("obj_pos", "obj_quat", "clutter_pos", "clutter_quat"):
        np.testing.assert_allclose(mine[k].numpy(), sc[k], atol=1e-6, rtol=0, err_msg=k)
    hand = fk_hand(mine["joints"])[:, :3, 3].numpy()
    want = np.asarray(jax.vmap(jfk_hand)(jnp.asarray(sc["joints"])))[:, :3, 3]
    np.testing.assert_allclose(hand, want, atol=1e-2)
    # distinct grid cells: the bodies stand apart
    xy = np.concatenate([sc["obj_pos"][:, None, :2], sc["clutter_pos"][..., :2]], axis=1)
    gaps = np.linalg.norm(xy[:, :, None] - xy[:, None], axis=-1) + 9 * np.eye(K + 1)
    assert gaps.min() > 0.05


def test_reset_scene_matches_jax(reset):
    _, jst, job, st, ob = reset
    assert_phys_close(st.phys, jst.phys, {k: 2e-5 for k in ("pos", "quat", "linvel", "angvel",
                                                           "fingers", "arm_q")})
    assert_clutter_close(st, jst, {"pos": 2e-5, "quat": 2e-5})
    assert not st.clutter_linvel.any() and not st.clutter_angvel.any()
    np.testing.assert_array_equal(st.valid_scene.numpy(), np.asarray(jst.valid_scene))
    assert st.valid_scene.any()
    np.testing.assert_allclose(st.goal_obj.numpy(), np.asarray(jst.goal_obj), atol=1e-6)
    np.testing.assert_array_equal(ob.num_points.numpy(), np.asarray(job.num_points))
    assert max(_reservoir_share(ob, jst, job)) <= 0.03
    assert_counts_close(obstacle_counts(st.pc.labels, st.pc.count),
                        obstacle_counts(jst.pc.labels, jst.pc.count))


def test_clutter_clear_mask_matches_jax():
    rng = np.random.RandomState(4)
    b, g, s = 3, 40, 24
    rot = np.linalg.qr(rng.randn(b * g, 3, 3))[0].reshape(b, g, 3, 3)
    grasps = np.tile(np.eye(4), (b, g, 1, 1))
    grasps[..., :3, :3] = rot
    grasps[..., :3, 3] = rng.uniform(-0.1, 0.1, (b, g, 3))
    spheres = np.concatenate([rng.uniform(-0.1, 0.1, (b, s, 3)),
                              rng.uniform(0.0, 0.04, (b, s, 1))], axis=-1)
    spheres[:, -4:, 3] = 0.0                                     # padding
    grasps, spheres = grasps.astype(np.float32), spheres.astype(np.float32)
    got = goals.clutter_clear_mask(torch.as_tensor(grasps), torch.as_tensor(spheres))
    want = jax.vmap(jgoals.clutter_clear_mask)(jnp.asarray(grasps), jnp.asarray(spheres))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()
    # tests/test_clutter_expert.py's buried goal: clear without clutter,
    # rejected with a sphere on it
    top = torch.eye(4)
    top[:3, :3] = torch.diag(torch.tensor([1.0, -1.0, -1.0]))
    top[:3, 3] = torch.tensor([0.5, 0.0, 0.1])
    assert goals.clutter_clear_mask(top[None, None], torch.zeros(1, 0, 4)).all()
    assert not goals.clutter_clear_mask(top[None, None],
                                        torch.tensor([[[0.5, 0.0, 0.1, 0.05]]])).any()
