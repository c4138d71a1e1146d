"""The replay ring of the port (`gaddpg_tpu_torch.replay`) against the JAX
package's on the same numpy episodes, on the CPU.

- `add_episodes`: episodes with invalid steps in the middle and at the
  end (the valid-first compaction), collisions (the `collide_future`
  reverse max-scan), an episode with no valid step, and two calls into
  a ring of 16 slots, so that episodes restart at slot 0 within one call
  and across calls (an episode never straddles the ring). Every field
  and cursor equals JAX's; `returns` within 1e-6 (float32 sums of
  gamma-discounted rewards, in the same order in both packages).
- `sample`: with JAX's own `randint` indices passed in as `idx`, every
  field equals JAX's, the HER-style relabel of non-expert rows within
  1e-6 (a 4x4 product and a quaternion extraction in float32).
- `save_npz` / `load_npz` across the two packages, both ways, with
  `image_state` stored as float16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu import replay as jreplay
from gaddpg_tpu_torch import replay
from gaddpg_tpu_torch.geometry.rotations import quat_to_mat

SIZE, T, NPTS = 16, 6, 20
IMAGE = (5, 4, 4)
FIELDS = ("point_state", "image_state", "action", "expert_action", "reward", "returns",
          "terminal", "timestep", "state_pose", "goal", "expert_flags", "perturb_flags",
          "collide", "collide_future", "grasp", "target_idx", "episode_map")


def episodes(seed, e_count, image=False):
    """(episodes (E, T, ...) as numpy, valid (E, T)): random contents,
    rewards on the last valid step, hand poses with random rotations."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    quat = rng.randn(e_count, T, 4)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pose = np.tile(np.eye(4, dtype=np.float32), (e_count, T, 1, 1))
    pose[..., :3, :3] = quat_to_mat(torch.as_tensor(f32(quat))).numpy()
    pose[..., :3, 3] = rng.randn(e_count, T, 3) * 0.2
    ep = {
        "point_state": f32(rng.randn(e_count, T, 4, NPTS)),
        "action": f32(rng.randn(e_count, T, 6)),
        "expert_action": f32(rng.randn(e_count, T, 6)),
        "reward": f32(rng.uniform(0, 1, (e_count, T)) * (rng.rand(e_count, T) < 0.4)),
        "terminal": f32(rng.rand(e_count, T) < 0.2),
        "timestep": f32(np.tile(np.arange(T), (e_count, 1))),
        "state_pose": pose,
        "goal": f32(rng.randn(e_count, T, 7)),
        "expert_flags": f32(rng.randint(0, 3, (e_count, T))),
        "perturb_flags": f32(rng.rand(e_count, T) < 0.3),
        "collide": f32(rng.rand(e_count, T) < 0.2),
        "grasp": f32(rng.rand(e_count, T) < 0.2),
        "target_idx": f32(rng.randint(0, 5, (e_count, T))),
    }
    if image:
        ep["image_state"] = f32(rng.uniform(0, 1, (e_count, T) + IMAGE))
    valid = rng.rand(e_count, T) < 0.75
    valid[0] = [True, False, True, True, False, True]   # holes inside the episode
    valid[1] = False                                    # no valid step
    return ep, valid


def jax_buffer(batches, image=False):
    buf = jreplay.create_buffer(SIZE, num_points=NPTS, image_shape=IMAGE if image else None)
    add = jax.jit(jreplay.add_episodes, static_argnames=("gamma",))
    for ep, valid in batches:
        buf = add(buf, {k: jnp.asarray(v) for k, v in ep.items()}, jnp.asarray(valid),
                  gamma=0.9)
    return buf


def port_buffer(batches, image=False):
    buf = replay.create_buffer(SIZE, num_points=NPTS, image_shape=IMAGE if image else None,
                               device="cpu")
    for ep, valid in batches:
        replay.add_episodes(buf, {k: torch.as_tensor(v) for k, v in ep.items()},
                            torch.as_tensor(valid), gamma=0.9)
    return buf


def _np(x):
    return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()


def assert_buffers_equal(port, ref):
    for k in FIELDS:
        got, want = _np(getattr(port, k)), np.asarray(getattr(ref, k)).astype(np.float64)
        if k == "returns":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert (port.cur_idx, port.filled, port.total_env_step) == (
        int(ref.cur_idx), int(ref.filled), int(ref.total_env_step))


BATCHES = [episodes(0, 4), episodes(1, 5)]


@pytest.fixture(scope="module")
def buffers():
    return port_buffer(BATCHES), jax_buffer(BATCHES)


def test_add_episodes_matches_jax(buffers):
    port, ref = buffers
    # the case is what it claims: the ring restarted at 0 in a call
    assert port.total_env_step > SIZE and port.cur_idx < port.total_env_step
    assert port.collide_future.sum() > port.collide.sum()
    assert_buffers_equal(port, ref)


def test_add_episode_one_at_a_time_matches_batch(buffers):
    port, _ = buffers
    one = replay.create_buffer(SIZE, num_points=NPTS, device="cpu")
    for ep, valid in BATCHES:
        for e in range(valid.shape[0]):
            replay.add_episode(one, {k: torch.as_tensor(v[e]) for k, v in ep.items()},
                               torch.as_tensor(valid[e]), gamma=0.9)
    for k in FIELDS:
        torch.testing.assert_close(getattr(one, k), getattr(port, k), rtol=0, atol=0, msg=k)
    assert (one.cur_idx, one.filled, one.total_env_step) == (
        port.cur_idx, port.filled, port.total_env_step)


@pytest.mark.parametrize("onpolicy_goal", [False, True])
def test_sample_matches_jax(buffers, onpolicy_goal):
    port, ref = buffers
    out = jreplay.sample(ref, jax.random.PRNGKey(3), 32, episode_max_len=2,
                         onpolicy_goal=onpolicy_goal)
    idx = torch.as_tensor(np.array(out["batch_idx"]))
    got = replay.sample(port, 32, episode_max_len=2, onpolicy_goal=onpolicy_goal, idx=idx)
    assert set(got) == set(out)
    for k, want in out.items():
        want = np.asarray(want)
        if k in ("goal", "next_goal") and onpolicy_goal:
            np.testing.assert_allclose(got[k].numpy(), want, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    if onpolicy_goal:  # rows were relabelled, and only non-expert ones
        relabelled = ~np.isclose(got["goal"].numpy(), port.goal[idx].numpy()).all(axis=1)
        assert relabelled.any()
        assert (got["expert_flags"].numpy()[relabelled] == 0).all()


def test_sample_draws_in_range():
    buf = port_buffer(BATCHES[:1])
    gen = torch.Generator().manual_seed(0)
    idx = replay.sample(buf, 256, episode_max_len=2, generator=gen)["batch_idx"]
    upper = replay.upper_idx(buf)
    assert int(idx.min()) >= min(2, upper - 1) and int(idx.max()) < upper


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_roundtrip_across_packages(tmp_path, writer):
    batches = [episodes(2, 4, image=True), episodes(3, 3, image=True)]
    port, ref = port_buffer(batches, image=True), jax_buffer(batches, image=True)
    path = str(tmp_path / "buf.npz")
    if writer == "jax":
        jreplay.save_npz(ref, path)
        loaded = replay.load_npz(path, buffer_size=SIZE, num_points=NPTS, device="cpu")
        src = port
    else:
        replay.save_npz(port, path)
        loaded = jreplay.load_npz(path, buffer_size=SIZE, num_points=NPTS)
        src = ref
    data = np.load(path)
    assert data["image_state"].dtype == np.float16 and data["episode_map"].dtype == np.uint32
    n = max(int(src.filled), 1)
    for k in FIELDS:
        got = _np(getattr(loaded, k)) if writer == "jax" else np.asarray(getattr(loaded, k))
        want = _np(getattr(src, k)) if writer == "jax" else np.asarray(getattr(src, k))
        want = want.astype(np.float64)
        if k == "image_state":  # bfloat16 in memory, float16 on disk
            np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=4e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(got[:n], want[:n], err_msg=k)
    assert (int(loaded.cur_idx), int(loaded.filled), int(loaded.total_env_step)) == (
        int(src.cur_idx), int(src.filled), int(src.total_env_step))


def test_load_npz_reference_layouts(tmp_path):
    """A reference-style dump: (N, 1, 6) actions, wider point states, no
    collide_future: both packages load it the same way."""
    rng = np.random.RandomState(4)
    n = 10
    ep_map = np.array([2, 2, 2, 6, 6, 6, 6, 9, 9, 9], np.uint32)
    data = {"action": rng.randn(n, 1, 6).astype(np.float32),
            "point_state": rng.randn(n, 4, NPTS + 5).astype(np.float32),
            "reward": rng.rand(n).astype(np.float32),
            "collide": (rng.rand(n) < 0.3).astype(np.float32),
            "episode_map": ep_map, "cur_idx": n}
    path = str(tmp_path / "ref.npz")
    np.savez(path, **data)
    port = replay.load_npz(path, num_points=NPTS, device="cpu")
    ref = jreplay.load_npz(path, num_points=NPTS)
    for k in ("action", "point_state", "reward", "collide", "collide_future", "episode_map"):
        np.testing.assert_array_equal(_np(getattr(port, k)), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    assert (port.cur_idx, port.filled, port.total_env_step) == (
        int(ref.cur_idx), int(ref.filled), int(ref.total_env_step))


def test_buffer_defaults_to_the_card():
    if torch.cuda.is_available():
        assert replay.create_buffer(4, num_points=8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            replay.create_buffer(4, num_points=8)
