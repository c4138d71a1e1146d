"""The capacity-sharded replay ring on 2 and 4 gloo ranks: slot j's
points on rank j // (size / n), the other fields replicated
(gaddpg_tpu_torch/replay/buffer.py).

- `add_episodes`: each rank inserts its envs' episodes. The gathered
  ring equals the one-rank ring bit for bit, field by field, with the
  cursors, and so the JAX package's (`replay.add_episodes`), but for
  `returns`: there the one-rank port is one float32 ulp off JAX on some
  slots (JAX's r + gamma * carry compiles to one rounding, the port's to
  two), held within 1e-6 as tests/test_torch_replay.py holds it.
  The inserts wrap the ring within a call and across calls, and
  episodes end on a shard's last slot (slots 7, 15 and 23).
- `sample` at given global indices, every slot once, so that next
  states cross every shard boundary an episode spans: each rank's rows
  equal its rows of the one-rank sample bit for bit.
- drawn indices: every rank draws the one-rank run's global indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaddpg_tpu import replay as jreplay
from gaddpg_tpu_torch.parallel import launch
from test_torch_replay import FIELDS, NPTS, T, episodes
from torch_dp_ranks import ring_rank

SIZE = 32
GAMMA = 0.95
# valid steps of each episode, 8 envs a call: the first call's episodes
# end on slots 2, 7, -, 11, 15, 21, 23, 29; the second's restart at 0
COUNTS = ([3, 5, 0, 4, 4, 6, 2, 6], [4, 6, 2, 5, 6, 3, 6, 1], [6, 6, 5, 0, 2, 6, 4, 3])
LAUNCH_S = 90.0


def _inserts():
    out = []
    for seed, counts in enumerate(COUNTS):
        ep, _ = episodes(40 + seed, len(counts))
        rng = np.random.RandomState(seed)
        valid = np.zeros((len(counts), T), bool)
        for e, c in enumerate(counts):  # c valid steps at random places
            valid[e, np.sort(rng.permutation(T)[:c])] = True
        out.append((ep, valid))
    return out


SAMPLES = [np.arange(SIZE, dtype=np.int64), np.random.RandomState(7).randint(0, SIZE, 16)]


@pytest.fixture(scope="module")
def one_rank():
    return ring_rank(None, _inserts(), SIZE, NPTS, SAMPLES, 5)


@pytest.fixture(scope="module")
def jax_ring():
    buf = jreplay.create_buffer(SIZE, num_points=NPTS)
    add = jax.jit(jreplay.add_episodes, static_argnames=("gamma",))
    for ep, valid in _inserts():
        buf = add(buf, {k: jnp.asarray(v) for k, v in ep.items()}, jnp.asarray(valid),
                  gamma=GAMMA)
    return buf


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, launch(ring_rank, world, args=(_inserts(), SIZE, NPTS, SAMPLES, 5),
                         devices=["cpu"] * world,
                         rendezvous_dir=tmp_path_factory.mktemp("rdv"), timeout_s=LAUNCH_S)


def test_gathered_ring_equals_one_rank_and_jax(ranks, one_rank, jax_ring):
    world, outs = ranks
    ring, cursors = one_rank[0], one_rank[1]
    assert cursors[0] < cursors[1] == SIZE  # the ring wrapped
    for k in FIELDS:
        want = np.asarray(getattr(jax_ring, k))
        if k == "returns":
            np.testing.assert_allclose(ring[k], want, rtol=0, atol=1e-6, err_msg=k)
        elif k != "image_state":
            np.testing.assert_array_equal(ring[k], want, err_msg=k)
    assert cursors == (int(jax_ring.cur_idx), int(jax_ring.filled),
                       int(jax_ring.total_env_step))
    for r, out in enumerate(outs):
        assert out[1] == cursors
        assert out[4] == SIZE // world  # this rank's slots of the points
        for k in ring:
            np.testing.assert_array_equal(out[0][k], ring[k], err_msg=f"rank {r} {k}")


def test_samples_across_shard_boundaries(ranks, one_rank):
    world, outs = ranks
    ep_map = one_rank[0]["episode_map"]
    idx = SAMPLES[0]
    nxt = np.minimum(ep_map[idx], idx + 1)
    shard = SIZE // world
    assert np.any(idx // shard != nxt // shard), "no next state crosses a shard boundary"
    for r, out in enumerate(outs):
        for want_all, got in zip(one_rank[2], out[2]):
            b = len(want_all["batch_idx"]) // world
            for k, want in want_all.items():
                np.testing.assert_array_equal(got[k], want[r * b:(r + 1) * b],
                                              err_msg=f"rank {r} {k}")


def test_drawn_indices_equal_on_every_rank(ranks, one_rank):
    world, outs = ranks
    for out in outs:
        np.testing.assert_array_equal(out[3][:4 * world], _draw_one_rank(world))


def _draw_one_rank(world):
    """The one-rank ring's draw of a 4 n batch from the same seed."""
    import torch

    from gaddpg_tpu_torch import replay

    buf = replay.create_buffer(SIZE, num_points=NPTS, device="cpu")
    ring = ring_rank(None, _inserts(), SIZE, NPTS, [], 5)
    for k, v in ring[0].items():
        getattr(buf, k).copy_(torch.from_numpy(v))
    buf.cur_idx, buf.filled, buf.total_env_step = ring[1]
    return replay.sample(buf, 4 * world, episode_max_len=2,
                         generator=torch.Generator().manual_seed(5))["batch_idx"].numpy()
