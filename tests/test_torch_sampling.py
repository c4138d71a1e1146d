"""K1 (FPS) and K2 (ball query): the port's plain versions, as its
wrappers run them on CPU tensors, against the JAX package's XLA path
(ops/sampling.py) and its Pallas kernels in interpret mode. Indices must
be exactly equal.
"""

import jax
import numpy as np
import pytest
import torch

from gaddpg_tpu.ops import sampling as jax_sampling
from gaddpg_tpu.ops.pallas_kernels import ball_query_pallas, fps_pallas
from gaddpg_tpu_torch.ops import sampling


def cloud(n, seed, batch=None, scale=0.05):
    rng = np.random.RandomState(seed)
    shape = (n, 3) if batch is None else (batch, n, 3)
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("n,npoint,seed", [(1024, 32, 0), (32, 32, 1), (256, 16, 2)])
def test_fps_matches_jax(n, npoint, seed):
    """SA1 (1024 -> 32) and SA2 (32 -> 32) shapes."""
    xyz = cloud(n, seed)
    got = sampling.furthest_point_sampling(torch.from_numpy(xyz)[None], npoint)[0].numpy()
    assert got.dtype == np.int32 and got.shape == (npoint,)
    np.testing.assert_array_equal(got, np.asarray(jax_sampling.furthest_point_sampling(xyz, npoint)))
    np.testing.assert_array_equal(got, np.asarray(fps_pallas(xyz, npoint, interpret=True)))


def _tie_cloud(kind, n, seed):
    """A cloud whose FPS steps tie: 8 points repeated (every later step
    ties at distance 0 or between copies), or points on an integer grid
    (squared distances are small integers)."""
    rng = np.random.RandomState(seed)
    if kind == "repeated":
        return np.tile(rng.rand(8, 3).astype(np.float32), (-(-n // 8), 1))[:n]
    return rng.randint(0, 4, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1030, 1031])
@pytest.mark.parametrize("kind", ["repeated", "grid"])
def test_fps_ties_match_pallas(kind, n):
    """Exact ties go to the lowest index, as in the Pallas kernel, on
    clouds around the warp's 32 lanes (K1 gives lane l the points l, l +
    32, ...) and the SA1 size."""
    xyz = _tie_cloud(kind, n, 20 + n)
    got = sampling.furthest_point_sampling(torch.from_numpy(xyz)[None], 32)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(fps_pallas(xyz, 32, interpret=True)))


def warp_argmax(dist):
    """A model of K1's argmax over one cloud's distance registers
    (csrc/fps.cu): lane l visits points l, l + 32, ... in order keeping
    the first of equal values (a strict >), then a __shfl_xor_sync
    butterfly over offsets 16, 8, 4, 2, 1 takes the other lane's pair when
    its value is larger, or equal with a lower index. Every lane ends
    with the same pair; returns its index."""
    n = len(dist)
    best = []
    for lane in range(32):
        b, bi = -1.0, n
        for j in range(lane, n, 32):
            if dist[j] > b:
                b, bi = dist[j], j
        best.append((b, bi))
    for off in (16, 8, 4, 2, 1):
        nxt = []
        for lane in range(32):
            (b, bi), (v, k) = best[lane], best[lane ^ off]
            nxt.append((v, k) if v > b or (v == b and k < bi) else (b, bi))
        best = nxt
    assert len(set(best)) == 1
    return best[0][1]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1030, 1031])
def test_warp_argmax_model_is_the_first_maximum(n):
    """The lane ownership and butterfly tie rule pick what torch.argmax
    picks (the first maximum), on registers with many ties."""
    rng = np.random.RandomState(n)
    for _ in range(20):
        dist = rng.randint(0, 3, n).astype(np.float32)
        assert warp_argmax(dist.tolist()) == int(torch.argmax(torch.from_numpy(dist)))


def test_fps_batch_matches_vmap():
    xyzs = cloud(1024, 3, batch=4)
    got = sampling.furthest_point_sampling(torch.from_numpy(xyzs), 32).numpy()
    want = jax.vmap(lambda p: jax_sampling.furthest_point_sampling(p, 32))(xyzs)
    np.testing.assert_array_equal(got, np.asarray(want))


def _centres(xyz, npoint):
    idx = np.asarray(jax_sampling.furthest_point_sampling(xyz, npoint))
    return xyz[idx]


@pytest.mark.parametrize("n,radius,nsample,seed", [
    (1024, 0.02, 64, 4),   # SA1
    (32, 0.04, 128, 5),    # SA2: more slots than points
    (256, 0.03, 24, 6),
])
def test_ball_query_matches_jax(n, radius, nsample, seed):
    xyz = cloud(n, seed)
    centres = _centres(xyz, 32 if n >= 32 else n)
    got = sampling.ball_query(torch.from_numpy(centres)[None], torch.from_numpy(xyz)[None],
                              radius, nsample)[0].numpy()
    assert got.dtype == np.int32 and got.shape == (len(centres), nsample)
    np.testing.assert_array_equal(got, np.asarray(jax_sampling.ball_query(centres, xyz, radius, nsample)))
    np.testing.assert_array_equal(
        got, np.asarray(ball_query_pallas(centres, xyz, radius, nsample, interpret=True)))


def test_ball_query_sparse_radius_and_empty_centres():
    """Few hits pad with the first hit; centres with no hit take their
    nearest point (the last two centres lie far outside the cloud)."""
    xyz = cloud(256, 7)
    centres = np.concatenate([xyz[:4], np.array([[0.5, 0.5, 0.5], [-1.0, 0.2, 0.0]],
                                                np.float32)])
    got = sampling.ball_query(torch.from_numpy(centres)[None], torch.from_numpy(xyz)[None],
                              0.005, 8)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sampling.ball_query(centres, xyz, 0.005, 8)))
    np.testing.assert_array_equal(
        got, np.asarray(ball_query_pallas(centres, xyz, 0.005, 8, interpret=True)))
    d2 = ((centres[4:, None, :] - xyz[None]) ** 2).sum(-1)
    assert (got[4:] == d2.argmin(-1)[:, None]).all()


def test_ball_query_batch_matches_vmap():
    xyzs = cloud(1024, 8, batch=3)
    centres = np.stack([_centres(p, 32) for p in xyzs])
    got = sampling.ball_query(torch.from_numpy(centres), torch.from_numpy(xyzs), 0.02, 64).numpy()
    want = jax.vmap(lambda c, p: jax_sampling.ball_query(c, p, 0.02, 64))(centres, xyzs)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_group_points_matches_jax():
    xyzs = cloud(64, 9, batch=2)
    feats = np.random.RandomState(10).randn(2, 64, 5).astype(np.float32)
    cidx = np.stack([np.asarray(jax_sampling.furthest_point_sampling(p, 8)) for p in xyzs])
    gidx = np.stack([np.asarray(jax_sampling.ball_query(p[c], p, 0.05, 16))
                     for p, c in zip(xyzs, cidx)])
    new_xyz, grouped = sampling.group_points(*map(torch.from_numpy, (xyzs, feats, cidx, gidx)))
    want_xyz, want = jax.vmap(jax_sampling.group_points)(xyzs, feats, cidx, gidx)
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(want))


def test_wrappers_check_inputs():
    xyz = torch.from_numpy(cloud(64, 11))[None]
    with pytest.raises(ValueError):
        sampling.furthest_point_sampling(xyz.double(), 8)
    with pytest.raises(ValueError):
        sampling.ball_query(xyz[:, :8], xyz[0], 0.05, 8)
    before = (sampling.furthest_point_sampling.launches, sampling.ball_query.launches)
    sampling.ball_query(xyz[:, :8], xyz, 0.05, 8)
    # CPU tensors run the plain version: no kernel launch is counted
    assert (sampling.furthest_point_sampling.launches, sampling.ball_query.launches) == before
