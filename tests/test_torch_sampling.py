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


H100_SMS = 132  # an H100 SXM's SMs, for the launch layout


def _lowbit(w):
    return (w & -w).bit_length() - 1


def _sq_dist32(c, pts):
    """float32 d2 of one centre c (3,) to pts (N, 3), each operation
    rounded on its own in the kernels' order (numpy fuses nothing)."""
    d = c[None, :] - pts
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def warp_argmin(dist):
    """A model of K2's nearest point for a centre with no hit
    (csrc/ball_query.cu): lane l visits points l, l + 32, ... taking the
    first and then only a strictly smaller distance, then a
    __shfl_xor_sync butterfly takes the other lane's pair when its value
    is smaller, or equal with a lower index."""
    n = len(dist)
    best = []
    for lane in range(32):
        b, bi = np.float32(np.inf), n
        for j in range(lane, n, 32):
            if dist[j] < b or j == lane:
                b, bi = dist[j], j
        best.append((b, bi))
    for off in (16, 8, 4, 2, 1):
        best = [(v, k) if v < b or (v == b and k < bi) else (b, bi)
                for (b, bi), (v, k) in ((best[lane], best[lane ^ off]) for lane in range(32))]
    assert len(set(best)) == 1
    return best[0][1]


def ball_query_kernel_model(centres, xyz, radius, nsample, per=None):
    """A walk of K2 (csrc/ball_query.cu) over its blocks, in numpy. A
    block takes one cloud and a group of `per` of its centres, numbered r;
    mask (r, k) has bit l set for a hit of point 32 k + l (the
    kernel makes it with a lane per centre, or by a ballot over a lane per
    point: the same word). A half warp per centre then writes its row:
    with one chunk, lane l writes points 2l and 2l + 1 to the slots their
    lower bits count; with more, lane l holds masks 2l and 2l + 1 of a
    window of 32, an exclusive scan of the popcounts over the half gives
    its first slot and it writes its set bits, mask by mask, lowest first,
    below nsample, window by window with the count carried, stopping once
    nsample hits are in. The first hit is the lowest bit of the first
    non-zero mask, a centre with no hit takes `warp_argmin`'s point, and
    slots from the count on take the first hit as the row is stored.
    `per` defaults to the wrapper's `ball_query_layout` on an H100's 132
    SMs."""
    b, s, _ = centres.shape
    n = xyz.shape[1]
    per = per or sampling.ball_query_layout(b, s, n, nsample, H100_SMS)[0]
    r2 = np.float32(sampling._radius_sq(radius))
    nchunks = -(-n // 32)
    groups = -(-s // per)
    out = np.full((b, s, nsample), -7, np.int32)
    for block in range(groups * b):
        b0, s0 = block // groups, block % groups * per
        nc = min(per, s - s0)
        pts, ctr = xyz[b0], centres[b0, s0:s0 + nc]
        for r in range(nc):
            mrow = [sum(1 << int(p) for p in np.flatnonzero(
                        _sq_dist32(ctr[r], pts[32 * k:32 * k + 32]) <= r2))
                    for k in range(nchunks)]
            count, first, row = 0, -1, {}
            if nchunks == 1:  # lane l of the half writes points 2l and 2l + 1
                w = mrow[0]
                count, first = bin(w).count("1"), _lowbit(w)
                for j in range(32):
                    slot = bin(w & ((1 << j) - 1)).count("1")
                    if (w >> j) & 1 and slot < nsample:
                        row[slot] = j
            for k0 in range(0, nchunks if nchunks > 1 else 0, 32):
                # lane l of the half holds masks k0 + 2l and k0 + 2l + 1
                pairs = [[mrow[k] if k < nchunks else 0 for k in (k0 + 2 * l, k0 + 2 * l + 1)]
                         for l in range(16)]
                pcs = [sum(bin(w).count("1") for w in pair) for pair in pairs]
                incl = np.cumsum(pcs)
                nz = [l for l in range(16) if any(pairs[l])]
                if first < 0 and nz:
                    w0, w1 = pairs[nz[0]]
                    first = (32 * (k0 + 2 * nz[0]) + _lowbit(w0) if w0
                             else 32 * (k0 + 2 * nz[0] + 1) + _lowbit(w1))
                for l in range(16):
                    slot = count + incl[l] - pcs[l]
                    for i, w in enumerate(pairs[l]):
                        while w and slot < nsample:
                            row[slot] = 32 * (k0 + 2 * l + i) + _lowbit(w)
                            slot, w = slot + 1, w & (w - 1)
                count += int(incl[15])
                if count >= nsample:
                    break
            if count == 0:
                first = warp_argmin(_sq_dist32(ctr[r], pts))
            kept = min(count, nsample)
            out[b0, s0 + r] = [row[t] if t < kept else first for t in range(nsample)]
    return out


def _bq_case(kind, seed):
    """(centres (B, S, 3), xyz (B, N, 3), radius, nsample) of one K2 case."""
    rng = np.random.RandomState(seed)
    if kind in ("SA1", "SA2"):
        n, radius, nsample = (1024, 0.02, 64) if kind == "SA1" else (32, 0.04, 128)
        xyz = cloud(n, seed, batch=2)
        return np.stack([_centres(p, 32) for p in xyz]), xyz, radius, nsample
    if kind.startswith("N="):  # partial chunks; more than 32 chunks from N = 1030 on
        n = int(kind[2:])
        xyz = cloud(n, seed, batch=2)
        # nsample 13: rows not a multiple of 4 slots; more hits than slots at N = 33
        # and 1030; 512 slots, more than the hits over 35 chunks, at N = 1100
        radius, nsample = {31: (0.05, 13), 33: (0.05, 8), 1030: (0.1, 64),
                           1100: (0.05, 512)}.get(n, (0.05, 24))
        return xyz[:, rng.randint(0, n, 13)], xyz, radius, nsample
    if kind == "far, ties":  # far centres, the nearest point repeated
        xyz = np.tile(rng.rand(1, 8, 3).astype(np.float32), (2, 9, 1))[:, :70]
        far = np.array([[3.0, 0.5, 0.5], [-2.0, 0.2, 0.0], [0.5, 0.5, 9.0]], np.float32)
        return np.concatenate([xyz[:, :4], np.broadcast_to(far, (2, 3, 3))], 1), xyz, 0.01, 16
    if kind == "grid ties":  # integer distances, some exactly at r
        xyz = rng.randint(0, 4, (2, 100, 3)).astype(np.float32)
        shift = np.float32(0.5) * (rng.rand(2, 13, 1) > 0.5)
        return (xyz[:, :13] + shift).astype(np.float32), xyz, 1.0, 8
    if kind == "r=0":  # hits only on the centre's copies
        xyz = np.tile(rng.rand(1, 8, 3).astype(np.float32), (2, 9, 1))[:, :66]
        return xyz[:, 3:16], xyz, 0.0, 12
    raise ValueError(kind)


BQ_CASES = ["SA1", "SA2", "N=1", "N=31", "N=33", "N=1030", "N=1100", "far, ties",
            "grid ties", "r=0"]


@pytest.mark.parametrize("kind", BQ_CASES)
def test_ball_query_kernel_model(kind):
    """The model of K2's walk equals ball_query_reference and the Pallas
    kernel in interpret mode on: the SA1 and SA2 shapes, N = 1, 31, 33,
    1030 (a partial last chunk) and 1100 (more than 32 chunks), far
    centres with no hit whose nearest point is repeated, integer
    distances, r = 0, and S = 13 centres (not a multiple of the block's
    8 warps)."""
    centres, xyz, radius, nsample = _bq_case(kind, BQ_CASES.index(kind) + 30)
    want = sampling.ball_query_reference(torch.from_numpy(centres), torch.from_numpy(xyz),
                                         radius, nsample).numpy()
    np.testing.assert_array_equal(ball_query_kernel_model(centres, xyz, radius, nsample), want)
    for c, p, w in zip(centres, xyz, want):
        np.testing.assert_array_equal(
            np.asarray(ball_query_pallas(c, p, radius, nsample, interpret=True)), w)


@pytest.mark.parametrize("per", [1, 4, 5, 13])
@pytest.mark.parametrize("kind", ["N=33", "far, ties"])
def test_ball_query_kernel_model_layouts(kind, per):
    """The same walk with other groups of a cloud's 13 centres a block:
    one, 4 and 5 (the last group short) and all 13."""
    centres, xyz, radius, nsample = _bq_case(kind, 50)
    centres, xyz = np.concatenate([centres] * 2), np.concatenate([xyz, xyz[::-1]])
    want = sampling.ball_query_reference(torch.from_numpy(centres), torch.from_numpy(xyz),
                                         radius, nsample).numpy()
    np.testing.assert_array_equal(
        ball_query_kernel_model(centres, xyz, radius, nsample, per), want)


def test_ball_query_layout():
    """The wrapper's launch layout on an H100's 132 SMs: every block fits
    in shared memory; the SA1 and SA2 shapes at B = 1, 256 and 1024 fit,
    with one centre a block at B=1 (32 blocks on the one cloud) and 32 at
    B=1024; fewer SMs give fuller blocks; a cloud whose staged points and
    masks exceed 227 KB raises ValueError before any launch."""
    for n, nsample in ((1024, 64), (32, 128), (1030, 64)):
        assert sampling.check_ball_query_smem(32, n, nsample) <= 232448
        for b in (1, 256, 1024):
            centres, smem = sampling.ball_query_layout(b, 32, n, nsample, H100_SMS)
            assert smem == sampling.ball_query_smem_bytes(centres, n, nsample) <= 232448
    assert sampling.ball_query_layout(1, 32, 1024, 64, H100_SMS)[0] == 1
    assert sampling.ball_query_layout(1024, 32, 1024, 64, H100_SMS)[0] == 32
    assert sampling.ball_query_layout(64, 32, 1024, 64, 16)[0] == 32
    # 16 * 1024 + 16 + 4 * 36 + 16 * 4 * 64 bytes: the points, a centre, its
    # 33 masks rounded to 16 bytes, a row per half warp
    assert sampling.ball_query_smem_bytes(1, 1024, 64) == 16384 + 16 + 144 + 4096
    assert sampling.ball_query_layout(1024, 32, 12000, 64, H100_SMS)[0] < 32  # halved
    for s, n, nsample in ((32, 20000, 64), (1, 1, 8000)):
        with pytest.raises(ValueError):
            sampling.check_ball_query_smem(s, n, nsample)
        with pytest.raises(ValueError):
            sampling.ball_query_layout(1024, s, n, nsample, H100_SMS)


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
