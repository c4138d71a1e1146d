"""The distinct-slot rule behind the K3/K5 kernels (`ops.sa.distinct_slots`):
a group needs slot 0, standing for every slot equal to it, and each slot
k >= 1 whose index differs from slot 0's. Checked against a brute-force
count on ball-query groups (the JAX Pallas kernel in interpret mode, with
K > N padding and a centre without hits) and on arbitrary indices; then
the plain layers over the distinct rows alone against the full functions:
the pooled max against `sa_gather_mlp_reference` and the JAX Pallas
kernel (tests/test_torch_sa.py's 2e-5), the multiplicity-weighted batch
statistics against JAX `_xla_layer_stats` (tests/test_torch_sa_train.py's
MEAN / VAR bounds).
"""

from collections import Counter

import jax
import numpy as np
import pytest
import torch

from gaddpg_tpu.ops import pallas_kernels, pallas_sa
from gaddpg_tpu.ops import pallas_sa_train as pst
from gaddpg_tpu_torch.ops import sa

POOL_TOL = dict(rtol=2e-5, atol=2e-5)
MEAN = dict(rtol=1e-5, atol=1e-6)
VAR = dict(rtol=1e-4, atol=1e-6)


def _ball_groups(seed, b, n, s, k, radius):
    """(idx (b, s, k) int32, xyz (b, n, 3), centres (b, s, 3)) from the
    JAX ball query in interpret mode; the last centre of each cloud sits
    far from every point, so it takes the no-hit fallback."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(b, n, 3) * 0.03).astype(np.float32)
    centres = xyz[:, rng.choice(n, s, replace=False)].copy()
    centres[:, -1] = 1.0
    idx = np.stack([np.asarray(pallas_kernels.ball_query_pallas(
        centres[i], xyz[i], radius, k, interpret=True)) for i in range(b)])
    return idx.astype(np.int32), xyz, centres


def _brute_force(idx):
    """mask and multiplicity by looping over every group's slots."""
    mask = np.zeros(idx.shape, bool)
    mult = np.zeros(idx.shape, np.int32)
    for g in np.ndindex(idx.shape[:-1]):
        slots = idx[g]
        for kk, v in enumerate(slots):
            if kk == 0:
                mask[g + (0,)] = True
                mult[g + (0,)] = sum(int(u == v) for u in slots)
            elif v != slots[0]:
                mask[g + (kk,)] = True
                mult[g + (kk,)] = 1
    return mask, mult


def _check_rule(idx):
    mask, mult = sa.distinct_slots(torch.from_numpy(idx))
    want_mask, want_mult = _brute_force(idx)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(mult.numpy(), want_mult)
    # the kept slots, each counted as often as it stands for, are the slots
    for g in np.ndindex(idx.shape[:-1]):
        kept = Counter()
        for v, m in zip(idx[g][want_mask[g]], want_mult[g][want_mask[g]]):
            kept[int(v)] += int(m)
        assert kept == Counter(int(v) for v in idx[g])
    return mask, mult


@pytest.mark.parametrize("n,k,radius", [
    (64, 16, 0.03),   # SA1-like: groups part padded, part full
    (12, 32, 0.05),   # SA2-like: K > N, every group padded
])
def test_distinct_slots_on_ball_query_groups(n, k, radius):
    idx, _, _ = _ball_groups(0, b=2, n=n, s=6, k=k, radius=radius)
    mask, mult = _check_rule(idx)
    # the centre without hits gets its nearest point in every slot
    assert (idx[:, -1] == idx[:, -1, :1]).all()
    assert mask[:, -1].sum() == 2 and (mult[:, -1, 0] == k).all()
    assert mask.sum() < mask.numel()


def test_distinct_slots_on_arbitrary_indices():
    """Out-of-range indices and repeats that differ from slot 0: each such
    slot is kept and stands for itself."""
    rng = np.random.RandomState(1)
    n = 10
    idx = rng.randint(-2, n + 3, (3, 5, 16)).astype(np.int32)
    idx[0, 0] = [4, 7, 7, 4, 7, -1, -1, 4, 12, 12, 4, 4, 7, -1, 4, 4]
    idx[0, 1] = -1                       # out of range in every slot
    idx[0, 2, 0] = n + 5                 # out-of-range slot 0
    mask, mult = _check_rule(idx)
    assert mask[0, 0].tolist() == [True, True, True, False, True, True, True, False,
                                   True, True, False, False, True, True, False, False]
    assert mult[0, 0, 0] == 7 and mult[0, 1, 0] == 16 and mask[0, 1].sum() == 1


def _weights(rng, cin, dims):
    ws, c = [], cin
    for d in dims:
        ws.append(((rng.randn(c, d) * 0.3).astype(np.float32),
                   (rng.randn(d) * 0.1).astype(np.float32)))
        c = d
    return tuple(ws)


def _level_inputs(seed, b=2, n=12, s=6, k=32, cin=7):
    """K2 groups (K > N and a no-hit centre), the (B, N, C_in) table and
    the centre offsets of one grouped level."""
    idx, xyz, centres = _ball_groups(seed, b, n, s, k, 0.05)
    rng = np.random.RandomState(seed + 100)
    full = np.concatenate([xyz, rng.randn(b, n, cin - 3).astype(np.float32)], axis=-1)
    cpad = np.zeros((b, s, cin), np.float32)
    cpad[..., :3] = centres
    return idx, full, cpad


def _distinct_rows(idx, full, cpad):
    """The centred rows of the distinct slots, their group (b * s +
    centre) and their multiplicities."""
    t_idx = torch.from_numpy(idx)
    mask, mult = sa.distinct_slots(t_idx)
    b, s, k = idx.shape
    rows = torch.gather(torch.from_numpy(full), 1, t_idx.reshape(b, s * k, 1).long()
                        .expand(-1, -1, full.shape[-1])).reshape(b, s, k, -1)
    rows = rows - torch.from_numpy(cpad)[:, :, None, :]
    group = torch.arange(b * s).reshape(b, s, 1).expand(b, s, k)
    return rows[mask], group[mask], mult[mask]


def test_pooling_distinct_rows_matches_full_function():
    idx, full, cpad = _level_inputs(2)
    b, s, _ = idx.shape
    weights = _weights(np.random.RandomState(3), full.shape[-1], (16, 16, 32))
    t_weights = tuple((torch.from_numpy(w), torch.from_numpy(bb)) for w, bb in weights)
    rows, group, _ = _distinct_rows(idx, full, cpad)
    assert len(rows) < idx.size
    h = rows
    for w, bb in t_weights:
        h = torch.relu(h @ w + bb)
    pooled = torch.zeros(b * s, h.shape[-1]).scatter_reduce_(
        0, group[:, None].expand_as(h), h, "amax").reshape(b, s, -1)
    want = sa.sa_gather_mlp_reference(torch.from_numpy(idx), torch.from_numpy(full),
                                      torch.from_numpy(cpad), t_weights)
    np.testing.assert_allclose(pooled.numpy(), want.numpy(), **POOL_TOL)
    jax_want = jax.vmap(lambda i, f, c: pallas_sa.sa_gather_mlp(i, f, c, weights,
                                                                interpret=True))(idx, full, cpad)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jax_want), **POOL_TOL)


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_weighted_stats_of_distinct_rows_match_xla(layer):
    """Layer `layer`'s batch mean and E[z^2] - mean^2 over every slot, from
    the distinct rows' z and z^2 weighted by their multiplicities, with
    the earlier layers normalised by JAX's own statistics."""
    idx, full, cpad = _level_inputs(4)
    rng = np.random.RandomState(5)
    dense = _weights(rng, full.shape[-1], (16, 16, 32))
    affine = []
    for i in range(layer - 1):
        m, v = pst._xla_layer_stats(idx, full, cpad, dense, tuple(affine))
        scale = rng.uniform(0.8, 1.3, len(m)).astype(np.float32)
        bias = (rng.randn(len(m)) * 0.05).astype(np.float32)
        a = scale / np.sqrt(np.asarray(v) + 1e-5)
        affine.append((a.astype(np.float32), (bias - np.asarray(m) * a).astype(np.float32)))
    want_m, want_v = pst._xla_layer_stats(idx, full, cpad, dense, tuple(affine))
    rows, _, mult = _distinct_rows(idx, full, cpad)
    h = rows
    for (w, bb), (a, c) in zip(dense, affine):
        h = torch.relu((h @ torch.from_numpy(w) + torch.from_numpy(bb)) * torch.from_numpy(a)
                       + torch.from_numpy(c))
    w, bb = dense[layer - 1]
    z = h @ torch.from_numpy(w) + torch.from_numpy(bb)
    m = mult.float()[:, None]
    count = idx.size
    mean = (m * z).sum(dim=0) / count
    var = (m * z * z).sum(dim=0) / count - mean * mean
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_m), **MEAN)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_v), **VAR)
