"""K3 (sa_gather_mlp) and K4 (mlp_maxpool): the port's plain versions, as
its wrappers run them on CPU tensors, against the JAX package's Pallas
kernels in interpret mode, at the JAX suite's own bound
(tests/test_pallas_sa.py: rtol = atol = 2e-5); and BatchNorm folding of
weights carried over from a Flax tree.
"""

import jax
import numpy as np
import pytest
import torch

from gaddpg_tpu.ops import pallas_sa
from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.agents.state import from_flax
from gaddpg_tpu_torch.ops import sa

TOL = dict(rtol=2e-5, atol=2e-5)


def _weights(rng, cin, dims):
    ws, c = [], cin
    for d in dims:
        ws.append(((rng.randn(c, d) * 0.3).astype(np.float32),
                   (rng.randn(d) * 0.1).astype(np.float32)))
        c = d
    return tuple(ws)


def _torch(weights):
    return tuple((torch.from_numpy(w), torch.from_numpy(b)) for w, b in weights)


@pytest.mark.parametrize("b,n,s,k,cin,dims,seed", [
    (2, 128, 16, 32, 7, (16, 16, 32), 0),
    (1, 256, 8, 64, 7, (64, 64, 128), 1),    # SA1 widths, policy encoder
    (1, 64, 8, 64, 13, (64, 64, 128), 2),    # SA1 widths, value encoder
    (2, 16, 4, 32, 5, (8, 8, 16), 3),        # K > N: duplicate gathers
])
def test_sa_gather_mlp_matches_pallas(b, n, s, k, cin, dims, seed):
    rng = np.random.RandomState(seed)
    full = rng.randn(b, n, cin).astype(np.float32)
    idx = rng.randint(0, n, (b, s, k)).astype(np.int32)
    cpad = np.zeros((b, s, cin), np.float32)
    cpad[..., :3] = rng.randn(b, s, 3)
    weights = _weights(rng, cin, dims)
    got = sa.sa_gather_mlp(torch.from_numpy(idx), torch.from_numpy(full),
                           torch.from_numpy(cpad), _torch(weights))
    want = jax.vmap(lambda i, f, c: pallas_sa.sa_gather_mlp(i, f, c, weights, interpret=True))(
        idx, full, cpad)
    assert got.shape == (b, s, dims[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,n,cin,dims,seed", [
    (2, 64, 11, (16, 16, 24), 4),
    (2, 32, 259, (256, 256, 512), 5),        # SA3 widths
])
def test_mlp_maxpool_matches_pallas(b, n, cin, dims, seed):
    rng = np.random.RandomState(seed)
    full = rng.randn(b, n, cin).astype(np.float32)
    weights = _weights(rng, cin, dims)
    got = sa.mlp_maxpool(torch.from_numpy(full), _torch(weights))
    want = jax.vmap(lambda f: pallas_sa.mlp_maxpool(f, weights, interpret=True))(full)
    assert got.shape == (b, 1, dims[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


SA_WIDTHS = ((64, 64, 128), (128, 128, 256), (256, 256, 512))


def flax_trees(rng, cfg=AgentConfig()):
    """Random (feat_params, feat_stats, policy_params) with the Flax
    names and shapes of the JAX AgentState; BatchNorm statistics away
    from their initial values so folding is exercised."""
    def dense(cin, cout):
        return {"kernel": rng.randn(cin, cout).astype(np.float32) * 0.1,
                "bias": rng.randn(cout).astype(np.float32) * 0.1}

    def bn(c):
        return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": rng.randn(c).astype(np.float32) * 0.1},
                {"mean": rng.randn(c).astype(np.float32) * 0.2,
                 "var": rng.uniform(0.5, 2.0, c).astype(np.float32)})

    params, stats = {}, {}
    for name, cin in (("encoder", 4), ("value_encoder", 10)):
        p, st = {}, {}
        c = cin + 3
        for i, widths in enumerate(SA_WIDTHS):
            p[f"SetAbstraction_{i}"], st[f"SetAbstraction_{i}"] = {}, {}
            for j, w in enumerate(widths):
                p[f"SetAbstraction_{i}"][f"Dense_{j}"] = dense(c, w)
                (p[f"SetAbstraction_{i}"][f"BatchNorm_{j}"],
                 st[f"SetAbstraction_{i}"][f"BatchNorm_{j}"]) = bn(w)
                c = w
            c += 3
        for j, (a, w) in enumerate(((512, 1024), (1024, 512))):
            p[f"Dense_{j}"] = dense(a, w)
            p[f"BatchNorm_{j}"], st[f"BatchNorm_{j}"] = bn(w)
        params[name], stats[name] = p, st
    h = cfg.hidden_size
    policy = {f"Dense_{j}": dense(a, w) for j, (a, w) in enumerate(
        ((cfg.num_inputs, h), (h, h), (h, 6), (h, 7), (h, 6)))}
    return params, stats, policy


def test_fold_bn_on_converted_flax_weights():
    params, stats, policy = flax_trees(np.random.RandomState(6))
    state = from_flax(params, stats, policy, device="cpu")
    for name in ("encoder", "value_encoder"):
        enc = getattr(state.feat, name)
        for i, level in enumerate(enc.sa):
            with torch.no_grad():
                got = sa.folded_sa_weights(level.dense, level.norms)
            want = pallas_sa.folded_sa_weights(params[name][f"SetAbstraction_{i}"],
                                               stats[name][f"SetAbstraction_{i}"])
            for (gw, gb), (ww, wb) in zip(got, want):
                assert gw.is_contiguous()
                np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=1e-6, atol=1e-7)
                np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6, atol=1e-7)


def test_fold_bn_matches_unfused():
    """The folded Dense equals Dense then eval BatchNorm (eps 1e-5)."""
    rng = np.random.RandomState(7)
    w, b = torch.randn(6, 8, dtype=torch.float64), torch.randn(8, dtype=torch.float64)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 8))
    bias, mean = torch.randn(8, dtype=torch.float64), torch.randn(8, dtype=torch.float64) * 0.2
    var = torch.from_numpy(rng.uniform(0.5, 2.0, 8))
    x = torch.randn(10, 6, dtype=torch.float64)
    wf, bf = sa.fold_bn(w, b, scale, bias, mean, var)
    ref = ((x @ w + b) - mean) / torch.sqrt(var + 1e-5) * scale + bias
    torch.testing.assert_close(x @ wf + bf, ref, rtol=1e-12, atol=1e-12)


def test_wrappers_check_inputs():
    rng = np.random.RandomState(8)
    weights = _torch(_weights(rng, 7, (8, 8, 16)))
    full = torch.randn(1, 16, 7)
    idx = torch.zeros((1, 4, 8), dtype=torch.int32)
    cpad = torch.zeros((1, 4, 7))
    with pytest.raises(ValueError):
        sa.sa_gather_mlp(idx.long(), full, cpad, weights)
    with pytest.raises(ValueError):
        sa.sa_gather_mlp(idx, full[..., :6], cpad, weights)
    with pytest.raises(ValueError):
        sa.mlp_maxpool(full, weights[:2])
    before = (sa.sa_gather_mlp.launches, sa.mlp_maxpool.launches)
    sa.sa_gather_mlp(idx, full, cpad, weights)
    sa.mlp_maxpool(full, weights)
    assert (sa.sa_gather_mlp.launches, sa.mlp_maxpool.launches) == before
