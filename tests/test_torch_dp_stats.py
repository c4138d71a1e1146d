"""Train-mode BatchNorm statistics across data-parallel ranks: K5's and
K6's plain versions (`sa_train_fused` / `groupall_train_fused` on CPU
tensors) and the FC trunk's `batch_norm_train`, on 2 gloo ranks with half
the rows each, against the same call on the whole batch in one process.

The bound is the train SA kernels' own (tests/test_pallas_sa_train.py:60):
the pooled output and the statistics within 1e-5 (rtol and atol); the
gradients of sum(output^2), each rank's input rows and the ranks' summed
parameter gradients, within 1e-4 of each leaf's largest. A Dense bias
that feeds a BatchNorm has an exact gradient of 0, so both sides are
rounding noise there: each is held within 1e-4 of its layer's largest
weight gradient instead. The negative control is per-rank BatchNorm (no
reduction): the same rule refuses it.
"""

import numpy as np
import pytest

import torch

from gaddpg_tpu_torch.ops.sa_train import groupall_train_fused, sa_train_fused
from gaddpg_tpu_torch.parallel import launch
from torch_dp_ranks import stats_ranks

WORLD = 2
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
LAUNCH_S = 120.0


def _dense_arrays(rng, cin, dims):
    params, c = [], cin
    for i, d in enumerate(dims):
        params += [(rng.randn(c, d) * np.sqrt(2.0 / c)).astype(np.float32),
                   np.full(d, 0.01 * i, np.float32),
                   (1.0 + 0.1 * rng.randn(d)).astype(np.float32),
                   (0.05 * rng.randn(d)).astype(np.float32)]
        c = d
    return params


def _inputs(kind, scale, seed=0, b=4, n=48, s=8, k=16):
    """Inputs of one level at model scale `scale` (SA1's, SA3's or the FC
    trunk's first widths), from a seeded numpy generator."""
    rng = np.random.RandomState(seed)
    if kind == "bn":
        c = 64 * scale
        return {"x": rng.randn(8 * b, c).astype(np.float32) * 2.0 + 0.5,
                "params": [(1.0 + 0.1 * rng.randn(c)).astype(np.float32),
                           (0.1 * rng.randn(c)).astype(np.float32)]}
    if kind == "sa":
        full = rng.randn(b, n, 7).astype(np.float32) * 0.05
        centres = rng.randint(0, n, (b, s))
        cpad = np.zeros((b, s, 7), np.float32)
        cpad[..., :3] = np.take_along_axis(full[..., :3], centres[..., None], 1)
        return {"group_idx": rng.randint(0, n, (b, s, k)).astype(np.int32), "full": full,
                "cpad": cpad,
                "params": _dense_arrays(rng, 7, (64 * scale, 64 * scale, 128 * scale))}
    cin = 32 * scale + 3
    return {"full": rng.randn(b, 16, cin).astype(np.float32),
            "params": _dense_arrays(rng, cin, (32 * scale, 32 * scale, 64 * scale))}


def _whole(kind, arrays):
    """The same call on the whole batch in this process."""
    from gaddpg_tpu_torch.models.pointnet import batch_norm_train

    params = [torch.from_numpy(a).requires_grad_() for a in arrays["params"]]
    if kind == "bn":
        bn = torch.nn.BatchNorm1d(params[0].shape[0])
        bn.weight, bn.bias = torch.nn.Parameter(params[0]), torch.nn.Parameter(params[1])
        params = [bn.weight, bn.bias]
        inputs = [torch.from_numpy(arrays["x"]).requires_grad_()]
        y, mean, var = batch_norm_train(bn, inputs[0])
        y = torch.relu(y)  # as the trunk runs it (torch_dp_ranks.stats_rank)
        stats = [(mean, var)]
    else:
        dense = tuple(tuple(params[4 * i: 4 * i + 4]) for i in range(3))
        inputs = [torch.from_numpy(arrays["full"]).requires_grad_()]
        if kind == "sa":
            inputs.append(torch.from_numpy(arrays["cpad"]).requires_grad_())
            y, stats = sa_train_fused(torch.from_numpy(arrays["group_idx"]), *inputs, dense)
        else:
            y, stats = groupall_train_fused(inputs[0], dense)
    grads = torch.autograd.grad((y * y).sum(), inputs + params)
    return {"out": y.detach().numpy(),
            "stats": [(a.detach().numpy(), b.detach().numpy()) for a, b in stats],
            "grads": [g.numpy() for g in grads]}


def _off(kind, ranks, whole):
    """Failures of the rule, as messages (empty when the ranks pass)."""
    bad = []

    def close(name, got, want, **tol):
        try:
            np.testing.assert_allclose(got, want, **tol)
        except AssertionError as e:
            bad.append(f"{name}: {str(e).splitlines()[3:5]}")

    close("out", np.concatenate([r["out"] for r in ranks]), whole["out"], **TOL)
    for r in ranks:
        for i, ((m, v), (wm, wv)) in enumerate(zip(r["stats"], whole["stats"])):
            close(f"mean {i}", m, wm, **TOL)
            close(f"var {i}", v, wv, **TOL)
    n_in = {"sa": 2, "groupall": 1, "bn": 1}[kind]
    for i, want in enumerate(whole["grads"]):
        parts = [r["grads"][i] for r in ranks]
        # input rows are each rank's own; parameter gradients are shares
        got = np.concatenate(parts) if i < n_in else np.sum(parts, axis=0)
        p = i - n_in
        if kind != "bn" and p % 4 == 1:  # a BatchNorm-fed Dense bias: exactly 0
            scale = float(np.abs(whole["grads"][i - 1]).max())
            if max(np.abs(got).max(), np.abs(want).max()) > GRAD_REL * scale:
                bad.append(f"grad {i}: a BatchNorm-fed bias off 0")
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        if np.abs(got - want).max() > GRAD_REL * scale:
            bad.append(f"grad {i}: {np.abs(got - want).max() / scale:.2e} of its largest")
    return bad


KINDS = ("sa", "groupall", "bn")
# (kind, model scale, reduced across the ranks): every case of this file,
# run in one launch of the ranks
CASES = [(k, scale, True) for k in KINDS for scale in (1, 2)] + [(k, 1, False) for k in KINDS]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """case -> the ranks' results, from one launch of 2 ranks."""
    cases = [(kind, _inputs(kind, scale), reduce) for kind, scale, reduce in CASES]
    per_rank = launch(stats_ranks, WORLD, args=(cases,), devices=["cpu"] * WORLD,
                      rendezvous_dir=tmp_path_factory.mktemp("rdv"), timeout_s=LAUNCH_S)
    return {case: [r[i] for r in per_rank] for i, case in enumerate(CASES)}


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_statistics_reduced_across_ranks(kind, scale, ranks):
    """Half the rows on each of 2 ranks == the whole batch in one call:
    output, statistics, gradients (forward and the backward's recompute
    through the global statistics)."""
    bad = _off(kind, ranks[kind, scale, True], _whole(kind, _inputs(kind, scale)))
    assert not bad, bad


@pytest.mark.parametrize("kind", KINDS)
def test_per_rank_batchnorm_is_refused(kind, ranks):
    """The negative control: each rank normalising with its own rows'
    statistics is a different model, and the rule above refuses it."""
    bad = _off(kind, ranks[kind, 1, False], _whole(kind, _inputs(kind, 1)))
    assert any(b.startswith(("mean", "var")) for b in bad), bad
