"""K5 (sa_train_fused) and K6 (groupall_train_fused): the port's plain
versions, and its wrappers as they run on CPU tensors, against the JAX
package's XLA functions and Pallas kernels (interpret mode), at the JAX
suite's own bounds (tests/test_pallas_sa_train.py): pooled 1e-5, mean
rtol 1e-5 / atol 1e-6, var rtol 1e-4 / atol 1e-6; gradients through the
autograd.Function against `jax.vjp` of the XLA function at rtol 2e-3 /
atol 5e-3 (Dense biases feeding a BatchNorm have an exact gradient of 0,
so both sides carry O(1e-3) cancellation noise there); a train-mode
`SetAbstraction` against the Flax module, running statistics included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.models.pointnet import SetAbstraction as JaxSetAbstraction
from gaddpg_tpu.ops import pallas_sa_train as pst
from gaddpg_tpu_torch.models.pointnet import SetAbstraction, update_running_stats
from gaddpg_tpu_torch.ops import sa_train

POOLED = dict(rtol=1e-5, atol=1e-5)
MEAN = dict(rtol=1e-5, atol=1e-6)
VAR = dict(rtol=1e-4, atol=1e-6)
GRAD = dict(rtol=2e-3, atol=5e-3)


def _inputs(seed, b=2, n=24, s=4, k=8, cin=5, dims=(6, 6, 8), kaiming=False):
    """numpy (idx, full, cpad, dense) at the JAX suite's tiny shapes; with
    `kaiming` the Dense weights have the model's kaiming-normal scale,
    sqrt(2 / fan_in), instead of 0.4 (at the model's widths a fixed 0.4
    makes |z| grow as sqrt(fan_in))."""
    rng = np.random.RandomState(seed)
    full = rng.randn(b, n, cin).astype(np.float32)
    idx = rng.randint(0, n, (b, s, k)).astype(np.int32)
    cpad = np.zeros((b, s, cin), np.float32)
    cpad[..., :3] = rng.randn(b, s, 3) * 0.1
    dense, c = [], cin
    for d in dims:
        dense.append(((rng.randn(c, d) * (np.sqrt(2.0 / c) if kaiming else 0.4)).astype(np.float32),
                      (rng.randn(d) * 0.05).astype(np.float32),
                      rng.uniform(0.8, 1.3, d).astype(np.float32),
                      (rng.randn(d) * 0.05).astype(np.float32)))
        c = d
    return idx, full, cpad, tuple(dense)


def _torch(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _torch_dense(dense, grad=False):
    return tuple(tuple(_torch(t, grad) for t in layer) for layer in dense)


def _check(got, want):
    (pooled, stats), (w_pooled, w_stats) = got, want
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(w_pooled), **POOLED)
    for (m, v), (wm, wv) in zip(stats, w_stats, strict=True):
        assert not m.requires_grad and not v.requires_grad
        np.testing.assert_allclose(m.numpy(), np.asarray(wm), **MEAN)
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), **VAR)


@pytest.mark.parametrize("group_all", [False, True])
def test_reference_matches_xla(group_all):
    idx, full, cpad, dense = _inputs(0)
    if group_all:
        got = sa_train.groupall_train_reference(_torch(full), _torch_dense(dense))
        want = pst._xla_groupall_full(full, dense)
    else:
        got = sa_train.sa_train_reference(_torch(idx), _torch(full), _torch(cpad),
                                          _torch_dense(dense))
        want = pst._xla_full(idx, full, cpad, dense)
    _check(got, want)


# input shapes of the interpret-mode comparison: small widths, and the
# model_scale 2 widths of SA2 (grouped) and SA3 (group-all) with rows
# that fill no 64-row tile (2 x 3 x 10 slots, 3 x 7 rows)
INTERPRET_SHAPES = {
    "small": (dict(b=3, n=32, s=4, k=16, cin=7, dims=(8, 8, 16)),) * 2,
    "scale2": (dict(b=2, n=24, s=3, k=10, cin=259, dims=(256, 256, 512), kaiming=True),
               dict(b=3, n=7, s=1, k=1, cin=515, dims=(512, 512, 1024), kaiming=True)),
}


@pytest.mark.parametrize("widths", list(INTERPRET_SHAPES))
@pytest.mark.parametrize("group_all", [False, True])
def test_wrapper_matches_pallas_interpret(group_all, widths):
    """The CPU wrapper (autograd.Function around the plain version)
    against the Pallas kernels in interpret mode; no launch counted."""
    idx, full, cpad, dense = _inputs(1, **INTERPRET_SHAPES[widths][group_all])
    before = (sa_train.sa_train_fused.launches, sa_train.groupall_train_fused.launches)
    if group_all:
        got = sa_train.groupall_train_fused(_torch(full), _torch_dense(dense))
        want = pst.groupall_train_fused(full, dense, True)
    else:
        got = sa_train.sa_train_fused(_torch(idx), _torch(full), _torch(cpad),
                                      _torch_dense(dense))
        want = pst.sa_train_fused(idx, full, cpad, dense, True)
    _check(got, want)
    assert (sa_train.sa_train_fused.launches,
            sa_train.groupall_train_fused.launches) == before


@pytest.mark.parametrize("group_all", [False, True])
def test_grads_match_jax_vjp(group_all):
    """Gradients of full, cpad and all 12 parameters through the
    autograd.Function, for one cotangent, against jax.vjp of the XLA
    function (the JAX custom_vjp's own backward rule)."""
    idx, full, cpad, dense = _inputs(2)
    rng = np.random.RandomState(3)
    c3 = dense[-1][0].shape[1]
    t_full, t_cpad, t_dense = _torch(full, True), _torch(cpad, True), _torch_dense(dense, True)
    if group_all:
        g = rng.randn(full.shape[0], 1, c3).astype(np.float32)
        pooled, _ = sa_train.groupall_train_fused(t_full, t_dense)
        _, vjp = jax.vjp(lambda f, d: pst._xla_groupall_full(f, d)[0], full, dense)
        w_full, w_dense = vjp(g)
        inputs, wants = [t_full], [w_full]
    else:
        g = rng.randn(*idx.shape[:2], c3).astype(np.float32)
        pooled, _ = sa_train.sa_train_fused(_torch(idx), t_full, t_cpad, t_dense)
        _, vjp = jax.vjp(lambda f, c, d: pst._xla_full(idx, f, c, d)[0], full, cpad, dense)
        w_full, w_cpad, w_dense = vjp(g)
        inputs, wants = [t_full, t_cpad], [w_full, w_cpad]
    inputs += [t for layer in t_dense for t in layer]
    wants += [t for layer in w_dense for t in layer]
    grads = torch.autograd.grad(pooled, inputs, torch.from_numpy(g))
    assert len(grads) == len(wants) == (13 if group_all else 14)
    for i, (got, want) in enumerate(zip(grads, wants)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD, err_msg=f"input {i}")


@pytest.mark.parametrize("group_all", [False, True])
def test_plain_version_gradcheck(group_all):
    """torch.autograd.gradcheck of the plain version (what the backward
    differentiates) in float64, against finite differences."""
    idx, full, cpad, dense = _inputs(4, b=2, n=10, s=2, k=5, cin=4, dims=(4, 4, 4))
    f64 = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
           for a in (full, cpad, *(t for layer in dense for t in layer))]

    def pooled(full, cpad, *params):
        d = tuple(tuple(params[4 * i: 4 * i + 4]) for i in range(3))
        if group_all:
            return sa_train.groupall_train_reference(full, d)[0]
        return sa_train.sa_train_reference(torch.from_numpy(idx), full, cpad, d)[0]

    assert torch.autograd.gradcheck(pooled, f64, eps=1e-6, atol=1e-5, rtol=1e-4)


def _perturbed_variables(sa, xyz, feats, seed):
    v = jax.tree_util.tree_map(np.asarray, sa.init(jax.random.PRNGKey(1), xyz, feats, train=True))
    rng = np.random.RandomState(seed)
    params, stats = v["params"], v["batch_stats"]
    for j in range(3):
        c = params[f"BatchNorm_{j}"]["scale"].shape[0]
        params[f"BatchNorm_{j}"] = {"scale": rng.uniform(0.8, 1.3, c).astype(np.float32),
                                    "bias": (rng.randn(c) * 0.05).astype(np.float32)}
        stats[f"BatchNorm_{j}"] = {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                                   "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("group_all", [False, True])
def test_set_abstraction_train_matches_flax(group_all, monkeypatch):
    """SetAbstraction(train=True) against the Flax module's
    apply(train=True, mutable=["batch_stats"]) on its XLA path: pooled
    output, centres and the updated running statistics."""
    monkeypatch.setenv("GADDPG_PALLAS_SA_TRAIN", "0")
    pc = (np.random.RandomState(5).randn(3, 48, 4) * 0.05).astype(np.float32)
    xyz, feats = pc[..., :3], pc
    jsa = JaxSetAbstraction(8, 0.02, 16, (8, 8, 16), group_all=group_all)
    v = _perturbed_variables(jsa, xyz, feats, seed=6)
    (w_xyz, w_out), upd = jsa.apply(v, xyz, feats, train=True, mutable=["batch_stats"])

    sa = SetAbstraction(8, 0.02, 16, 7, (8, 8, 16), group_all=group_all)
    with torch.no_grad():
        for j, (d, bn) in enumerate(zip(sa.dense, sa.norms)):
            d.weight.copy_(torch.tensor(v["params"][f"Dense_{j}"]["kernel"].T))
            d.bias.copy_(torch.tensor(v["params"][f"Dense_{j}"]["bias"]))
            bn.weight.copy_(torch.tensor(v["params"][f"BatchNorm_{j}"]["scale"]))
            bn.bias.copy_(torch.tensor(v["params"][f"BatchNorm_{j}"]["bias"]))
            bn.running_mean.copy_(torch.tensor(v["batch_stats"][f"BatchNorm_{j}"]["mean"]))
            bn.running_var.copy_(torch.tensor(v["batch_stats"][f"BatchNorm_{j}"]["var"]))
    t_pc = torch.from_numpy(pc)
    new_xyz, out, stats = sa(t_pc[..., :3], t_pc, train=True)
    update_running_stats(sa.norms, stats)
    np.testing.assert_allclose(new_xyz.numpy(), np.asarray(w_xyz), atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(w_out), rtol=1e-4, atol=1e-4)
    for j, bn in enumerate(sa.norms):
        want = upd["batch_stats"][f"BatchNorm_{j}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want["mean"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want["var"]),
                                   rtol=1e-4, atol=1e-6)


def test_wrappers_check_inputs():
    idx, full, cpad, dense = _inputs(7)
    t_dense = _torch_dense(dense)
    with pytest.raises(ValueError):
        sa_train.sa_train_fused(_torch(idx).long(), _torch(full), _torch(cpad), t_dense)
    with pytest.raises(ValueError):
        sa_train.sa_train_fused(_torch(idx), _torch(full)[..., :4], _torch(cpad), t_dense)
    with pytest.raises(ValueError):
        sa_train.groupall_train_fused(_torch(full), t_dense[:2])
    with pytest.raises(ValueError):  # BatchNorm scale of the wrong width
        bad = (t_dense[0][:2] + (t_dense[0][2][:3], t_dense[0][3]),) + t_dense[1:]
        sa_train.groupall_train_fused(_torch(full), bad)


def test_bn_affine():
    """bn(z) = z * a + c equals (z - mean) / sqrt(var + eps) * scale + bias."""
    rng = np.random.RandomState(8)
    z = torch.from_numpy(rng.randn(10, 6))
    mean, var = torch.from_numpy(rng.randn(6)), torch.from_numpy(rng.uniform(0.1, 2, 6))
    scale, bias = torch.from_numpy(rng.uniform(0.5, 1.5, 6)), torch.from_numpy(rng.randn(6))
    a, c = sa_train.bn_affine(mean, var, scale, bias)
    ref = (z - mean) / torch.sqrt(var + 1e-5) * scale + bias
    torch.testing.assert_close(z * a + c, ref, rtol=1e-12, atol=1e-12)
    ja, jc = pst._bn_affine(jnp.asarray(mean.numpy(), jnp.float32),
                            jnp.asarray(var.numpy(), jnp.float32),
                            jnp.asarray(scale.numpy(), jnp.float32),
                            jnp.asarray(bias.numpy(), jnp.float32))
    a32, c32 = sa_train.bn_affine(mean.float(), var.float(), scale.float(), bias.float())
    np.testing.assert_allclose(a32.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(c32.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
