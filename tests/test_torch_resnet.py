"""The ResNet-18 image encoder (gaddpg_tpu_torch/models/resnet.py) against
the JAX package's Flax modules (gaddpg_tpu/models/resnet.py) on the same
numpy inputs and weights: the eval and train forward, the running
statistics after a train call, the gradients of one loss, ImageFeature's
two paths, and the torchvision-layout state dict in both directions.

Bounds. Eval mode is a chain of float32 convolutions: the two sides agree
to a few ulps of the output (2.1e-6 on outputs up to 4.4, measured).
Train mode normalises by the batch's statistics with Flax's fast
variance E[x^2] - mean^2; at 32 x 32 inputs the last stage is 1 x 1, so
its BatchNorms see B = 4 values a channel, and the cancellation there
amplifies float32 rounding: against a float64 evaluation of the same
network the port's and the JAX package's train gradients each lie 2e-4
to 5e-4 of a leaf's largest away (on one of three seeds both 0.31 away,
while agreeing with each other to 1.9e-4), so the train gradients are
held to 1e-3 of each leaf's largest and the eval gradients to 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.models import resnet as jax_resnet
from gaddpg_tpu_torch.agents.state import CONV, _encoder_pairs, _encoder_stat_pairs
from gaddpg_tpu_torch.models import ImageFeature, resnet
from test_image_mode import _synthetic_resnet18_sd
from torch_image_common import S, np_tree, random_resnet, resnet_variables

B = 4
EVAL = dict(rtol=1e-5, atol=1e-5)      # [2.1e-6 on outputs up to 4.4]
TRAIN = dict(rtol=2e-3, atol=2e-3)     # [4.3e-4 on outputs up to 5.1]
STATS = dict(rtol=1e-4, atol=1e-5)     # [1.3e-6]
GRAD = {False: 1e-4, True: 1e-3}       # of each leaf's largest [1.0e-6; 3.0e-4]


def _leaf(tree, path):
    return np.asarray(functools.reduce(lambda a, k: a[k], path, tree))


def _port_layout(value, layout):
    return value.transpose(3, 2, 0, 1) if layout == CONV else value


@pytest.fixture(scope="module")
def net():
    """(port ResNet18Feature, its Flax variables, an input batch)."""
    enc = random_resnet(0)
    x = np.random.RandomState(1).uniform(0, 1, (B, 5, S, S)).astype(np.float32)
    return enc, resnet_variables(enc), x


@functools.lru_cache(maxsize=None)
def _jax_forward(train):
    model = jax_resnet.ResNet18Feature()
    if train:
        return jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_forward_matches_flax(net, train):
    enc, variables, x = net
    want = _jax_forward(train)(variables, x)
    got = enc(torch.from_numpy(x), train)
    if train:
        (want, _), (got, stats) = want, got
        assert len(stats) == len(enc.batch_norms()) == 20
    assert got.shape == (B, 512)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(TRAIN if train else EVAL))


def test_running_stats_after_train_match_flax(net):
    """The running statistics after one train call: Flax's momentum 0.9
    on the old value and the biased batch variance (torch's BatchNorm2d
    would fold in the unbiased one)."""
    enc, variables, x = net
    _, mut = _jax_forward(True)(variables, x)
    enc = resnet.ResNet18Feature()
    enc.load_state_dict(net[0].state_dict())
    _, stats = enc(torch.from_numpy(x), train=True)
    enc.update_running_stats(stats)
    for t, path, _ in _encoder_stat_pairs(enc):
        np.testing.assert_allclose(t.numpy(), _leaf(mut["batch_stats"], path), **STATS,
                                   err_msg=str(path))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_gradients_match_jax(net, train):
    """d/dparams of sum(feature * r) for a fixed random r, every leaf
    within GRAD[train] of its largest JAX gradient."""
    enc, variables, x = net
    r = np.random.RandomState(2).randn(B, 512).astype(np.float32)
    model = jax_resnet.ResNet18Feature()

    def loss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        out = (model.apply(v, x, train=True, mutable=["batch_stats"])[0] if train
               else model.apply(v, x, train=False))
        return jnp.sum(out * r)

    want = jax.jit(jax.grad(loss))(variables["params"])
    pairs = _encoder_pairs(enc)
    out = enc(torch.from_numpy(x), train)
    out = out[0] if train else out
    got = torch.autograd.grad((out * torch.from_numpy(r)).sum(), [t for t, _, _ in pairs])
    assert len(pairs) == 60  # 20 convolutions, 20 BatchNorm scales and biases
    for g, (_, path, layout) in zip(got, pairs):
        w = _port_layout(_leaf(want, path), layout)
        scale = np.abs(w).max()
        assert scale > 0, path
        assert np.abs(g.numpy() - w).max() <= GRAD[train] * scale, path


def test_image_feature_matches_jax():
    """ImageFeature on encoders of its own: the policy path in eval mode
    and the value path, with the action appended, in train mode (the two
    modes of each path are ResNet18Feature's, held above)."""
    feat = ImageFeature()
    feat.encoder, feat.value_encoder = random_resnet(3), random_resnet(4)
    variables = {k: {n: resnet_variables(getattr(feat, n))[k] for n in ("encoder", "value_encoder")}
                 for k in ("params", "batch_stats")}
    rng = np.random.RandomState(5)
    x = rng.uniform(0, 1, (B, 5, S, S)).astype(np.float32)
    action = rng.uniform(-0.1, 0.1, (B, 6)).astype(np.float32)
    model = jax_resnet.ImageFeature()

    def both(v, x, a):
        return (model.apply(v, x, train=False),
                model.apply(v, x, action=a, value=True, train=True, mutable=["batch_stats"])[0])

    want_p, want_v = jax.jit(both)(variables, x, action)
    got_p = feat(torch.from_numpy(x))
    got_v, stats = feat(torch.from_numpy(x), torch.from_numpy(action), value=True, train=True)
    assert got_p.shape == (B, 512) and got_v.shape == (B, 518) and len(stats) == 20
    np.testing.assert_array_equal(got_v[:, 512:].detach().numpy(), action)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p), **EVAL)
    np.testing.assert_allclose(got_v.detach().numpy(), np.asarray(want_v), **TRAIN)


def test_jax_export_loads_into_the_port(net):
    """JAX `export_torch_state` -> the port's `load_torch_state`: every
    tensor equal to the Flax leaf it came from, bit for bit."""
    _, variables, _ = net
    sd = jax_resnet.export_torch_state(variables)
    assert sd["conv1.weight"].shape == (64, 5, 7, 7)
    enc = resnet.load_torch_state(resnet.ResNet18Feature(), sd)
    for t, path, layout in _encoder_pairs(enc) + _encoder_stat_pairs(enc):
        tree = variables["params" if path[-1] in ("kernel", "scale", "bias") else "batch_stats"]
        np.testing.assert_array_equal(t.detach().numpy(),
                                      _port_layout(_leaf(tree, path), layout), err_msg=str(path))


def test_port_export_loads_into_jax(net):
    """The port's `export_torch_state` -> JAX `load_torch_state`: the key
    set of the JAX export, and every Flax leaf equal to the port's
    tensor, bit for bit."""
    enc, variables, _ = net
    sd = resnet.export_torch_state(enc)
    assert set(sd) == set(jax_resnet.export_torch_state(variables))
    back = np_tree(jax_resnet.load_torch_state(variables, sd))
    for t, path, layout in _encoder_pairs(enc) + _encoder_stat_pairs(enc):
        tree = back["params" if path[-1] in ("kernel", "scale", "bias") else "batch_stats"]
        np.testing.assert_array_equal(_port_layout(_leaf(tree, path), layout),
                                      t.detach().numpy(), err_msg=str(path))


def test_conv1_zero_extended_from_a_torchvision_dict(net):
    """A 3-channel torchvision resnet18 dict (with its fc head): conv1's
    first 3 input channels are the file's, the other 2 zero, the fc head
    ignored, and every tensor as JAX `load_torch_state` loads it."""
    _, variables, _ = net
    sd = _synthetic_resnet18_sd(seed=6)
    enc = resnet.load_torch_state(resnet.ResNet18Feature(), sd)
    w = enc.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(w[:, :3], sd["conv1.weight"])
    assert np.all(w[:, 3:] == 0.0)
    want = np_tree(jax_resnet.load_torch_state(variables, sd))
    for t, path, layout in _encoder_pairs(enc) + _encoder_stat_pairs(enc):
        tree = want["params" if path[-1] in ("kernel", "scale", "bias") else "batch_stats"]
        np.testing.assert_array_equal(t.detach().numpy(),
                                      _port_layout(_leaf(tree, path), layout), err_msg=str(path))
    with pytest.raises(ValueError, match="not a resnet18 state dict"):
        resnet.load_torch_state(resnet.ResNet18Feature(),
                                {k: v for k, v in sd.items() if not k.startswith("layer4")})
