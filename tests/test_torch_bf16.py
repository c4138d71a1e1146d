"""`AgentConfig(compute_dtype="bfloat16")` in the port against the JAX
package's bfloat16 path on the CPU: `select_action`, one DDPG update and
one BC update from the same carried-over state (the fixtures of
tests/test_torch_learner.py: B = 8, 96 points).

What the reference computes: its fused SA kernels take float32 weights
whatever the module's dtype (gaddpg_tpu/models/pointnet.py:83-140), so
the JAX side runs them, as on the TPU, through the Pallas kernels in
interpret mode (GADDPG_PALLAS_SA=interpret, GADDPG_PALLAS_SA_TRAIN=
interpret); bfloat16 then reaches the encoders' two FC Dense layers.
Flax's `Dense(dtype=bfloat16)` rounds the input, kernel and bias to
bfloat16, the product to bfloat16 and the bias add to bfloat16. Under
`jax.jit`, XLA's default `xla_allow_excess_precision` may keep float32
between fused ops instead, so the JAX side is compiled with excess
precision off: flax's rounding.

Bounds, per output (each action element; each metric; each parameter
group as the root-sum-square of its parameters' differences after the
update): a tenth of the JAX package's own bfloat16-against-float32 gap
on the same inputs, or, where that is finer than the reference itself
resolves, SPREAD_FACTOR times the JAX bfloat16 result's own spread over
NUDGES one-ulp nudges of the point states. A bfloat16 rounding of an FC
product lands on either side when its float32 sum moves in the last
bits, and the two packages sum in another order (the train-mode SA
outputs also carry the JAX CPU path's BatchNorm drift, ROADMAP.md
Queue 3 not fault (f)), and one such flip in the first FC product moves
the train-mode feature through the batch-statistics BatchNorm over 8
rows. Measured ratios to the gap (printed): `select_action` 0.19, the
updates' metrics up to 0.46, their parameter groups up to 0.72. The
float32 path is held at tests/test_torch_learner.py's bounds there; a
float32 master copy (parameters, BatchNorm statistics, Adam moments)
is checked after the bfloat16 updates.

Negative control: the port in float32 (a port that skipped bfloat16
altogether) goes through the same rule against the JAX bfloat16 result,
and at least one of its outputs must be refused; the test prints its
readings beside their bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.agents import bc as jax_bc
from gaddpg_tpu.agents import ddpg as jax_ddpg
from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu_torch.agents import (
    AgentConfig, make_bc_update, make_ddpg_update, make_select_action,
)
from test_torch_learner import (
    B, CFG, _groups, _jax_fresh, _leaf, _pairs, _torch_batch, make_batch, port_state,
)

GAP_SHARE = 0.1
SPREAD_FACTOR = 4.0
NUDGES = 3
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("GADDPG_PALLAS_SA", "interpret")
    monkeypatch.setenv("GADDPG_PALLAS_SA_TRAIN", "interpret")


def _nudged(ps, seed):
    """The point states with every coordinate moved by one ulp."""
    rng = np.random.RandomState(seed)
    return np.nextafter(ps, (ps + rng.choice([-1.0, 1.0], ps.shape)).astype(np.float32))


def strict_jit(make, dtype, args):
    """The JAX function `make(JaxAgentConfig)` in `dtype`, compiled for
    args with excess precision off."""
    return jax.jit(make(JaxAgentConfig(**CFG, compute_dtype=dtype))).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _jax_runs(make, args, nudge, compiled=None):
    """{"float32": out, "bfloat16": out, "nudged": [out, ...]}: the JAX
    function `make(JaxAgentConfig)` compiled strict (or `compiled`, a
    {dtype: function}) in each dtype on args, and in bfloat16 on NUDGES
    copies of args whose point states `nudge(args, seed)` moved by one
    ulp."""
    fns = compiled or {dt: strict_jit(make, dt, args) for dt in DTYPES}
    out = {dt: fns[dt](*args) for dt in DTYPES}
    out["nudged"] = [fns["bfloat16"](*nudge(args, s)) for s in range(NUDGES)]
    return jax.tree_util.tree_map(np.asarray, out)


def _rss(a, b):
    return float(np.sqrt(np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _within(label, err, gap, spread):
    """Whether err lies within GAP_SHARE x gap or SPREAD_FACTOR x spread;
    prints the reading."""
    bound = max(GAP_SHARE * gap, SPREAD_FACTOR * spread)
    print(f"{label}: port - JAX bf16 {err:.3e}, bound {bound:.3e}, JAX bf16 - f32 gap "
          f"{gap:.3e} (ratio {err / gap if gap else 0.0:.3f}), JAX one-ulp spread {spread:.3e}")
    return err <= bound


def _check(label, err, gap, spread):
    assert _within(label, err, gap, spread), label


def _refused(label, readings):
    """The negative control: at least one of the float32 port's readings
    (bools from `_within`) is refused."""
    print(f"{label}: the float32 port refused on {readings.count(False)} of {len(readings)}")
    assert not all(readings), f"{label}: the rule passes a port without bfloat16"


@pytest.fixture(scope="module")
def resumed():
    """A JAX state after one float32 update (Adam moments carried)."""
    js = _jax_fresh(CFG)
    state, _ = jax.jit(jax_ddpg.make_ddpg_update(JaxAgentConfig(**CFG)))(
        js, make_batch(10), jax.random.PRNGKey(11))
    return state


def test_select_action_bf16_matches_jax(resumed):
    ps = make_batch(40)["point_state"]
    remain = np.linspace(1.0, 20.0, B).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = _jax_runs(jax_ddpg.make_select_action, (resumed, ps, remain, key),
                     lambda a, s: (a[0], _nudged(a[1], s), *a[2:]))
    for dt in DTYPES:
        cfg = AgentConfig(**CFG, compute_dtype=dt)
        with torch.no_grad():
            got = make_select_action(cfg, device="cpu")(
                port_state(resumed, cfg), torch.from_numpy(ps), torch.from_numpy(remain))
        if dt == "float32":
            for g, w in zip(got, want["float32"]):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
            got32 = got
            continue
        control = []
        for i, name in enumerate(("action", "aux")):
            w, w32 = want["bfloat16"][i], want["float32"][i]
            spread = max(np.abs(n[i] - w).max() for n in want["nudged"])
            gap = np.abs(w - w32).max()
            assert gap > 0, name
            _check(f"select_action {name}", np.abs(got[i].numpy() - w).max(), gap, spread)
            control.append(_within(f"control: float32 select_action {name}",
                                   np.abs(got32[i].numpy() - w).max(), gap, spread))
        _refused("select_action", control)


def check_update(kind, resumed, make_jax, make_port, batch, key, compiled=None, **port_kw):
    """One update of the port in bfloat16 from the JAX state `resumed`
    against the JAX update's, by the module's rule, and the same update of
    the port in float32 through the rule as the negative control."""
    want = _jax_runs(make_jax, (resumed, batch, key), lambda a, s: (
        a[0], dict(a[1], point_state=_nudged(a[1]["point_state"], s)), a[2]), compiled)
    (after32, m32), (after, m) = want["float32"], want["bfloat16"]

    def group(tree, name, pairs):
        return np.concatenate([_leaf(_groups(tree)[name], path).ravel() for _, path, _ in pairs])

    def readings(dtype, within):
        """The port's update in `dtype` held to the rule by `within`."""
        cfg = AgentConfig(**CFG, compute_dtype=dtype)
        port = port_state(resumed, cfg)
        metrics = {k: float(v) for k, v in make_port(cfg, device="cpu")(
            port, _torch_batch(batch), **port_kw).items()}
        label = kind if dtype == "bfloat16" else f"control: float32 {kind}"
        out = [within(f"{label} {k}", abs(metrics[k] - float(m[k])), abs(float(m[k] - m32[k])),
                      max(abs(float(n[1][k] - m[k])) for n in want["nudged"])) for k in m]
        for name, pairs in _pairs(port).items():
            mine = np.concatenate([(t.detach().numpy().T if tr else t.detach().numpy()).ravel()
                                   for t, _, tr in pairs])
            ref = group(after, name, pairs)
            out.append(within(f"{label} {name}", _rss(mine, ref),
                              _rss(ref, group(after32, name, pairs)),
                              max(_rss(group(n[0], name, pairs), ref) for n in want["nudged"])))
        return port, out

    port, _ = readings("bfloat16", _check)
    # the float32 master copy
    for name, pairs in _pairs(port).items():
        assert all(t.dtype == torch.float32 for t, _, _ in pairs), name
        opt = port.opt[name]
        assert all(t.dtype == torch.float32 for t in (*opt.mu, *opt.nu)), name
    for enc in (port.feat.encoder, port.feat.value_encoder):
        assert all(bn.running_mean.dtype == torch.float32 for bn in enc.batch_norms())
    _refused(f"{kind} update", readings("float32", _within)[1])
    return port


def test_bc_update_bf16_matches_jax(resumed):
    port = check_update("bc", resumed, jax_bc.make_bc_update, make_bc_update,
                         make_batch(30), jax.random.PRNGKey(0))
    assert port.update_step == 2
