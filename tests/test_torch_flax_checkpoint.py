"""The JAX package's checkpoints read by the port: `gaddpg_tpu.train.
checkpoints.save_agent` writes `agent_latest.msgpack` (flax
`serialization.to_bytes` of a JAX AgentState) for a point-cloud agent and
an image agent, each with its GoalFeature, its targets, every optimizer's
Adam state and an update step, and the port's `load_agent` reads it
through `train.flax_msgpack` and `from_flax`.

The JAX states hold the port's weights of a seeded state, every tensor
then moved by seeded noise (so that no leaf is a trivial 0 or 1), and
Adam states as a few steps leave them (random moments, count 3): no JAX
module is traced, so the file takes seconds. Every tensor of the loaded
state equals `from_flax` of the same JAX trees bit for bit, and the
seeded port state it came from (float32 through msgpack is exact);
`select_action` gives the same actions bit for bit. The decoder's own
rules (flax's chunked arrays, bfloat16, truncation) are held against
flax's `msgpack_restore`.
"""

import flax
import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu.agents.state import AgentState as JaxAgentState
from gaddpg_tpu.agents.state import make_optimizers
from gaddpg_tpu.train import checkpoints as jax_checkpoints
from gaddpg_tpu_torch.agents import AgentConfig, create_agent_state, from_flax, make_select_action
from gaddpg_tpu_torch.agents.state import (
    _critic_pairs, _encoder_pairs, _encoder_stat_pairs, _goal_pairs, _goal_stat_pairs,
    _policy_pairs, state_counts, state_tensors,
)
from gaddpg_tpu_torch.train import flax_msgpack
from gaddpg_tpu_torch.train.checkpoints import flax_state_kwargs, load_agent, save_agent
from torch_image_common import S, flax_tree

NPOINTS = 70
CASES = {"points": dict(), "image": dict(use_image=True, image_size=S)}


def _perturbed_state(kw, seed):
    """A port state from `seed` with every floating tensor that a
    checkpoint holds moved by seeded noise, running variances kept
    positive."""
    state = create_agent_state(AgentConfig(**kw), npoints=NPOINTS,
                               generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in (state.feat, state.policy, state.critic, state.policy_target,
                  state.critic_target, state.goal):
            for name, t in m.state_dict().items():  # fixed buffers are not saved
                if not t.is_floating_point():
                    continue
                noise = torch.from_numpy(rng.randn(*t.shape).astype(np.float32))
                t.add_(noise.abs() if name.endswith("running_var") else 0.05 * noise)
    return state


def _adam_like(opt_state, rng):
    """The optax state with its ScaleByAdamState holding random moments
    (nu positive) and count 3, as a few steps leave it."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731

    def fill(node):
        if not is_adam(node):
            return node
        rand = lambda p: rng.randn(*np.shape(p)).astype(np.float32)  # noqa: E731
        return node._replace(count=np.asarray(3, np.int32),
                             mu=jax.tree_util.tree_map(lambda p: 0.01 * rand(p), node.mu),
                             nu=jax.tree_util.tree_map(lambda p: 1e-4 * np.abs(rand(p)), node.nu))

    return jax.tree_util.tree_map(fill, opt_state, is_leaf=is_adam)


def _jax_state(port, kw, seed):
    """A JAX AgentState holding `port`'s tensors, with Adam states from
    `_adam_like` and update_step 5."""
    jcfg = JaxAgentConfig(**kw)
    txs = make_optimizers(jcfg)
    rng = np.random.RandomState(seed)
    enc = {k: {n: flax_tree(pairs(getattr(port.feat, n))) for n in ("encoder", "value_encoder")}
           for k, pairs in (("params", _encoder_pairs), ("stats", _encoder_stat_pairs))}
    policy, critic = flax_tree(_policy_pairs(port.policy)), flax_tree(_critic_pairs(port.critic))
    goal = flax_tree(_goal_pairs(port.goal))

    def opt(name, params):
        return _adam_like(txs[name].init(params), rng)

    return JaxAgentState(
        feat_params=flax.core.freeze(enc["params"]), feat_stats=flax.core.freeze(enc["stats"]),
        policy_params=policy, critic_params=critic,
        goal_params=goal, goal_stats=flax_tree(_goal_stat_pairs(port.goal)),
        policy_target=flax_tree(_policy_pairs(port.policy_target)),
        critic_target=flax_tree(_critic_pairs(port.critic_target)),
        policy_opt=opt("policy", policy), critic_opt=opt("critic", critic),
        feat_opt={n: opt(n, enc["params"][n]) for n in ("encoder", "value_encoder")},
        goal_opt=opt("goal", goal), update_step=np.asarray(5, np.int32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _adam(opt_state):
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(s)]
    return {"mu": _np(adam.mu), "nu": _np(adam.nu), "count": int(adam.count)}


@pytest.fixture(scope="module", params=list(CASES))
def written(request, tmp_path_factory):
    """(case, the port state the JAX state holds, the JAX state, the
    directory its save_agent wrote to)."""
    kw = CASES[request.param]
    port = _perturbed_state(kw, seed=3)
    js = _jax_state(port, kw, seed=4)
    out = tmp_path_factory.mktemp(request.param)
    jax_checkpoints.save_agent(js, str(out))
    return request.param, port, js, out


def _equal_states(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i
    assert state_counts(a) == state_counts(b)


def test_load_agent_reads_the_jax_checkpoint(written):
    """Every tensor and count bit-identical to `from_flax` of the same JAX
    trees and to the port state they hold; update_step and the Adam
    counts kept."""
    case, port, js, out = written
    cfg = AgentConfig(**CASES[case])
    template = create_agent_state(cfg, npoints=NPOINTS, device="cpu")
    loaded = load_agent(template, str(out))
    want = from_flax(_np(js.feat_params), _np(js.feat_stats), _np(js.policy_params), cfg,
                     device="cpu", critic_params=_np(js.critic_params),
                     policy_target=_np(js.policy_target), critic_target=_np(js.critic_target),
                     policy_opt=_adam(js.policy_opt), critic_opt=_adam(js.critic_opt),
                     encoder_opt=_adam(js.feat_opt["encoder"]),
                     value_encoder_opt=_adam(js.feat_opt["value_encoder"]),
                     update_step=int(js.update_step), goal_params=_np(js.goal_params),
                     goal_stats=_np(js.goal_stats), goal_opt=_adam(js.goal_opt))
    _equal_states(loaded, want)
    assert loaded.update_step == 5 and state_counts(loaded) == [5] + [3] * 5
    for name in ("feat", "policy", "critic", "policy_target", "critic_target", "goal"):
        mine, theirs = getattr(loaded, name).state_dict(), getattr(port, name).state_dict()
        assert all(torch.equal(mine[k], theirs[k]) for k in theirs), name
    assert type(loaded.feat).__name__ == ("ImageFeature" if case == "image" else "PointNetFeature")


def test_select_action_after_load(written):
    """The loaded agent acts as the state it came from, bit for bit."""
    case, port, _, out = written
    cfg = AgentConfig(**CASES[case])
    loaded = load_agent(create_agent_state(cfg, npoints=NPOINTS, device="cpu"), str(out))
    rng = np.random.RandomState(5)
    shape = (3, 5, S, S) if case == "image" else (3, 4, NPOINTS)
    obs = torch.from_numpy(rng.rand(*shape).astype(np.float32) * 0.2)
    t = torch.tensor([3.0, 7.0, 12.0])
    select = make_select_action(cfg, device="cpu")
    got, got_aux = select(loaded, obs, t)
    want, want_aux = select(port, obs, t)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want) and torch.equal(got_aux, want_aux)


def test_pt_and_msgpack_side_by_side_raise(written, tmp_path):
    """Both snapshots in one directory: load_agent names both and reads neither."""
    case, port, _, out = written
    d = tmp_path / "both"
    d.mkdir()
    (d / "agent_latest.msgpack").write_bytes((out / "agent_latest.msgpack").read_bytes())
    save_agent(port, str(d))
    with pytest.raises(ValueError, match=r"agent_latest\.pt.*agent_latest\.msgpack"):
        load_agent(port, str(d))


@pytest.mark.parametrize("cut", [1, 0.5, -1])
def test_truncated_checkpoint_raises(written, tmp_path, cut):
    """A file cut after its first byte, halfway or one byte short of its
    end raises ValueError."""
    _, port, _, out = written
    data = (out / "agent_latest.msgpack").read_bytes()
    n = {1: 1, 0.5: len(data) // 2, -1: len(data) - 1}[cut]
    (tmp_path / "agent_latest.msgpack").write_bytes(data[:n])
    with pytest.raises(ValueError):
        load_agent(port, str(tmp_path))


def test_decoder_matches_flax_restore():
    """flax_msgpack.loads against flax's msgpack_restore on a tree with every
    kind flax writes: nested maps and tuples, None, bools, ints of every
    width, floats, strings, bytes, ndarrays (0-d, empty, int64, bfloat16),
    numpy scalars, and a leaf chunked as flax chunks leaves over 2^30
    bytes (the limit lowered here); a trailing byte, an unknown type byte
    and an unknown extension raise ValueError."""
    rng = np.random.RandomState(6)
    tree = {"w": rng.randn(3, 4).astype(np.float32), "t": (1, -5, 2**40, -(2**33), 70000),
            "misc": [None, True, False, 3.25, "x" * 40, b"\x01" * 300],
            "bf": jax.numpy.asarray(rng.randn(5), jax.numpy.bfloat16),
            "scalars": {"a": np.float32(1.5), "b": np.int32(-7), "c": np.asarray(9, np.int32)},
            "empty": np.zeros((0, 3), np.int64), "wide": {str(i): i for i in range(20)}}
    data = serialization.to_bytes(tree)
    old = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 64
    try:
        chunked = serialization.msgpack_serialize({"big": rng.randn(10, 10).astype(np.float32)})
    finally:
        serialization.MAX_CHUNK_SIZE = old
    assert b"__msgpack_chunked_array__" in chunked

    def same(got, want, path=""):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                same(got[k], want[k], f"{path}/{k}")
        elif isinstance(want, list):
            assert len(got) == len(want), path
            for i, (g, w) in enumerate(zip(got, want)):
                same(g, w, f"{path}/{i}")
        elif isinstance(want, (np.ndarray, np.generic)):
            w = np.asarray(want)
            if w.dtype.name == "bfloat16":
                w = w.astype(np.float32)
            assert np.shape(got) == w.shape and np.asarray(got).dtype == w.dtype, path
            np.testing.assert_array_equal(got, w, err_msg=path)
        else:
            assert type(got) is type(want) and got == want, path

    same(flax_msgpack.loads(data), serialization.msgpack_restore(data))
    same(flax_msgpack.loads(chunked), serialization.msgpack_restore(chunked))
    for bad in (data + b"\x00", b"\xc1", b"\xd4\x05\x00"):
        with pytest.raises(ValueError):
            flax_msgpack.loads(bad)


def test_missing_fields_raise():
    """A msgpack file that is not a JAX AgentState is refused by name."""
    with pytest.raises(ValueError, match="not a JAX AgentState"):
        flax_state_kwargs({"feat_params": {}})
