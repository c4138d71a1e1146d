"""The learner slice: QNetwork, the losses, the optimizers, the train-mode
PointNet++ feature, and one DDPG and one BC update, each held against the
JAX package on the same numpy inputs (CPU tensors, so the kernels' plain
versions run in the port; the JAX update takes its XLA path on the CPU).

An update is compared from the same JAX state carried over with
`from_flax`, on the same batch, with JAX's target-smoothing draws
injected. The config turns on the Q2 hard copy (target_update_interval=1)
and both collision terms. Float32 rounding, not the algorithm, sets the
bounds: in a batch-statistics BatchNorm, E[z^2] - mean^2 over thousands
of rows cancels, and the JAX CPU path's sums drift more than the port's
(measured against float64 below). Each bound carries its measured reason
where it is set.
"""

import copy
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaddpg_tpu.agents import bc as jax_bc
from gaddpg_tpu.agents import ddpg as jax_ddpg
from gaddpg_tpu.agents import losses as jax_losses
from gaddpg_tpu.agents import state as jax_agent_state
from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu.agents.state import AgentState as JaxAgentState
from gaddpg_tpu.agents.state import make_optimizers as jax_make_optimizers
from gaddpg_tpu.models.heads import QNetwork as JaxQNetwork
from gaddpg_tpu.models.pointnet import PointNetFeature as JaxPointNetFeature
from gaddpg_tpu_torch.agents import (
    AgentConfig, create_agent_state, from_flax, make_bc_update, make_ddpg_update, mix_ratios,
)
from gaddpg_tpu_torch.agents import losses
from gaddpg_tpu_torch.agents.optim import AdamW
from gaddpg_tpu_torch.agents.state import (
    CONV, _critic_pairs, _encoder_pairs, _encoder_stat_pairs, _pairs, _policy_pairs,
)
from gaddpg_tpu_torch.geometry.gripper import HAND_FINGER_POINTS
from gaddpg_tpu_torch.models import QNetwork
from gaddpg_tpu_torch.models import pointnet as port_pointnet
from gaddpg_tpu_torch.ops import sa_train, sampling

NPOINTS = 96  # 6 hand anchors + 90 cloud points
B = 8
CFG = dict(target_update_interval=1, collision_aux_weight=0.1, collision_demo_discount=0.5)
# model_scale 2: every SA and FC width doubled, a 1024-wide feature
SCALE2 = dict(CFG, feature_dim=1024)
# Train-mode feature: the JAX CPU path's SA1 output is 8.3e-5 off a
# float64 evaluation, the port's 2.4e-6; the trunk's BatchNorms amplify
# that to at most 9.3e-4 at the feature.
FEATURE = dict(rtol=2e-3, atol=2e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _adam(opt_state):
    """{"mu", "nu", "count"} of the ScaleByAdamState inside an optax state."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(s)]
    return {"mu": _np(adam.mu), "nu": _np(adam.nu), "count": int(adam.count)}


def port_state(js, cfg):
    return from_flax(
        _np(js.feat_params), _np(js.feat_stats), _np(js.policy_params), cfg, device="cpu",
        critic_params=_np(js.critic_params), policy_target=_np(js.policy_target),
        critic_target=_np(js.critic_target), policy_opt=_adam(js.policy_opt),
        critic_opt=_adam(js.critic_opt), encoder_opt=_adam(js.feat_opt["encoder"]),
        value_encoder_opt=_adam(js.feat_opt["value_encoder"]),
        update_step=int(js.update_step))


def make_batch(seed):
    """A batch with every mask live: expert and non-expert rows,
    perturbed and terminal rows, non-zero rewards, one positive
    collide_future on an expert row; clouds of different sizes and
    places so that the FC trunk's BatchNorm sees real variance."""
    rng = np.random.RandomState(seed)
    ps = np.zeros((B, 4, NPOINTS), np.float32)
    ps[:, :3, :6] = HAND_FINGER_POINTS
    ps[:, 3, :6] = 1.0
    n = NPOINTS - 6
    dirs = rng.randn(B, n, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = rng.uniform(0.01, 0.05, (B, 1, 3))
    centre = rng.uniform(-0.03, 0.03, (B, 1, 3))
    ps[:, :3, 6:] = (dirs * radii + centre).transpose(0, 2, 1)
    quat = rng.randn(B, 4)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    goal = np.concatenate([quat, rng.randn(B, 3) * 0.05], axis=-1)
    high = np.array([0.06] * 3 + [np.pi / 6] * 3)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "point_state": ps,
        "next_point_state": f32(ps + rng.randn(*ps.shape) * 0.002 * (np.arange(4) < 3)[:, None]),
        "action": f32(rng.uniform(-1, 1, (B, 6)) * high),
        "expert_action": f32(rng.uniform(-1, 1, (B, 6)) * high),
        "reward": f32([0, 1, 0, 0, 1, 0, 0.5, 0]),
        "return": f32([1, 1, 0, 1, 0, 1, 1, 0]),
        "terminal": f32([0, 0, 0, 1, 0, 0, 1, 0]),
        "time": f32(rng.uniform(1, 20, B)),
        "goal": f32(goal),
        "next_goal": f32(goal),
        "expert_flags": f32([1, 1, 0, 1, 0, 0, 1, 0]),
        "perturb_flags": f32([0, 0, 0, 0, 1, 0, 0, 1]),
        "collide_future": f32([0, 1, 0, 0, 0, 0, 0, 0]),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flax_tree(pairs):
    """Nested numpy dict in the Flax layout from (tensor, path, transposed)."""
    out = {}
    for t, path, transpose in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        v = t.detach().numpy()
        node[path[-1]] = jnp.asarray(v.T if transpose else v)
    return out


def _jax_fresh(cfg_kw):
    """A fresh JAX AgentState with the port's initial weights (plain-dict
    trees, as the jitted update returns them, so that one compile serves
    every state)."""
    cfg = AgentConfig(**cfg_kw)
    port = create_agent_state(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    feat_params = {n: _flax_tree(_encoder_pairs(getattr(port.feat, n)))
                   for n in ("encoder", "value_encoder")}
    feat_stats = {n: _flax_tree(_encoder_stat_pairs(getattr(port.feat, n)))
                  for n in ("encoder", "value_encoder")}
    policy, critic = _flax_tree(_policy_pairs(port.policy)), _flax_tree(_critic_pairs(port.critic))
    txs = jax_make_optimizers(JaxAgentConfig(**cfg_kw))
    return JaxAgentState(
        feat_params=feat_params, feat_stats=feat_stats, policy_params=policy,
        critic_params=critic, goal_params=None, goal_stats=None,
        policy_target=jax.tree_util.tree_map(jnp.copy, policy),
        critic_target=jax.tree_util.tree_map(jnp.copy, critic),
        policy_opt=txs["policy"].init(policy), critic_opt=txs["critic"].init(critic),
        feat_opt={n: txs[n].init(feat_params[n]) for n in ("encoder", "value_encoder")},
        goal_opt=None, update_step=jnp.asarray(0, jnp.int32))


@pytest.fixture(scope="module")
def jax_fresh():
    return _jax_fresh(CFG)


@pytest.fixture(scope="module")
def jax_fresh_scale2():
    return _jax_fresh(SCALE2)


@pytest.fixture(scope="module")
def jax_ddpg_update():
    return jax.jit(jax_ddpg.make_ddpg_update(JaxAgentConfig(**CFG)))


@pytest.fixture(scope="module")
def jax_scale2(jax_fresh_scale2):
    """(jitted JAX DDPG update, state after one update) of a model_scale 2
    agent. The JAX package's `make_modules` builds PointNetFeature at its
    default scale 1; the update is built with the module's own `scale=2`
    in its place."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_agent_state, "PointNetFeature",
                   functools.partial(JaxPointNetFeature, scale=2))
        update = jax.jit(jax_ddpg.make_ddpg_update(JaxAgentConfig(**SCALE2)))
    state, _ = update(jax_fresh_scale2, make_batch(10), jax.random.PRNGKey(11))
    return update, state


@pytest.fixture(scope="module")
def jax_resumed(jax_fresh, jax_ddpg_update):
    """After one JAX update: Adam moments and counts non-zero, update_step 1."""
    state, _ = jax_ddpg_update(jax_fresh, make_batch(10), jax.random.PRNGKey(11))
    return state


# -- heads and losses -------------------------------------------------------------

def test_qnetwork_matches_jax():
    x = np.random.RandomState(0).randn(5, 513).astype(np.float32)
    params = _np(JaxQNetwork().init(jax.random.PRNGKey(0), x)["params"])
    want = JaxQNetwork().apply({"params": params}, x)
    q = QNetwork()
    with torch.no_grad():
        for t, path, transpose in _critic_pairs(q):
            v = torch.tensor(_leaf(params, path))
            t.copy_(v.t() if transpose else v)
        got = q(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # the aux quaternion is unit length
    np.testing.assert_allclose(np.linalg.norm(got[2].numpy()[:, :4], axis=-1), 1.0, rtol=1e-5)


def _loss_case(name, rng):
    """(port fn, JAX fn, differentiable numpy input, other numpy args)."""
    b = 6
    if name in ("goal", "goal_empty_mask"):
        q = rng.randn(b, 4)
        pred = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True),
                               rng.randn(b, 3) * 0.05], -1)
        goal = np.concatenate([np.tile([1.0, 0, 0, 0], (b, 1)), rng.randn(b, 3) * 0.05], -1)
        mask = np.zeros(b, bool) if name == "goal_empty_mask" else rng.rand(b) > 0.4
        return losses.goal_pred_loss, jax_losses.goal_pred_loss, pred, (goal, mask)
    if name == "pose_bc":
        high = np.array([0.06] * 3 + [np.pi / 6] * 3)
        return (losses.pose_bc_loss, jax_losses.pose_bc_loss, rng.uniform(-1, 1, (b, 6)) * high,
                (rng.uniform(-1, 1, (b, 6)) * high, rng.uniform(0, 1, b)))
    if name.startswith("collision"):
        target = np.zeros(b) if name == "collision_no_positive" else (rng.rand(b) > 0.5) * 1.0
        logit = rng.randn(b) * 6  # some past the +-8 clip
        return losses.collision_bce, jax_losses.collision_bce, logit, (target,)
    return (losses.smooth_l1, jax_losses.smooth_l1, rng.randn(b) * 1.5,
            (rng.randn(b) * 0.5, rng.rand(b) > 0.3))


@pytest.mark.parametrize("name", ["goal", "goal_empty_mask", "pose_bc", "collision",
                                  "collision_no_positive", "smooth_l1"])
def test_losses_match_jax(name):
    """Value and gradient of each loss against JAX."""
    port_fn, jax_fn, x, args = _loss_case(name, np.random.RandomState(len(name)))
    x = x.astype(np.float32)
    args = [a.astype(np.float32) if a.dtype == np.float64 else a for a in args]
    want, want_g = jax.value_and_grad(lambda v: jax_fn(v, *args))(x)
    tx = torch.from_numpy(x).requires_grad_()
    got = port_fn(tx, *(torch.from_numpy(a) for a in args))
    (got_g,) = torch.autograd.grad(got, tx)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)
    if name in ("goal_empty_mask", "collision_no_positive"):
        assert float(got.detach()) == 0.0


def test_mix_ratios_match_jax():
    cfg, jcfg = AgentConfig(), JaxAgentConfig()
    for step in (0, 4000, 4001, 10000, 200000):
        got = mix_ratios(cfg, step)
        want = jax_ddpg.mix_ratios(jcfg, jnp.asarray(step))
        np.testing.assert_allclose(got, [float(w) for w in want], rtol=1e-7)


# -- optimizers ---------------------------------------------------------------------

@pytest.mark.parametrize("case", ["milestone", "clip_below", "clip_above", "carried"])
def test_optimizer_matches_optax(case):
    """AdamW against optax on the same gradients: across a learning-rate
    milestone, the critic's global-norm clip on both sides of 0.5, and
    from moments and a count carried over from an optax state."""
    rng = np.random.RandomState(7)
    shapes = [(4, 3), (3,), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    scale = {"clip_below": 0.05, "clip_above": 2.0}.get(case, 1.0)
    grads = [[(rng.randn(*s) * scale).astype(np.float32) for s in shapes] for _ in range(4)]
    clip = 0.5 if case.startswith("clip") else None
    cfg = JaxAgentConfig(feature_milestones=(2,)) if case == "milestone" else JaxAgentConfig()
    tx = jax_make_optimizers(cfg)["critic" if clip else "encoder"]
    j_params, j_state = list(params), tx.init(params)
    t_params = [torch.tensor(p) for p in params]
    if clip:
        opt = AdamW(t_params, cfg.value_lr, cfg.value_milestones, cfg.value_lr_gamma, clip=clip)
    else:
        opt = AdamW(t_params, cfg.feature_lr, cfg.feature_milestones, cfg.feature_lr_gamma)
    if case == "carried":  # two optax steps, then carry the state over
        for g in grads[:2]:
            upd, j_state = tx.update(g, j_state, j_params)
            j_params = optax.apply_updates(j_params, upd)
        adam = _adam(j_state)
        opt.count = adam["count"]
        with torch.no_grad():
            for t, p, mu, nu, m, n in zip(t_params, j_params, opt.mu, opt.nu,
                                          adam["mu"], adam["nu"]):
                t.copy_(torch.tensor(np.asarray(p)))
                mu.copy_(torch.tensor(m))
                nu.copy_(torch.tensor(n))
        grads = grads[2:]
    if clip:
        norms = [np.sqrt(sum((g ** 2).sum() for g in gs)) for gs in grads]
        assert all(n < clip for n in norms) if case == "clip_below" else all(n > clip for n in norms)
    for g in grads:
        upd, j_state = tx.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        opt.step([torch.tensor(x) for x in g])
        for t, p in zip(t_params, j_params):
            np.testing.assert_allclose(t.numpy(), np.asarray(p), rtol=1e-6, atol=1e-7)
    assert opt.count == _adam(j_state)["count"]
    if case == "milestone":  # the last two steps ran at feature_lr * gamma
        assert opt.learning_rate(opt.count - 1) == pytest.approx(
            cfg.feature_lr * cfg.feature_lr_gamma)


def test_state_copy_owns_its_optimizer_moments():
    """AgentState.to, to the same device too, gives a state whose
    optimizers step its own parameters and moments: stepping the copy
    leaves the original's Adam moments alone."""
    state = create_agent_state(AgentConfig(), 96, generator=torch.Generator().manual_seed(5),
                               device="cpu")
    copy = state.to("cpu")
    for name, opt in state.opt.items():
        twin = copy.opt[name]
        assert all(p is not q for p, q in zip(opt.params, twin.params))
        twin.step([torch.ones_like(p) for p in twin.params])
        assert all(float(m.abs().max()) == 0.0 for m in opt.mu + opt.nu), name
        assert all(float(m.abs().min()) > 0.0 for m in twin.mu + twin.nu), name


# -- train-mode feature --------------------------------------------------------------

@pytest.mark.parametrize("value,scale", [
    pytest.param(False, 1, id="False"), pytest.param(True, 1, id="True"),
    pytest.param(False, 2, id="False-scale2"), pytest.param(True, 2, id="True-scale2"),
])
def test_train_feature_matches_flax(value, scale, request, monkeypatch):
    """PointNetFeature(train=True), policy or value path, at model_scale 1
    and 2, against the Flax module's train apply: the feature and the
    updated running stats."""
    monkeypatch.delenv("GADDPG_PALLAS_SA_TRAIN", raising=False)
    js, cfg = ((request.getfixturevalue("jax_fresh"), CFG) if scale == 1 else
               (request.getfixturevalue("jax_fresh_scale2"), SCALE2))
    batch = make_batch(12)
    ps, action = batch["point_state"], batch["action"] if value else None
    variables = {"params": js.feat_params, "batch_stats": js.feat_stats}
    want, mut = JaxPointNetFeature(scale=scale).apply(
        variables, ps, action=action, value=value, train=True, mutable=["batch_stats"])
    state = port_state(js, AgentConfig(**cfg))
    got, stats = state.feat(torch.from_numpy(ps), None if action is None else
                            torch.from_numpy(action), value=value, train=True)
    assert got.shape == (B, 512 * scale) and len(stats) == 11
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FEATURE)
    name = "value_encoder" if value else "encoder"
    enc = getattr(state.feat, name)
    enc.update_running_stats(stats)
    for t, path, _ in _encoder_stat_pairs(enc):
        np.testing.assert_allclose(t.numpy(), _leaf(mut["batch_stats"][name], path),
                                   **(STATS if scale == 1 else STATS_SCALE2), err_msg=str(path))


def _plain_float64(monkeypatch):
    """Route the port's train forward through the plain versions, which
    take any dtype (the kernel wrappers take float32 only), with the FPS
    and ball-query indices of the float32 clouds."""
    def detached(out):
        pooled, stats = out
        return pooled, tuple((m.detach(), v.detach()) for m, v in stats)

    monkeypatch.setattr(port_pointnet, "sa_train_fused",
                        lambda *a: detached(sa_train.sa_train_reference(*a)))
    monkeypatch.setattr(port_pointnet, "groupall_train_fused",
                        lambda *a: detached(sa_train.groupall_train_reference(*a)))
    monkeypatch.setattr(port_pointnet, "furthest_point_sampling",
                        lambda xyz, k: sampling.fps_reference(xyz.float(), k))
    monkeypatch.setattr(port_pointnet, "ball_query", lambda c, x, r, k:
                        sampling.ball_query_reference(c.float(), x.float(), r, k))


@pytest.mark.parametrize("scale", [1, 2])
def test_train_statistics_near_float64(scale, request, monkeypatch):
    """The reason for STATS and STATS_SCALE2: against a float64 evaluation
    of the same network (the plain versions in float64), the port's float32
    batch means of the FC trunk's first BatchNorm (2048 channels at scale
    2) lie within 1e-5, the JAX CPU path's within 2e-4 (measured 8.5e-5 to
    1.3e-4 at scale 1, 1.2e-4 to 1.5e-4 at scale 2; the port's 2.9e-6 to
    4.7e-6). The running mean moves by a tenth of the batch mean."""
    monkeypatch.delenv("GADDPG_PALLAS_SA_TRAIN", raising=False)
    js, cfg = ((request.getfixturevalue("jax_fresh"), CFG) if scale == 1 else
               (request.getfixturevalue("jax_fresh_scale2"), SCALE2))
    batch = make_batch(12)
    ps, action = batch["point_state"], batch["action"]
    state = port_state(js, AgentConfig(**cfg))
    for value, name in ((False, "encoder"), (True, "value_encoder")):
        act = torch.from_numpy(action) if value else None
        _, stats32 = state.feat(torch.from_numpy(ps), act, value=value, train=True)
        with monkeypatch.context() as mp:
            _plain_float64(mp)
            feat64 = copy.deepcopy(state.feat).double()
            _, stats64 = feat64(torch.from_numpy(ps).double(),
                                None if act is None else act.double(), value=value, train=True)
        _, mut = JaxPointNetFeature(scale=scale).apply(
            {"params": js.feat_params, "batch_stats": js.feat_stats}, ps,
            action=action if value else None, value=value, train=True, mutable=["batch_stats"])
        m64 = stats64[9][0].detach().numpy()
        r0 = np.asarray(js.feat_stats[name]["BatchNorm_0"]["mean"], np.float64)
        m_jax = (np.asarray(mut["batch_stats"][name]["BatchNorm_0"]["mean"], np.float64)
                 - port_pointnet.BN_MOMENTUM * r0) / (1 - port_pointnet.BN_MOMENTUM)
        assert np.abs(stats32[9][0].numpy() - m64).max() <= 1e-5, name
        assert np.abs(m_jax - m64).max() <= 2e-4, name


# -- updates -------------------------------------------------------------------------

def _bn_fed_bias(name, path):
    return name.endswith("encoder") and path[-1] == "bias" and path[-2].startswith("Dense")


def _groups(state):
    """Group -> parameter tree of a JAX state, named as the port's
    optimizers, plus the two targets."""
    return {"policy": state.policy_params, "critic": state.critic_params,
            "encoder": state.feat_params["encoder"],
            "value_encoder": state.feat_params["value_encoder"],
            "policy_target": state.policy_target, "critic_target": state.critic_target}


def _check_moves(port, before, after, cfg, bounds):
    """Each group of `bounds` (group -> (threshold, fraction)): the port's
    move of every element from the JAX state `before` against JAX's move
    to `after`; at most `fraction` of the elements may differ by more
    than `threshold` * lr. BatchNorm-fed Dense biases: |move| <= lr on
    both sides."""
    lrs = {"policy": cfg.lr, "critic": cfg.value_lr, "encoder": cfg.feature_lr,
           "value_encoder": cfg.feature_lr, "policy_target": cfg.lr,
           "critic_target": cfg.value_lr}
    pairs = dict(_pairs(port), policy_target=_policy_pairs(port.policy_target),
                 critic_target=_critic_pairs(port.critic_target))
    prev_tree, want_tree = _groups(before), _groups(after)
    for name, (threshold, fraction) in bounds.items():
        lr, off, total = lrs[name], 0, 0
        for t, path, transpose in pairs[name]:
            got = t.detach().numpy()
            # Flax layout: Dense kernels transposed, Conv kernels (kh, kw, in, out)
            got = got.transpose(2, 3, 1, 0) if transpose == CONV else got.T if transpose else got
            want, prev = _leaf(want_tree[name], path), _leaf(prev_tree[name], path)
            if _bn_fed_bias(name, path):
                for side in (got, want):
                    assert np.abs(side - prev).max() <= lr * (1 + 1e-3), (name, path)
                continue
            off += int((np.abs((got - prev) - (want - prev)) > threshold * lr).sum())
            total += got.size
        assert off <= fraction * total, f"{name}: {off} of {total} moves differ"


def _check_stats(port, after, bound=None):
    for name in ("encoder", "value_encoder"):
        for t, path, _ in _encoder_stat_pairs(getattr(port.feat, name)):
            np.testing.assert_allclose(t.numpy(), _leaf(after.feat_stats[name], path),
                                       **(bound or STATS),
                                       err_msg=f"{name} {path}")


def _check_metrics(got, want, ac_rtol=0.0):
    assert set(got) == set(want)
    for k, w in want.items():
        bound = dict(METRIC, rtol=ac_rtol) if k == "actor_critic_loss" else METRIC
        np.testing.assert_allclose(float(got[k]), float(w), **bound, err_msg=k)


# Bounds of one update, each set from this file's inputs (the largest
# value measured in brackets, over this state and an earlier seed's).
# Losses and statistics agree to the float32 rounding of the JAX CPU
# path's BatchNorm statistics, amplified by the trunk as in
# test_train_feature_matches_flax. Parameter moves: Adam turns a gradient
# into a move of about lr * g / (sqrt(v) + 1e-5), so elements whose
# gradient lies within the two sides' rounding move differently; the
# check bounds the share of elements whose moves differ by more than a
# fraction of lr. The delayed actor term's gradient runs through the
# value encoder to its tiled action channels, where the batch-statistics
# BatchNorm backward cancels large sums: in float32, dQ/da is 1.3% (port)
# and 2.2% (JAX) off a float64 evaluation of the same network, so with
# the actor term on, the policy and encoder moves carry that noise. (On a
# fresh Adam state, where every move is +-lr by the gradient's sign, that
# noise flipped 15% of the policy's and 25% of the encoder's elements, so
# the updates start from a state with carried moments.)
METRIC = dict(rtol=3e-3, atol=1e-6)  # critic_loss [1.0e-3]
STATS = dict(rtol=1e-4, atol=1e-5)  # [3.2e-5]
# At model_scale 2 the FC trunk's first BatchNorm normalises 2048
# channels over B=8 rows, and the JAX CPU path's batch mean there lies
# 1.2e-4 to 1.5e-4 off a float64 evaluation of the same network (the
# port's 3.8e-6 to 4.7e-6; 8.5e-5 to 1.3e-4 for JAX at scale 1;
# test_train_statistics_near_float64): 1.5e-5 in the running mean
# (x 0.1), past STATS' atol.
STATS_SCALE2 = dict(rtol=1e-4, atol=2e-5)  # [1.5e-5]
CRITIC_PHASE = {"critic": (0.1, 1e-3),            # [1.5e-5]
                "value_encoder": (0.1, 2e-3),     # [2.9e-4]
                "critic_target": (0.1, 1e-3),     # [0]
                "policy_target": (2.5e-4, 1e-3)}  # polyak: tau * (a policy move <= 2 lr)
# model_scale 2, actor term off: the value encoder's moves carry the JAX
# CPU path's BatchNorm statistics, 30x farther from float64 than the
# port's at this scale (STATS_SCALE2) [2.4e-3 of its elements]
CRITIC_PHASE_SCALE2 = dict(CRITIC_PHASE, value_encoder=(0.1, 5e-3))
UPDATES = {  # name -> (update_step, actor_critic_loss rtol, policy/encoder bounds)
    # actor term off [7.4e-5 / 2.0e-4]
    "resumed": (1, 0.0, {"policy": (0.1, 1e-3), "encoder": (0.1, 2e-3)}),
    # actor term on [ac 2.7e-3; 5.9e-3 / 5.9e-3]
    "resumed_actor": (2, 1e-2, {"policy": (0.5, 2e-2), "encoder": (0.5, 2e-2)}),
}


@pytest.mark.parametrize("start,scale", [
    *(pytest.param(start, 1, id=start) for start in UPDATES),
    pytest.param("resumed", 2, id="resumed-scale2"),
])
def test_ddpg_update_matches_jax(start, scale, request):
    """One DDPG update from the same JAX state (after one JAX update:
    carried Adam moments) carried over with from_flax, at update_step 1
    (the delayed actor term is off) and 2 (on); at model_scale 2 at
    update_step 1."""
    if scale == 1:
        update, resumed = (request.getfixturevalue("jax_ddpg_update"),
                           request.getfixturevalue("jax_resumed"))
    else:
        update, resumed = request.getfixturevalue("jax_scale2")
    step, ac_rtol, bounds = UPDATES[start]
    js = resumed.replace(update_step=jnp.asarray(step, jnp.int32))
    batch, key = make_batch(20), jax.random.PRNGKey(21)
    after, want = update(js, batch, key)
    draws = np.array(jax.random.uniform(jax.random.split(key)[0], (B, 6)))
    cfg = AgentConfig(**(CFG if scale == 1 else SCALE2))
    port = port_state(js, cfg)
    count = port.opt["critic"].count
    assert count == 1
    got = make_ddpg_update(cfg, device="cpu")(port, _torch_batch(batch),
                                              noise_draws=torch.from_numpy(draws))
    assert (float(got["actor_critic_loss"]) != 0.0) == (step % cfg.policy_update_gap == 0)
    _check_metrics(got, want, ac_rtol)
    assert port.update_step == int(after.update_step) == step + 1
    assert all(o.count == count + 1 for o in port.opt.values())
    _check_stats(port, after, STATS if scale == 1 else STATS_SCALE2)
    _check_moves(port, js, after, cfg,
                 {**(CRITIC_PHASE if scale == 1 else CRITIC_PHASE_SCALE2), **bounds})


def test_bc_update_matches_jax(jax_resumed):
    """One BC update from the carried-over JAX state [moves 3.6e-4 / 1.5e-3]."""
    batch = make_batch(30)
    after, want = jax.jit(jax_bc.make_bc_update(JaxAgentConfig(**CFG)))(
        jax_resumed, batch, jax.random.PRNGKey(0))
    cfg = AgentConfig(**CFG)
    port = port_state(jax_resumed, cfg)
    got = make_bc_update(cfg, device="cpu")(port, _torch_batch(batch))
    assert float(got["collision_aux_loss"]) > 0
    _check_metrics(got, want)
    assert port.update_step == int(after.update_step) == 2
    assert port.opt["critic"].count == 1 and port.opt["encoder"].count == 2
    _check_stats(port, after)
    _check_moves(port, jax_resumed, after, cfg,
                 {"policy": (0.1, 2e-3), "encoder": (0.1, 5e-3), "value_encoder": (0.0, 0.0),
                  "critic": (0.0, 0.0), "policy_target": (0.0, 0.0),
                  "critic_target": (0.0, 0.0)})
