"""Agent state: modules, targets, optimizers (counterpart of gaddpg_tpu/agents/state.py).

The JAX `AgentState` is one pytree of parameters, statistics and
optimizer states. The port's holds modules instead:

- `feat`: the `PointNetFeature` encoders, or in image mode
  (`AgentConfig.use_image`) the ResNet-18 `ImageFeature` ones (parameters
  and BatchNorm running statistics), `policy`: the `GaussianPolicy` head,
  `critic`: the twin-Q `QNetwork`, all kept in eval mode (the train
  forward is asked for explicitly, see models/pointnet.py);
- `policy_target`, `critic_target`: snapshots of the heads, as in the
  reference where the feature extractor has no target copy
  (reference: core/ddpg.py:69-88);
- `opt`: the four optimizers ("policy", "critic", "encoder",
  "value_encoder"), `agents.optim.AdamW`;
- `update_step`: the number of updates taken;
- `goal`: the `GoalFeature` grasp-pose encoder (parameters and BatchNorm
  running statistics) and `goal_opt`, its AdamW at the feature learning
  rate, which the DDPG and BC updates leave alone
  (`data.grasp_dataset.make_goal_feature_update` steps them);
- `cfg`: the `AgentConfig` the state was built for, which a JAX
  checkpoint read into its shape needs (`train.checkpoints.load_agent`).

`create_agent_state` initialises them with the JAX package's
initialisers; `from_flax` loads a JAX state's trees, optimizer states
included, so a JAX checkpoint resumes in the port.
"""

import copy
import dataclasses
import math

import numpy as np
import torch
from torch import nn

from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.agents.optim import AdamW, multistep_lr  # noqa: F401 (exported)
from gaddpg_tpu_torch.models import (
    GaussianPolicy, GoalFeature, ImageFeature, PointNetFeature, QNetwork, ResNet18Feature,
)
from gaddpg_tpu_torch.models.resnet import load_pretrained_encoders
from gaddpg_tpu_torch.utils.precision import resolve_device

OPTIMIZERS = ("policy", "critic", "encoder", "value_encoder")


@dataclasses.dataclass
class AgentState:
    feat: nn.Module  # PointNetFeature, or ImageFeature in image mode
    policy: GaussianPolicy
    critic: QNetwork = None
    policy_target: GaussianPolicy = None
    critic_target: QNetwork = None
    opt: dict = None
    update_step: int = 0
    goal: GoalFeature = None
    goal_opt: AdamW = None
    cfg: AgentConfig = None

    @property
    def device(self) -> torch.device:
        return next(self.policy.parameters()).device

    def to(self, device) -> "AgentState":
        """A copy of this state on `device`, optimizer states included."""
        device = resolve_device(device)
        out = AgentState(*(None if m is None else copy.deepcopy(m).to(device)
                           for m in (self.feat, self.policy, self.critic,
                                     self.policy_target, self.critic_target)),
                         update_step=self.update_step,
                         goal=None if self.goal is None else copy.deepcopy(self.goal).to(device),
                         cfg=self.cfg)
        if self.opt is not None:
            out.opt = {name: _moved_optimizer(self.opt[name], params, device)
                       for name, params in _optimizer_params(out).items()}
        if self.goal_opt is not None:
            out.goal_opt = _moved_optimizer(self.goal_opt, goal_parameters(out.goal), device)
        return out


def state_tensors(state: AgentState):
    """Every tensor of `state` in a fixed order: each module's parameters
    and buffers (encoders, heads, targets, GoalFeature), then each
    optimizer's Adam moments. The optimizers' counts and update_step are
    host integers (`state_counts`)."""
    out = []
    for m in (state.feat, state.policy, state.critic, state.policy_target,
              state.critic_target, state.goal):
        if m is not None:
            out += [*m.parameters(), *m.buffers()]
    for opt in [*(state.opt or {}).values(), state.goal_opt]:
        if opt is not None:
            out += [*opt.mu, *opt.nu]
    return out


def state_counts(state: AgentState):
    """update_step, then each optimizer's count, in `state_tensors`' order."""
    opts = [o for o in [*(state.opt or {}).values(), state.goal_opt] if o is not None]
    return [int(state.update_step)] + [o.count for o in opts]


def set_state_counts(state: AgentState, counts):
    state.update_step = int(counts[0])
    opts = [o for o in [*(state.opt or {}).values(), state.goal_opt] if o is not None]
    for opt, c in zip(opts, counts[1:], strict=True):
        opt.count = int(c)


def _moved_optimizer(src: AdamW, params, device) -> AdamW:
    """A copy of optimizer `src` stepping `params`, its moments on `device`."""
    opt = copy.copy(src)
    opt.params = params
    opt.mu = [t.to(device, copy=True) for t in src.mu]
    opt.nu = [t.to(device, copy=True) for t in src.nu]
    return opt


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FEATURE_WIDTH = 512  # the encoders' output (PointNet++ at model scale 1, ResNet-18)


def check_supported(cfg: AgentConfig):
    """Raise for configurations the port cannot run."""
    if cfg.use_image and cfg.feature_dim != FEATURE_WIDTH:
        raise ValueError(f"feature_dim={cfg.feature_dim}: the ResNet-18 encoder outputs "
                         f"{FEATURE_WIDTH}")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}")


def make_modules(cfg: AgentConfig):
    """(feature encoder, policy head, critic) for `cfg`, with torch's
    default init. In image mode the encoders are ResNet-18 (ImageFeature);
    else PointNet++, whose model scale follows cfg.feature_dim, the
    heads' input: PointNetEncoder(scale=s) outputs 512 s features, so
    feature_dim = 1024 is the reference's model_scale 2."""
    check_supported(cfg)
    if cfg.use_image:
        feat = ImageFeature()
    else:
        scale, rest = divmod(cfg.feature_dim, FEATURE_WIDTH)
        if rest or scale < 1:
            raise ValueError(f"feature_dim={cfg.feature_dim}: the PointNet++ encoder "
                             f"outputs a multiple of {FEATURE_WIDTH}")
        # the encoders' FC Dense layers run in compute_dtype, as
        # gaddpg_tpu/agents/state.py:55 sets the JAX modules' dtype
        feat = PointNetFeature(scale=scale, compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype])
    # the optional collision-prediction logit rides as the LAST dim of
    # the policy aux head
    policy = GaussianPolicy(
        num_inputs=cfg.num_inputs,
        action_dim=cfg.action_dim,
        hidden=cfg.hidden_size,
        extra_pred_dim=(7 if cfg.policy_aux else 1)
        + (1 if cfg.collision_aux_weight > 0 else 0),
    )
    # image mode appends the action to the value feature (ImageFeature),
    # so the critic's input is wider (gaddpg_tpu/agents/state.py:152-154)
    critic = QNetwork(num_inputs=cfg.num_inputs + (cfg.action_dim if cfg.use_image else 0),
                      hidden=cfg.hidden_size, extra_pred_dim=7 if cfg.critic_aux else 0)
    return feat, policy, critic


# -- Flax names ----------------------------------------------------------------
# Each module's parameters as (tensor, path in the Flax tree, layout), in
# one fixed order: the optimizers step them in this order and `from_flax`
# loads parameters and Adam moments through it. Layout True: a Flax Dense
# kernel (in, out) of a torch Linear weight (out, in); CONV: a Flax Conv
# kernel (kh, kw, in, out) of a torch Conv2d weight (out, in, kh, kw).
CONV = "conv"

def _dense_pairs(linear: nn.Linear, path):
    return [(linear.weight, (*path, "kernel"), True), (linear.bias, (*path, "bias"), False)]


def _resnet_pairs(enc: ResNet18Feature):
    """ResNet18Feature's Flax tree: Conv_0 and BatchNorm_0 (the stem),
    then BasicBlock_i/{Conv,BatchNorm}_j (j = 2: the projection)."""
    def conv_bn(conv, bn, path, c, b):
        return [(conv.weight, (*path, c, "kernel"), CONV), (bn.weight, (*path, b, "scale"), False),
                (bn.bias, (*path, b, "bias"), False)]

    out = conv_bn(enc.conv1, enc.bn1, (), "Conv_0", "BatchNorm_0")
    for i, blk in enumerate(enc.blocks()):
        for j, (conv, bn) in enumerate(blk.convs()):
            out += conv_bn(conv, bn, (f"BasicBlock_{i}",), f"Conv_{j}", f"BatchNorm_{j}")
    return out


def _resnet_stat_pairs(enc: ResNet18Feature):
    def stats(bn, path):
        return [(bn.running_mean, (*path, "mean"), False), (bn.running_var, (*path, "var"), False)]

    out = stats(enc.bn1, ("BatchNorm_0",))
    for i, blk in enumerate(enc.blocks()):
        for j, (_, bn) in enumerate(blk.convs()):
            out += stats(bn, (f"BasicBlock_{i}", f"BatchNorm_{j}"))
    return out


def _encoder_pairs(enc):
    if isinstance(enc, ResNet18Feature):
        return _resnet_pairs(enc)
    out = []
    for i, sa in enumerate(enc.sa):
        for j, (d, bn) in enumerate(zip(sa.dense, sa.norms)):
            out += _dense_pairs(d, (f"SetAbstraction_{i}", f"Dense_{j}"))
            out += [(bn.weight, (f"SetAbstraction_{i}", f"BatchNorm_{j}", "scale"), False),
                    (bn.bias, (f"SetAbstraction_{i}", f"BatchNorm_{j}", "bias"), False)]
    for j, (d, bn) in enumerate(zip(enc.fc, enc.fc_norms)):
        out += _dense_pairs(d, (f"Dense_{j}",))
        out += [(bn.weight, (f"BatchNorm_{j}", "scale"), False),
                (bn.bias, (f"BatchNorm_{j}", "bias"), False)]
    return out


def _encoder_stat_pairs(enc):
    if isinstance(enc, ResNet18Feature):
        return _resnet_stat_pairs(enc)
    out = []
    for i, sa in enumerate(enc.sa):
        for j, bn in enumerate(sa.norms):
            out += [(bn.running_mean, (f"SetAbstraction_{i}", f"BatchNorm_{j}", "mean"), False),
                    (bn.running_var, (f"SetAbstraction_{i}", f"BatchNorm_{j}", "var"), False)]
    for j, bn in enumerate(enc.fc_norms):
        out += [(bn.running_mean, (f"BatchNorm_{j}", "mean"), False),
                (bn.running_var, (f"BatchNorm_{j}", "var"), False)]
    return out


def _policy_pairs(policy):
    heads = (policy.fc1, policy.fc2, policy.mean, policy.extra, policy.log_std)
    return [p for j, d in enumerate(heads) for p in _dense_pairs(d, (f"Dense_{j}",))]


def _critic_pairs(critic):
    names = ["q1_l1", "q1_l2", "q1_out", "q2_l1", "q2_l2", "q2_out"]
    if critic.extra_pred_dim > 0:
        names += ["aux_l1", "aux_l2", "aux_out"]
    return [p for n in names for p in _dense_pairs(getattr(critic, n), (n,))]


def _prefixed(pairs, prefix):
    return [(t, (prefix, *path), tr) for t, path, tr in pairs]


# GoalFeature's Flax tree: PointNetEncoder_0 and the heads Dense_0..2 (q, t, conf)
GOAL_ENCODER = "PointNetEncoder_0"


def _goal_pairs(goal: GoalFeature):
    return (_prefixed(_encoder_pairs(goal.encoder), GOAL_ENCODER)
            + [p for j, d in enumerate((goal.q, goal.t, goal.conf))
               for p in _dense_pairs(d, (f"Dense_{j}",))])


def _goal_stat_pairs(goal: GoalFeature):
    return _prefixed(_encoder_stat_pairs(goal.encoder), GOAL_ENCODER)


def goal_parameters(goal: GoalFeature):
    """GoalFeature's parameters in the order its optimizer steps them."""
    return [t for t, _, _ in _goal_pairs(goal)]


def _pairs(state: AgentState):
    """Optimizer name -> (tensor, Flax path, transposed) of what it steps."""
    return {
        "policy": _policy_pairs(state.policy),
        "critic": _critic_pairs(state.critic),
        "encoder": _encoder_pairs(state.feat.encoder),
        "value_encoder": _encoder_pairs(state.feat.value_encoder),
    }


def _optimizer_params(state: AgentState):
    return {name: [t for t, _, _ in pairs] for name, pairs in _pairs(state).items()}


def make_optimizers(cfg: AgentConfig, state: AgentState) -> dict:
    """Adam (eps 1e-5, decoupled weight decay 1e-5) with a MultiStepLR
    schedule for each of the four parameter groups; the critic's
    gradients are clipped by global norm (reference:
    core/utils.py:960-1006, core/ddpg.py:141). The policy encoder and the
    value encoder keep separate optimizers, stepped by different losses
    (reference: core/utils.py:221-234)."""
    params = _optimizer_params(state)
    kw = dict(eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
    return {
        "policy": AdamW(params["policy"], cfg.lr, cfg.policy_milestones, cfg.lr_gamma, **kw),
        "critic": AdamW(params["critic"], cfg.value_lr, cfg.value_milestones,
                        cfg.value_lr_gamma, clip=cfg.clip_grad, **kw),
        "encoder": AdamW(params["encoder"], cfg.feature_lr, cfg.feature_milestones,
                         cfg.feature_lr_gamma, **kw),
        "value_encoder": AdamW(params["value_encoder"], cfg.feature_lr,
                               cfg.feature_milestones, cfg.feature_lr_gamma, **kw),
    }


def make_goal_optimizer(cfg: AgentConfig, goal: GoalFeature) -> AdamW:
    """GoalFeature's Adam at the feature learning rate and schedule, as the
    JAX package's "goal" transform (gaddpg_tpu/agents/state.py:99)."""
    return AdamW(goal_parameters(goal), cfg.feature_lr, cfg.feature_milestones,
                 cfg.feature_lr_gamma, eps=cfg.adam_eps, weight_decay=cfg.weight_decay)


def _truncated_normal_(w: torch.Tensor, scale: float, generator: torch.Generator):
    """Flax `variance_scaling(scale, "fan_in", "truncated_normal")` on a
    torch (out, in) or (out, in, kh, kw) weight: a normal truncated at +-2
    std, rescaled so the variance is scale / fan_in."""
    std = math.sqrt(scale / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def _xavier_uniform_(w: torch.Tensor, generator: torch.Generator):
    """Flax `xavier_uniform` (fan_avg, uniform) on a torch (out, in) weight."""
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    nn.init.uniform_(w, -limit, limit, generator=generator)


def _init_heads_(module: nn.Module, generator: torch.Generator):
    """xavier-uniform weights, zero biases for every Linear of a head."""
    for d in module.modules():
        if isinstance(d, nn.Linear):
            _xavier_uniform_(d.weight, generator)
            d.bias.zero_()


def init_goal_(goal: GoalFeature, generator: torch.Generator):
    """GoalFeature initialised as the JAX package's: kaiming-normal SA
    Denses, lecun-normal FC and head Denses, zero biases, BatchNorm scale 1
    / bias 0 / mean 0 / var 1."""
    with torch.no_grad():
        for sa in goal.encoder.sa:
            for d in sa.dense:
                _truncated_normal_(d.weight, 2.0, generator)
                d.bias.zero_()
        for d in (*goal.encoder.fc, goal.q, goal.t, goal.conf):
            _truncated_normal_(d.weight, 1.0, generator)
            d.bias.zero_()
    return goal


def _assemble(cfg, feat, policy, critic, goal, device, update_step=0,
              policy_target=None, critic_target=None) -> AgentState:
    """AgentState on `device` with targets (copies of the heads unless
    given) and fresh optimizers."""
    state = AgentState(
        feat.eval(), policy.eval(), critic.eval(),
        (policy_target if policy_target is not None else copy.deepcopy(policy)).eval(),
        (critic_target if critic_target is not None else copy.deepcopy(critic)).eval(),
        update_step=update_step, goal=goal.eval(), cfg=cfg,
    )
    for m in (state.feat, state.policy, state.critic, state.policy_target, state.critic_target,
              state.goal):
        m.to(device)
    state.opt = make_optimizers(cfg, state)
    state.goal_opt = make_goal_optimizer(cfg, state.goal)
    return state


def create_agent_state(cfg: AgentConfig = AgentConfig(), npoints: int = 1030,
                       generator: torch.Generator = None, device="cuda") -> AgentState:
    """Fresh agent state on `device`, initialised as the JAX package does:
    kaiming-normal SA Denses, lecun-normal FC Denses (in image mode
    lecun-normal ResNet convolutions), xavier-uniform head Denses (policy
    and critic), zero biases, BatchNorm scale 1 / bias 0 / mean 0 / var 1;
    targets equal to the heads; GoalFeature as `init_goal_` (its draws
    after the others'); optimizers at count 0. In image mode with
    `cfg.pretrained_resnet`, both encoders then load that torchvision
    resnet18 file (`.npz` or `.pth`; models/resnet.py).

    `npoints` (the point-state width, 6 anchors + cloud) is checked only:
    the modules do not depend on it. `generator` is a CPU generator
    (default: seeded with 0); draws happen on the CPU, then the modules
    move to `device`."""
    device = resolve_device(device)
    if npoints <= 6:
        raise ValueError(f"npoints={npoints} leaves no cloud after the 6 hand anchors")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    feat, policy, critic = make_modules(cfg)
    with torch.no_grad():
        for enc in (feat.encoder, feat.value_encoder):
            if cfg.use_image:  # Flax Conv's default: lecun-normal
                for conv in [enc.conv1] + [c for b in enc.blocks() for c, _ in b.convs()]:
                    _truncated_normal_(conv.weight, 1.0, generator)
                continue
            for sa in enc.sa:
                for d in sa.dense:
                    _truncated_normal_(d.weight, 2.0, generator)
                    d.bias.zero_()
            for d in enc.fc:
                _truncated_normal_(d.weight, 1.0, generator)
                d.bias.zero_()
        for d in (policy.fc1, policy.fc2, policy.mean, policy.extra, policy.log_std):
            _xavier_uniform_(d.weight, generator)
            d.bias.zero_()
        _init_heads_(critic, generator)
    goal = init_goal_(GoalFeature(), generator)
    if cfg.use_image and cfg.pretrained_resnet:
        load_pretrained_encoders(feat, _read_state_dict(cfg.pretrained_resnet))
    return _assemble(cfg, feat, policy, critic, goal, device)


def _read_state_dict(path: str):
    """A torchvision-layout state dict from disk: an .npz with the key
    names, or a torch .pth (a bare state dict or one under "state_dict")."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return dict(data)
    sd = torch.load(path, map_location="cpu")
    return sd.get("state_dict", sd)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _copy_(dst: torch.Tensor, src, transpose=False):
    src = torch.tensor(np.asarray(src, dtype=np.float32))
    if transpose == CONV:
        src = src.permute(3, 2, 0, 1)
    elif transpose:
        src = src.t()
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src)


def _load(pairs, tree):
    for t, path, transpose in pairs:
        _copy_(t, _leaf(tree, path), transpose)


def goal_from_flax(params, stats, device="cuda") -> GoalFeature:
    """A GoalFeature (eval mode, on `device`) from a JAX GoalFeature's
    `params` and `batch_stats` trees as nested dicts of arrays:
    `PointNetEncoder_0/...` (the encoder's names, see `from_flax`) and the
    heads `Dense_0` (q), `Dense_1` (t), `Dense_2` (confidence)."""
    goal = GoalFeature()
    with torch.no_grad():
        _load(_goal_pairs(goal), params)
        _load(_goal_stat_pairs(goal), stats)
    return goal.eval().to(resolve_device(device))


def _load_moments(opt: AdamW, pairs, src):
    """Adam moments and count of an optax state {"mu", "nu", "count"}."""
    with torch.no_grad():
        for moments, key in ((opt.mu, "mu"), (opt.nu, "nu")):
            for t, (_, path, transpose) in zip(moments, pairs):
                _copy_(t, _leaf(src[key], path), transpose)
    opt.count = int(src["count"])


def from_flax(feat_params, feat_stats, policy_params, cfg: AgentConfig = AgentConfig(),
              device="cuda", *, critic_params=None, policy_target=None, critic_target=None,
              policy_opt=None, critic_opt=None, encoder_opt=None, value_encoder_opt=None,
              update_step: int = 0, goal_params=None, goal_stats=None,
              goal_opt=None) -> AgentState:
    """AgentState from a JAX state's trees, as nested dicts of arrays
    (e.g. `jax.tree_util.tree_map(np.asarray, state.feat_params)`).

    feat: `{encoder, value_encoder}/SetAbstraction_{0,1,2}/{Dense,BatchNorm}_{0,1,2}`
    and `Dense_{0,1}`, `BatchNorm_{0,1}` for the FC trunk, or in image
    mode `{encoder, value_encoder}/Conv_0`, `BatchNorm_0` (the stem) and
    `BasicBlock_{0..7}/{Conv,BatchNorm}_{0,1(,2)}`; statistics under the
    same names with `mean`/`var`. policy (and policy_target):
    `Dense_0..Dense_4` = fc1, fc2, mean, extra, log_std. critic (and
    critic_target): `q1_l1 .. aux_out`.

    Optional, to resume training: `critic_params` (default: initialised
    as `create_agent_state` does with seed 0), the targets (default:
    copies of the heads), each optimizer's optax Adam state as
    {"mu": tree, "nu": tree, "count": int} with trees shaped like the
    parameters it steps (`policy_opt`: policy_params, `critic_opt`:
    critic_params, `encoder_opt` / `value_encoder_opt`:
    feat_params["encoder"] / ["value_encoder"]; default: fresh),
    `update_step`, and the GoalFeature's `goal_params` and `goal_stats`
    (`goal_from_flax`'s trees; default: initialised as
    `create_agent_state` does with seed 0) with its optimizer `goal_opt`
    (default: fresh)."""
    device = resolve_device(device)
    feat, policy, critic = make_modules(cfg)
    p_target, c_target = copy.deepcopy(policy), copy.deepcopy(critic)
    with torch.no_grad():
        for name in ("encoder", "value_encoder"):
            enc = getattr(feat, name)
            _load(_encoder_pairs(enc), feat_params[name])
            _load(_encoder_stat_pairs(enc), feat_stats[name])
        _load(_policy_pairs(policy), policy_params)
        if critic_params is None:
            _init_heads_(critic, torch.Generator().manual_seed(0))
        else:
            _load(_critic_pairs(critic), critic_params)
        _load(_policy_pairs(p_target),
              policy_params if policy_target is None else policy_target)
        if critic_target is None:
            c_target.load_state_dict(critic.state_dict())
        else:
            _load(_critic_pairs(c_target), critic_target)
    if goal_params is None:
        goal = init_goal_(GoalFeature(), torch.Generator().manual_seed(0))
    else:
        goal = goal_from_flax(goal_params, goal_stats, device="cpu")
    state = _assemble(cfg, feat, policy, critic, goal, device, int(update_step), p_target,
                      c_target)
    opts = {"policy": policy_opt, "critic": critic_opt, "encoder": encoder_opt,
            "value_encoder": value_encoder_opt}
    for name, pairs in _pairs(state).items():
        if opts[name] is not None:
            _load_moments(state.opt[name], pairs, opts[name])
    if goal_opt is not None:
        _load_moments(state.goal_opt, _goal_pairs(state.goal), goal_opt)
    return state
