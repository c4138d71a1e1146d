"""Agent state for the serving path (counterpart of gaddpg_tpu/agents/state.py).

The JAX `AgentState` is one pytree of parameters, statistics and
optimizer states. The port's holds the two modules that serving needs:
the `PointNetFeature` encoders (parameters and BatchNorm running
statistics) and the `GaussianPolicy` head, both in eval mode. Critic,
targets and optimizers come with the learner.

`create_agent_state` initialises them with the JAX package's
initialisers; `from_flax` loads a JAX state's trees.
"""

import copy
import dataclasses
import math

import numpy as np
import torch
from torch import nn

from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.models import GaussianPolicy, PointNetFeature
from gaddpg_tpu_torch.utils.precision import resolve_device


@dataclasses.dataclass
class AgentState:
    feat: PointNetFeature
    policy: GaussianPolicy

    @property
    def device(self) -> torch.device:
        return next(self.policy.parameters()).device

    def to(self, device) -> "AgentState":
        """A copy of this state on `device`."""
        device = resolve_device(device)
        return AgentState(copy.deepcopy(self.feat).to(device),
                          copy.deepcopy(self.policy).to(device))


def check_supported(cfg: AgentConfig):
    """Raise for configurations the port does not run yet."""
    if cfg.use_image:
        raise NotImplementedError("image observations (ResNet-18) are not ported yet")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: only 'float32' is ported"
        )


def make_modules(cfg: AgentConfig):
    """(feature encoder, policy head) for `cfg`, with torch's default init."""
    check_supported(cfg)
    feat = PointNetFeature()
    # the optional collision-prediction logit rides as the LAST dim of
    # the policy aux head
    policy = GaussianPolicy(
        num_inputs=cfg.num_inputs,
        action_dim=cfg.action_dim,
        hidden=cfg.hidden_size,
        extra_pred_dim=(7 if cfg.policy_aux else 1)
        + (1 if cfg.collision_aux_weight > 0 else 0),
    )
    return feat, policy


def _truncated_normal_(w: torch.Tensor, scale: float, generator: torch.Generator):
    """Flax `variance_scaling(scale, "fan_in", "truncated_normal")` on a
    torch (out, in) weight: a normal truncated at +-2 std, rescaled so
    the variance is scale / fan_in."""
    std = math.sqrt(scale / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def _xavier_uniform_(w: torch.Tensor, generator: torch.Generator):
    """Flax `xavier_uniform` (fan_avg, uniform) on a torch (out, in) weight."""
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    nn.init.uniform_(w, -limit, limit, generator=generator)


def create_agent_state(cfg: AgentConfig = AgentConfig(), npoints: int = 1030,
                       generator: torch.Generator = None, device="cuda") -> AgentState:
    """Fresh serving state on `device`, initialised as the JAX package does:
    kaiming-normal SA Denses, lecun-normal FC Denses, xavier-uniform head
    Denses, zero biases, BatchNorm scale 1 / bias 0 / mean 0 / var 1.

    `npoints` (the point-state width, 6 anchors + cloud) is checked only:
    the modules do not depend on it. `generator` is a CPU generator
    (default: seeded with 0); draws happen on the CPU, then the modules
    move to `device`."""
    device = resolve_device(device)
    if npoints <= 6:
        raise ValueError(f"npoints={npoints} leaves no cloud after the 6 hand anchors")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    feat, policy = make_modules(cfg)
    with torch.no_grad():
        for enc in (feat.encoder, feat.value_encoder):
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
    return AgentState(feat.eval().to(device), policy.eval().to(device))


def _copy_(dst: torch.Tensor, src, transpose: bool = False):
    src = torch.tensor(np.asarray(src, dtype=np.float32))
    if transpose:
        src = src.t()
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src)


def _load_dense(linear: nn.Linear, p):
    _copy_(linear.weight, p["kernel"], transpose=True)  # Flax kernels are (in, out)
    _copy_(linear.bias, p["bias"])


def _load_bn(bn: nn.BatchNorm1d, p, stats):
    _copy_(bn.weight, p["scale"])
    _copy_(bn.bias, p["bias"])
    _copy_(bn.running_mean, stats["mean"])
    _copy_(bn.running_var, stats["var"])


def from_flax(feat_params, feat_stats, policy_params, cfg: AgentConfig = AgentConfig(),
              device="cuda") -> AgentState:
    """AgentState from a JAX state's trees, as nested dicts of arrays
    (e.g. `jax.tree_util.tree_map(np.asarray, state.feat_params)`).

    feat: `{encoder, value_encoder}/SetAbstraction_{0,1,2}/{Dense,BatchNorm}_{0,1,2}`
    and `Dense_{0,1}`, `BatchNorm_{0,1}` for the FC trunk; statistics
    under the same names with `mean`/`var`. policy: `Dense_0..Dense_4` =
    fc1, fc2, mean, extra, log_std."""
    device = resolve_device(device)
    feat, policy = make_modules(cfg)
    with torch.no_grad():
        for name in ("encoder", "value_encoder"):
            enc, p, st = getattr(feat, name), feat_params[name], feat_stats[name]
            for i, sa in enumerate(enc.sa):
                sp, ss = p[f"SetAbstraction_{i}"], st[f"SetAbstraction_{i}"]
                for j, (d, bn) in enumerate(zip(sa.dense, sa.norms)):
                    _load_dense(d, sp[f"Dense_{j}"])
                    _load_bn(bn, sp[f"BatchNorm_{j}"], ss[f"BatchNorm_{j}"])
            for j, (d, bn) in enumerate(zip(enc.fc, enc.fc_norms)):
                _load_dense(d, p[f"Dense_{j}"])
                _load_bn(bn, p[f"BatchNorm_{j}"], st[f"BatchNorm_{j}"])
        heads = (policy.fc1, policy.fc2, policy.mean, policy.extra, policy.log_std)
        for j, d in enumerate(heads):
            _load_dense(d, policy_params[f"Dense_{j}"])
    return AgentState(feat.eval().to(device), policy.eval().to(device))
