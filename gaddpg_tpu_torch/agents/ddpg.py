"""Action selection (counterpart of the serving half of gaddpg_tpu/agents/ddpg.py).

`make_select_action` builds the policy forward the JAX package jits for
serving (reference: core/agent.py:82-125): encode the point state in
eval mode, append the remaining-time column, run the Gaussian head,
squash the mean, and optionally add exploration noise. The DDPG update
comes with the learner.

Deviation carried over from the JAX package: the reference's uniform
noise `(rand*3 - 6) * scale` is biased (always negative;
reference: core/utils.py:575); the symmetric `(rand*6 - 3) * scale` is
used instead.
"""

import torch

from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.agents.state import AgentState, check_supported
from gaddpg_tpu_torch.utils.precision import f32_matmuls, resolve_device


def exploration_noise(draws, noise_scale, noise_type: str = "uniform"):
    """Symmetric exploration/smoothing noise from raw `draws` of the
    action's shape (U[0, 1) for "uniform", N(0, 1) otherwise); rotation
    dims x5 (reference: core/utils.py:568-584, made symmetric)."""
    if noise_type == "uniform":
        n = (draws * 6.0 - 3.0) * noise_scale
    else:
        n = draws * noise_scale / 2.0
    return torch.cat([n[..., :3], n[..., 3:] * 5.0], dim=-1)


def extract_feature(feat, point_state, time_batch, action=None, value: bool = False,
                    train: bool = False, use_time: bool = True):
    """Encoder forward -> feature (B, 512 (+1 time column))."""
    out = feat(point_state, action=action, value=value, train=train)
    if use_time:
        out = torch.cat([out, time_batch[:, None].to(out.dtype)], dim=-1)
    return out


def make_select_action(cfg: AgentConfig = AgentConfig(), device="cuda"):
    """Build `select_action(state, point_state, remain_time, generator=None,
    noise_scale=0.0, explore=False) -> (action, aux_pred)`.

    point_state (B, 4, N) and remain_time (B,) are float32 tensors on
    `device`, where the state must also lie. With explore=True the noise
    is drawn from `generator` (a generator of `device`; None = torch's
    default one)."""
    check_supported(cfg)
    device = resolve_device(device)

    @torch.no_grad()
    @f32_matmuls
    def select_action(state: AgentState, point_state, remain_time, generator=None,
                      noise_scale=0.0, explore=False):
        for name, t in (("point_state", point_state), ("remain_time", remain_time)):
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, select_action on {device}")
        if state.device != device:
            raise ValueError(f"agent state is on {state.device}, select_action on {device}")
        feature = extract_feature(state.feat, point_state, remain_time,
                                  use_time=cfg.use_time)
        mean, _, aux = state.policy(feature)
        action = torch.tanh(mean) * state.policy.action_high
        if explore:
            draw = torch.rand if cfg.noise_type == "uniform" else torch.randn
            u = draw(action.shape, generator=generator, device=device)
            action = action + exploration_noise(u, cfg.action_noise * noise_scale,
                                                cfg.noise_type)
        return action, aux

    return select_action
