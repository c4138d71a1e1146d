"""DDPG/TD3 update and action selection (counterpart of gaddpg_tpu/agents/ddpg.py).

The update (reference: core/ddpg.py:146-185, core/agent.py:127-240):

- critic phase: twin smooth-L1 Bellman error on non-perturbed samples
  (DART steps excluded, reference: core/ddpg.py:125-126) + critic
  grasp-aux PM loss; the gradients step the critic AND the value encoder.
  The target comes from the online encoders under no grad and the target
  heads.
- policy phase: PM behaviour cloning on expert steps * (1 - mix ratio),
  policy grasp-aux PM loss, and a delayed deterministic actor-critic term
  -mix * min(Q1, Q2) on non-expert-success samples through the UPDATED
  critic and value encoder, which receive no gradient from it
  (reference: core/ddpg.py:164-177); the gradients step the policy AND
  the policy encoder.
- targets: policy target polyak(tau); critic target Q1 polyak every
  step, Q2 copied every `target_update_interval`, aux head never
  (reference: core/utils.py:757-774).

Of the five train-mode encoder forwards, the BatchNorm running
statistics keep those of the value encoder's critic-phase forward and of
the policy encoder's policy-phase forward, as in the JAX update.

Under a data-parallel mesh (`mesh=`, `parallel.mesh`) each rank takes
its B/n rows of the batch and of the smoothing noise (drawn for the
global batch, `parallel.mesh.draw_rows`): every BatchNorm statistic is
over the global batch, each loss is the rank's sum over the global
count, one flat all-reduce sums the gradients before each optimizer
step, and the metrics are the global batch's. The parameters, targets,
Adam moments and running statistics stay bit-identical on every rank.

Deviation carried over from the JAX package: the reference's uniform
noise `(rand*3 - 6) * scale` is biased (always negative;
reference: core/utils.py:575); the symmetric `(rand*6 - 3) * scale` is
used instead.
"""

import contextlib

import torch

from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.agents.losses import (
    collision_bce, global_mean, global_sum, goal_pred_loss, pose_bc_loss, smooth_l1,
)
from gaddpg_tpu_torch.agents.state import AgentState, check_supported
from gaddpg_tpu_torch.parallel.mesh import draw_rows, sum_grads, sum_over_ranks
from gaddpg_tpu_torch.utils.precision import f32_matmuls, resolve_device


def _valid_index(values, idx: int):
    return values[min(idx, len(values) - 1)]


def _sched_index(step: int, milestones) -> int:
    return sum(step > m for m in milestones)


def mix_ratios(cfg: AgentConfig, step: int):
    """(mix_value_ratio, mix_policy_ratio) at update `step`
    (reference: core/ddpg.py:108-117)."""
    idx = _sched_index(step, cfg.mix_milestones)
    mp = min(_valid_index(cfg.mix_policy_ratio_list, idx), cfg.mix_policy_ratio_cap)
    mv = min(_valid_index(cfg.mix_value_ratio_list, idx), cfg.mix_value_ratio_cap)
    return mv, mp


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
                    train: bool = False, use_time: bool = True, mesh=None):
    """Encoder forward -> (feature (B, 512 (+1 time column)), stats):
    stats is the encoder's batch [(mean, var)] with train=True (over every
    rank's rows with a data-parallel `mesh`), else None."""
    out = feat(point_state, action=action, value=value, train=train, mesh=mesh)
    out, stats = out if train else (out, None)
    if use_time:
        out = torch.cat([out, time_batch[:, None].to(out.dtype)], dim=-1)
    return out, stats


def obs_key(cfg: AgentConfig) -> str:
    """The batch key of the encoders' input: the RGBDM image in image mode,
    else the point state (reference: core/agent.py:63-70)."""
    return "image_state" if cfg.use_image else "point_state"


def _masks(batch):
    """Training masks (reference: core/agent.py:224-237)."""
    reward_mask = batch["return"] > 0
    expert_mask = batch["expert_flags"] >= 1
    return {
        "reward": reward_mask,
        "expert": expert_mask,
        "expert_reward": reward_mask & expert_mask,
        "not_perturb": batch["perturb_flags"] < 1,
        "goal_reward": reward_mask,
    }


@torch.no_grad()
def _soft_update(target, source, tau: float):
    for t, s in zip(target.parameters(), source.parameters(), strict=True):
        t.copy_(t * (1.0 - tau) + s * tau)


@torch.no_grad()
def _critic_target_update(target, source, tau: float, hard: bool):
    """Q1 polyak every step; Q2 copied when `hard`; the aux head never
    moves (reference: core/utils.py:757-770)."""
    src = dict(source.named_parameters())
    for name, t in target.named_parameters():
        if name.startswith("q1"):
            t.copy_(t * (1.0 - tau) + src[name] * tau)
        elif name.startswith("q2") and hard:
            t.copy_(src[name])


@contextlib.contextmanager
def _frozen(*modules):
    """The modules' parameters do not require grad inside the block (JAX's
    stop_gradient on their parameters; inputs still carry gradients)."""
    params = [p for m in modules for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def _grads(loss, params):
    return torch.autograd.grad(loss, params, allow_unused=True)


def resolve_update_device(device, mesh):
    """The update's device; under a mesh it must be the mesh's."""
    device = resolve_device(device)
    if mesh is not None and device != mesh.device:
        raise ValueError(f"update on {device}, its mesh's rank on {mesh.device}")
    return device


def _check_inputs(name, state: AgentState, batch, device):
    if state.device != device:
        raise ValueError(f"agent state is on {state.device}, {name} on {device}")
    for key, t in batch.items():
        if isinstance(t, torch.Tensor) and t.device != device:
            raise ValueError(f"batch[{key!r}] is on {t.device}, {name} on {device}")


def _policy_losses(cfg: AgentConfig, state: AgentState, batch, m, bc_weight: float,
                   mesh=None):
    """The policy phase's shared part: train-mode policy-encoder forward,
    PM behaviour cloning (expert rows, collision-discounted) scaled by
    `bc_weight`, the goal aux loss and the collision aux loss (this rank's
    shares of them under a `mesh`). -> (pi, stats, bc, aux, collision)."""
    feature, stats = extract_feature(state.feat, batch[obs_key(cfg)], batch["time"],
                                     train=True, use_time=cfg.use_time, mesh=mesh)
    mean, _, aux_pred = state.policy(feature)
    pi = torch.tanh(mean) * state.policy.action_high
    # collision-discounted imitation: expert transitions committed to a
    # later robot-obstacle contact are down-weighted
    w_expert = m["expert"].to(torch.float32)
    if cfg.collision_demo_discount > 0:
        w_expert = w_expert * (1.0 - cfg.collision_demo_discount * batch["collide_future"])
    bc = pose_bc_loss(pi, batch["expert_action"], w_expert, mesh) * bc_weight
    aux = 0.0
    if cfg.policy_aux:
        aux = goal_pred_loss(aux_pred[:, :7], batch["goal"][:, :7], m["goal_reward"], mesh)
    collision = 0.0
    if cfg.collision_aux_weight > 0:
        collision = cfg.collision_aux_weight * collision_bce(
            aux_pred[:, -1], batch["collide_future"], mesh=mesh)
    return pi, stats, bc, aux, collision


def _metric(v, device):
    return v.detach() if isinstance(v, torch.Tensor) else torch.tensor(float(v), device=device)


def _metrics(metrics, device, mesh=None, summed=()):
    """The metrics as tensors; under a mesh, the `summed` ones (this rank's
    shares of a global loss, mean or count) added across the ranks in one
    all-reduce."""
    out = {k: _metric(v, device) for k, v in metrics.items()}
    if mesh is not None:
        total = sum_over_ranks(mesh, torch.stack([out[k].to(torch.float32) for k in summed]))
        out.update(zip(summed, total))
    return out


def make_ddpg_update(cfg: AgentConfig = AgentConfig(), device="cuda", mesh=None):
    """Build `update(state, batch, generator=None, noise_draws=None) ->
    metrics`, which takes one DDPG step on `state` in place (parameters,
    running statistics, targets, optimizers, update_step).

    `batch` is a dict of tensors on `device`: point_state and
    next_point_state (B, 4, N) (in image mode image_state and
    next_image_state (B, 5, H, W) instead), action and expert_action
    (B, 6), goal (B, 7+), reward, return, terminal, time, expert_flags, perturb_flags
    (B,), and collide_future (B,) when a collision term is on. The target
    smoothing noise takes its raw draws (B, 6), U[0, 1) for the uniform
    noise type, from `noise_draws` if given, else from `generator` (a
    generator of `device`; None = torch's default one).

    With a data-parallel `mesh` (the device must be its rank's), `batch`
    and `noise_draws` are this rank's rows (`parallel.mesh.
    make_sharded_update` takes the global batch), the draws from
    `generator` are made for the global batch, and every rank's state
    moves alike."""
    check_supported(cfg)
    device = resolve_update_device(device, mesh)

    @f32_matmuls
    def update(state: AgentState, batch, generator=None, noise_draws=None):
        _check_inputs("ddpg update", state, batch, device)
        step = state.update_step
        m = _masks(batch)
        mix_value_ratio, mix_policy_ratio = mix_ratios(cfg, step)
        noise_scale = cfg.action_noise * _valid_index(
            cfg.noise_ratio_list, _sched_index(step, cfg.mix_milestones))
        feat, opt = state.feat, state.opt
        ps, time = batch[obs_key(cfg)], batch["time"]

        # ---------------- critic phase ----------------
        value_feat, stats1 = extract_feature(feat, ps, time, action=batch["action"],
                                             value=True, train=True, use_time=cfg.use_time,
                                             mesh=mesh)
        qf1, qf2, critic_aux = state.critic(value_feat)
        with torch.no_grad():  # target value (reference: core/ddpg.py:61-88)
            next_ps, next_time = batch["next_" + obs_key(cfg)], time - 1.0
            next_feat, _ = extract_feature(feat, next_ps, next_time, train=True,
                                           use_time=cfg.use_time, mesh=mesh)
            next_mean, _, _ = state.policy_target(next_feat)
            next_action = torch.tanh(next_mean) * state.policy_target.action_high
            if noise_draws is None:
                draw = torch.rand if cfg.noise_type == "uniform" else torch.randn
                noise_draws = draw_rows(
                    mesh, lambda shape: draw(shape, generator=generator, device=device),
                    next_action.shape)
            nd = exploration_noise(noise_draws, noise_scale, cfg.noise_type)
            nd = torch.cat([torch.clamp(nd[:, :3], -0.01, 0.01), nd[:, 3:]], dim=-1)
            next_vfeat, _ = extract_feature(feat, next_ps, next_time, action=next_action + nd,
                                            value=True, train=True, use_time=cfg.use_time,
                                            mesh=mesh)
            q1t, q2t, _ = state.critic_target(next_vfeat)
            min_q = torch.minimum(q1t[:, 0], q2t[:, 0])
            next_q = batch["reward"] + (1.0 - batch["terminal"]) * cfg.gamma * min_q
        critic_loss = (smooth_l1(qf1[:, 0], next_q, m["not_perturb"], mesh=mesh)
                       + smooth_l1(qf2[:, 0], next_q, m["not_perturb"], mesh=mesh))
        critic_aux_loss = 0.0
        if cfg.critic_aux:
            critic_aux_loss = goal_pred_loss(critic_aux[:, :7], batch["goal"][:, :7],
                                             m["goal_reward"], mesh)
        c_params, v_params = opt["critic"].params, opt["value_encoder"].params
        grads = sum_grads(mesh, _grads(critic_loss + critic_aux_loss, c_params + v_params),
                          c_params + v_params)
        opt["critic"].step(grads[:len(c_params)])
        # the value-encoder optimizer advances even when its
        # parameters stay frozen
        opt["value_encoder"].step(grads[len(c_params):], apply=cfg.train_value_feature)

        # ---------------- policy phase ----------------
        apply_ac = step % cfg.policy_update_gap == 0
        pi, stats2, bc, policy_aux, collision = _policy_losses(
            cfg, state, batch, m, 1.0 - mix_policy_ratio, mesh)
        # delayed actor-critic term, through the updated critic and value
        # encoder, which it does not train; computed on every update (as
        # the JAX update does), differentiated only when it applies
        with _frozen(feat.value_encoder, state.critic), torch.set_grad_enabled(apply_ac):
            vfeat_pi, _ = extract_feature(feat, ps, time, action=pi, value=True, train=True,
                                          use_time=cfg.use_time, mesh=mesh)
            q1p, q2p, _ = state.critic(vfeat_pi)
            not_es = ~m["expert_reward"]
            denom = torch.clamp(global_sum(not_es, mesh), min=1)
            ac = -mix_policy_ratio * (torch.minimum(q1p[:, 0], q2p[:, 0]) * not_es).sum() / denom
        ac = ac if apply_ac else torch.zeros((), device=device)
        p_params, e_params = opt["policy"].params, opt["encoder"].params
        grads = sum_grads(mesh, _grads(bc + policy_aux + collision + ac, p_params + e_params),
                          p_params + e_params)
        opt["policy"].step(grads[:len(p_params)])
        opt["encoder"].step(grads[len(p_params):], apply=cfg.train_feature)

        # ---------------- statistics and targets ----------------
        feat.value_encoder.update_running_stats(stats1)
        feat.encoder.update_running_stats(stats2)
        state.update_step = step + 1
        _soft_update(state.policy_target, state.policy, cfg.tau)
        _critic_target_update(state.critic_target, state.critic, cfg.tau,
                              hard=state.update_step % cfg.target_update_interval == 0)
        metrics = {
            "critic_loss": critic_loss,
            "critic_grasp_aux_loss": critic_aux_loss,
            "bc_loss": bc,
            "policy_grasp_aux_loss": policy_aux + collision,
            "actor_critic_loss": ac,
            "q_mean": global_mean(qf1, mesh),
            "reward_mask_num": m["reward"].sum(),
            "expert_mask_num": m["expert"].sum(),
            "mix_policy_ratio": mix_policy_ratio,
            "mix_value_ratio": mix_value_ratio,
        }
        return _metrics(metrics, device, mesh, DDPG_SUMMED)

    update.mesh = mesh
    return update


def ddpg_update(cfg: AgentConfig = AgentConfig(), device="cuda", mesh=None):
    """The built DDPG update (`make_ddpg_update`), as the JAX package's
    `ddpg_update` returns its jitted update."""
    return make_ddpg_update(cfg, device, mesh=mesh)


# the DDPG metrics that are sums of the ranks' shares under a mesh
DDPG_SUMMED = ("critic_loss", "critic_grasp_aux_loss", "bc_loss", "policy_grasp_aux_loss",
               "actor_critic_loss", "q_mean", "reward_mask_num", "expert_mask_num")


def make_select_action(cfg: AgentConfig = AgentConfig(), device="cuda"):
    """Build `select_action(state, point_state, remain_time, generator=None,
    noise_scale=0.0, explore=False) -> (action, aux_pred)`
    (reference: core/agent.py:82-125).

    point_state (B, 4, N), or in image mode the RGBDM image (B, 5, H, W),
    and remain_time (B,) are float32 tensors on `device`, where the state
    must also lie. With explore=True the noise is drawn from `generator` (a
    generator of `device`; None = torch's default one)."""
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
        feature, _ = extract_feature(state.feat, point_state, remain_time,
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
