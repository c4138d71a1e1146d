"""The learner's optimizers (counterpart of `make_optimizers` in
gaddpg_tpu/agents/state.py).

`AdamW` mirrors `optax.adamw(piecewise_constant_schedule(lr, {m: gamma}),
eps=adam_eps, weight_decay=weight_decay)`, optionally chained after
`optax.clip_by_global_norm(clip)`, in optax's arithmetic:

    g    <- g                    if |g| < clip else g / |g| * clip   (global norm)
    mu   <- (1 - b1) * g   + b1 * mu
    nu   <- (1 - b2) * g^2 + b2 * nu
    u    <- mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps)          (t = count + 1)
    p    <- p - lr(count) * (u + weight_decay * p)

Weight decay is decoupled and applies to every parameter, BatchNorm
scale and bias included. The learning rate is piecewise constant on the
optimizer's own count (`multistep_lr`), each milestone's factor applying
once count >= milestone. The clip has no epsilon (unlike
`torch.nn.utils.clip_grad_norm_`).
"""

import torch

B1, B2 = 0.9, 0.999  # optax's Adam defaults, which the JAX package keeps


def multistep_lr(base_lr: float, milestones, gamma: float):
    """torch's MultiStepLR as a function of the step count, with the
    values of optax's `piecewise_constant_schedule(base_lr, {m: gamma})`
    (gaddpg_tpu/agents/state.py:45): base_lr times gamma for each
    distinct milestone m with count >= m."""
    bounds = sorted({int(m) for m in milestones})

    def schedule(count: int) -> float:
        lr = base_lr
        for m in bounds:
            if count >= m:
                lr *= gamma
        return lr

    return schedule


class AdamW:
    """optax-equivalent AdamW over a fixed list of parameters.

    `mu`, `nu` (lists aligned with `params`) and `count` (an int) are the
    optax state's moments and step count, so a JAX optimizer state
    carries over."""

    def __init__(self, params, lr: float, milestones=(), gamma: float = 1.0,
                 eps: float = 1e-5, weight_decay: float = 1e-5, clip: float = None):
        self.params = list(params)
        self.lr, self.milestones, self.gamma = lr, tuple(milestones), gamma
        self.eps, self.weight_decay, self.clip = eps, weight_decay, clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self, count: int) -> float:
        return multistep_lr(self.lr, self.milestones, self.gamma)(count)

    @torch.no_grad()
    def step(self, grads, apply: bool = True):
        """One update from `grads` (aligned with `params`; None counts as
        zero). The moments and count always advance; the parameters move
        only when `apply`."""
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(self.params, grads, strict=True)]
        if self.clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.clip
            grads = [torch.where(keep, g, g / norm * self.clip) for g in grads]
        lr = self.learning_rate(self.count)
        self.count += 1
        bc1 = 1 - B1 ** self.count
        bc2 = 1 - B2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            if apply:
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                p.sub_(lr * (u + self.weight_decay * p))
