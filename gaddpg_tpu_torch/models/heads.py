"""Policy and critic heads (counterpart of gaddpg_tpu/models/heads.py).

Plain MLPs (no norm layers), so their target copies are parameter
snapshots, like the reference where only the heads have target networks.
"""

import math

import torch
from torch import nn

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -10.0
_EPS = 1e-6

# PandaTaskSpace6D bounds (reference: core/utils.py:505-510).
TASK6D_HIGH = (0.06, 0.06, 0.06, math.pi / 6, math.pi / 6, math.pi / 6)
TASK6D_LOW = tuple(-x for x in TASK6D_HIGH)


def normalize_quat_head(x):
    """Normalize the first 4 dims (quaternion) of a 7-d pose prediction."""
    q = x[..., :4]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
    return torch.cat([q, x[..., 4:]], dim=-1)


class GaussianPolicy(nn.Module):
    """Tanh-squashed Gaussian policy with a 7-d grasp auxiliary head.

    Layers in the order of the Flax module's Dense_0..Dense_4: fc1, fc2,
    mean, extra, log_std."""

    def __init__(self, num_inputs: int = 513, action_dim: int = 6, hidden: int = 256,
                 extra_pred_dim: int = 7, action_high=TASK6D_HIGH):
        super().__init__()
        self.extra_pred_dim = extra_pred_dim
        self.fc1 = nn.Linear(num_inputs, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.mean = nn.Linear(hidden, action_dim)
        self.extra = nn.Linear(hidden, extra_pred_dim)
        self.log_std = nn.Linear(hidden, action_dim)
        self.register_buffer(
            "action_high", torch.tensor(action_high, dtype=torch.float32), persistent=False
        )

    def forward(self, state):
        """state (B, F) -> (mean, log_std, extra_pred)."""
        h = torch.relu(self.fc1(state))
        h = torch.relu(self.fc2(h))
        mean = self.mean(h)
        extra = self.extra(h)
        if self.extra_pred_dim >= 7:
            # first 7 dims = [quat, trans] grasp prediction; any extra
            # dims (e.g. the collision logit) pass through unnormalized
            extra = normalize_quat_head(extra)
        log_std = torch.clamp(self.log_std(h), LOG_SIG_MIN, LOG_SIG_MAX)
        return mean, log_std, extra

    def sample(self, state, noise=None):
        """Returns (squashed_mean, log_prob, sampled_action, extra_pred),
        the reference sample contract (reference: core/networks.py:353-371).

        `noise` holds standard-normal draws of the action's shape (the
        caller draws them with its generator); with noise=None the action
        equals the deterministic squashed mean."""
        mean, log_std, extra = self(state)
        scale = self.action_high
        std = torch.exp(log_std)
        x_t = mean if noise is None else mean + std * noise
        y_t = torch.tanh(x_t)
        action = y_t * scale
        log_prob = -0.5 * ((x_t - mean) / std) ** 2 - log_std - 0.5 * math.log(2 * math.pi)
        log_prob = log_prob - torch.log(scale * (1 - y_t**2) + _EPS)
        log_prob = log_prob.sum(dim=-1, keepdim=True)
        squashed_mean = torch.tanh(mean) * scale
        return squashed_mean, log_prob, action, extra


class QNetwork(nn.Module):
    """Twin Q + 7-d auxiliary pose head.

    With sa_channel_concat the action rides inside the state feature (the
    value encoder sees it tiled over the points), so no action is
    concatenated here (reference: core/ddpg.py:91-99). The aux head reads
    the state only. Layer names are the Flax module's: q1_l1, q1_l2,
    q1_out, q2_*, aux_*."""

    def __init__(self, num_inputs: int = 513, hidden: int = 256, extra_pred_dim: int = 7):
        super().__init__()
        self.extra_pred_dim = extra_pred_dim
        for q in ("q1", "q2"):
            setattr(self, f"{q}_l1", nn.Linear(num_inputs, hidden))
            setattr(self, f"{q}_l2", nn.Linear(hidden, hidden))
            setattr(self, f"{q}_out", nn.Linear(hidden, 1))
        if extra_pred_dim > 0:
            self.aux_l1 = nn.Linear(num_inputs, hidden)
            self.aux_l2 = nn.Linear(hidden, hidden)
            self.aux_out = nn.Linear(hidden, extra_pred_dim)

    def forward(self, state):
        """state (B, F) -> (q1 (B, 1), q2 (B, 1), aux (B, extra) or None)."""
        h1 = torch.relu(self.q1_l2(torch.relu(self.q1_l1(state))))
        h2 = torch.relu(self.q2_l2(torch.relu(self.q2_l1(state))))
        aux = None
        if self.extra_pred_dim > 0:
            aux = self.aux_out(torch.relu(self.aux_l2(torch.relu(self.aux_l1(state)))))
            if self.extra_pred_dim == 7:
                aux = normalize_quat_head(aux)
        return self.q1_out(h1), self.q2_out(h2), aux
