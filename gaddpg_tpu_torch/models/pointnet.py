"""PointNet++ set-abstraction encoder (counterpart of gaddpg_tpu/models/pointnet.py).

The reference `base_network` at model_scale=1
(reference: core/networks.py:65-92):

    SA1: npoint=32, radius=0.02, nsample=64,  mlp (in+3) ->  64 ->  64 -> 128
    SA2: npoint=32, radius=0.04, nsample=128, mlp (128+3)-> 128 -> 128 -> 256
    SA3: group-all,                mlp (256+3)-> 256 -> 256 -> 512
    FC:  512 -> 1024 -> 512 (BatchNorm + ReLU after each)

Points stay channels-last, (B, N, C).

Eval (`train=False`): each SA level folds its BatchNorms (running
statistics, eps 1e-5) into its Dense layers and runs as FPS -> ball
query -> fused gather+MLP+max (kernels K1, K2, K3; the group-all level
K4).

Train (`train=True`): every BatchNorm normalises with its batch
statistics. Grouped levels run K1 -> K2 -> `sa_train_fused` (K5, one
pass per layer and a pooling pass), the group-all level
`groupall_train_fused` (K6, one launch per layer and a pooling pass),
and the FC trunk uses Flax's arithmetic (fast variance clamped at 0).
Under a data-parallel mesh (`mesh=`, `parallel.mesh`) every one of
these statistics is over every rank's rows (`ops.sa_train.batch_moments`).
The train forward does not touch the running statistics: it returns
each BatchNorm's batch (mean, var), and the caller folds the ones it
keeps in with `PointNetEncoder.update_running_stats`, as the JAX update
keeps the statistics of two of its five encoder forwards. The modules'
own BatchNorm layers stay in eval mode.

`compute_dtype=torch.bfloat16` (`AgentConfig.compute_dtype`) runs the two
FC Dense layers as the JAX package's `Dense(dtype=bfloat16)` runs them;
the SA levels stay float32 there too, since its fused SA kernels take
float32 weights whatever the module's dtype
(gaddpg_tpu/models/pointnet.py:83-140). Parameters, BatchNorm and
everything after the Dense layers stay float32.
"""

from typing import Sequence

import torch
from torch import nn

from gaddpg_tpu_torch.ops.sa import folded_sa_weights, mlp_maxpool, sa_gather_mlp
from gaddpg_tpu_torch.ops.sa_train import batch_moments, groupall_train_fused, sa_train_fused
from gaddpg_tpu_torch.ops.sampling import ball_query, furthest_point_sampling, gather_points

BN_EPS = 1e-5
# Flax BatchNorm momentum: running = 0.9 * running + 0.1 * batch
BN_MOMENTUM = 0.9


def batch_norm_train(bn: nn.BatchNorm1d, x, mesh=None):
    """Train BatchNorm over axis 0 with Flax's arithmetic (fast variance,
    clamped at 0): (x - mean) * (rsqrt(var + eps) * scale) + bias, the
    statistics over every rank's rows with a data-parallel `mesh`.
    Returns (y, mean, var)."""
    m, v = batch_moments(x, (0,), mesh)
    v = torch.clamp(v, min=0.0)
    return (x - m) * (torch.rsqrt(v + bn.eps) * bn.weight) + bn.bias, m, v


@torch.no_grad()
def update_running_stats(norms, stats, momentum: float = BN_MOMENTUM):
    """Fold batch statistics [(mean, var)] into the BatchNorms `norms`
    as Flax does: running = momentum * running + (1 - momentum) * batch,
    with the biased variance clamped at 0."""
    for bn, (m, v) in zip(norms, stats, strict=True):
        bn.running_mean.copy_(momentum * bn.running_mean + (1 - momentum) * m)
        bn.running_var.copy_(momentum * bn.running_var + (1 - momentum) * torch.clamp(v, min=0.0))


def batch_norm_eval(bn: nn.BatchNorm1d, x):
    """Eval BatchNorm over the last axis with Flax's arithmetic:
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x - bn.running_mean) * mul + bn.bias


def _batch_norm(c: int) -> nn.BatchNorm1d:
    # Flax momentum 0.9 on the old value == torch momentum 0.1 on the new
    return nn.BatchNorm1d(c, eps=BN_EPS, momentum=0.1)


def dense(linear: nn.Linear, x, compute_dtype=torch.float32):
    """`linear(x)` in `compute_dtype`, a float32 result either way. In
    bfloat16 it computes as Flax's `Dense(dtype=bfloat16)`: x, W and b
    rounded to bfloat16, the product rounded to bfloat16 (its partial
    sums in float32 under `f32_matmuls`), then the bias added in
    bfloat16."""
    if compute_dtype == torch.float32:
        return linear(x)
    w, b = linear.weight.to(compute_dtype), linear.bias.to(compute_dtype)
    return ((x.to(compute_dtype) @ w.t()) + b).float()


class SetAbstraction(nn.Module):
    """One PointNet++ SA level: sample centres, group, shared MLP, max-pool.

    `dense[i]` / `norms[i]` are the Flax module's Dense_i / BatchNorm_i."""

    def __init__(self, npoint: int, radius: float, nsample: int, in_channels: int,
                 mlp: Sequence[int], group_all: bool = False):
        super().__init__()
        if len(mlp) != 3:
            raise ValueError("the fused SA kernels take exactly 3 layers")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        widths = [in_channels, *mlp]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.norms = nn.ModuleList(_batch_norm(c) for c in mlp)

    def forward(self, xyz, feats, train: bool = False, mesh=None):
        """xyz (B, N, 3); feats (B, N, C) -> (B, S, 3), (B, S, mlp[-1]),
        and with train=True also the three BatchNorms' batch
        ((mean, var),) * 3, detached (over every rank's rows with a
        data-parallel `mesh`)."""
        full = torch.cat([xyz, feats], dim=-1)  # (B, N, 3 + C)
        if train:
            dense = tuple((d.weight.t().contiguous(), d.bias, bn.weight, bn.bias)
                          for d, bn in zip(self.dense, self.norms))
        else:
            weights = folded_sa_weights(self.dense, self.norms)
        if self.group_all:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
            if train:
                return (new_xyz, *groupall_train_fused(full, dense, mesh))
            return new_xyz, mlp_maxpool(full, weights)
        xyz = xyz.detach().contiguous()
        centers = furthest_point_sampling(xyz, self.npoint)
        new_xyz = gather_points(xyz, centers)
        group_idx = ball_query(new_xyz, xyz, self.radius, self.nsample)
        # centre offsets for the gathered rows: xyz in cols 0:3, zero elsewhere
        cpad = nn.functional.pad(new_xyz, (0, full.shape[-1] - 3))
        if train:
            return (new_xyz, *sa_train_fused(group_idx, full, cpad, dense, mesh))
        return new_xyz, sa_gather_mlp(group_idx, full, cpad, weights)


class PointNetEncoder(nn.Module):
    """Full trunk: 3 SA levels + BN MLP head -> 512-d feature.

    `sa[i]` is SetAbstraction_i; `fc[i]` / `fc_norms[i]` are Dense_i /
    BatchNorm_i of the Flax module."""

    def __init__(self, in_channels: int = 4, nclusters: int = 32, radius: float = 0.02,
                 scale: int = 1, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        s = scale
        self.compute_dtype = compute_dtype
        self.sa = nn.ModuleList([
            SetAbstraction(nclusters, radius, 64, in_channels + 3, (64 * s, 64 * s, 128 * s)),
            SetAbstraction(32, 0.04, 128, 128 * s + 3, (128 * s, 128 * s, 256 * s)),
            SetAbstraction(0, 0.0, 0, 256 * s + 3, (256 * s, 256 * s, 512 * s),
                           group_all=True),
        ])
        self.fc = nn.ModuleList([nn.Linear(512 * s, 1024 * s), nn.Linear(1024 * s, 512 * s)])
        self.fc_norms = nn.ModuleList([_batch_norm(1024 * s), _batch_norm(512 * s)])

    def forward(self, pc, train: bool = False, mesh=None):
        """pc (B, N, C): columns 0:3 xyz, rest extra channels -> (B, 512s);
        with train=True -> ((B, 512s), [(mean, var)] of every BatchNorm in
        the order of `batch_norms`, detached; over every rank's rows with
        a data-parallel `mesh`)."""
        xyz, feats = pc[..., :3], pc
        stats = []
        for sa in self.sa:
            if train:
                xyz, feats, level_stats = sa(xyz, feats, train=True, mesh=mesh)
                stats += level_stats
            else:
                xyz, feats = sa(xyz, feats)
        h = feats[:, 0]
        for fc, bn in zip(self.fc, self.fc_norms):
            z = dense(fc, h, self.compute_dtype)
            if train:
                h, m, v = batch_norm_train(bn, z, mesh)
                stats.append((m.detach(), v.detach()))
                h = torch.relu(h)
            else:
                h = torch.relu(batch_norm_eval(bn, z))
        return (h, stats) if train else h

    def batch_norms(self):
        """Every BatchNorm: SA levels' in order, then the FC trunk's."""
        return [bn for sa in self.sa for bn in sa.norms] + list(self.fc_norms)

    def update_running_stats(self, stats):
        """Fold one train forward's batch statistics (in the order of
        `batch_norms`) into the running ones."""
        update_running_stats(self.batch_norms(), stats)


class PointNetFeature(nn.Module):
    """Policy + value encoders with the reference's input slicing.

    The point state is (B, 4, 1030): channel 3 flags the 6 hand anchor
    points, which are the first 6 points
    (reference: env/panda_scene.py:1195-1200). Both encoders drop them;
    the policy encoder sees 4 channels (xyz + flag), the value encoder 4 +
    the 6-d action tiled over the points (reference: core/networks.py:232-248).
    """

    def __init__(self, policy_in: int = 4, value_in: int = 10, nclusters: int = 32,
                 radius: float = 0.02, scale: int = 1, num_hand_points: int = 6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.policy_in, self.value_in = policy_in, value_in
        self.num_hand_points = num_hand_points
        self.encoder = PointNetEncoder(policy_in, nclusters, radius, scale, compute_dtype)
        self.value_encoder = PointNetEncoder(value_in, nclusters, radius, scale, compute_dtype)

    def _prep(self, point_state, channels):
        # (B, C, N) -> drop hand anchor points -> (B, N', C_keep)
        return point_state[:, :channels, self.num_hand_points:].transpose(1, 2)

    def forward(self, point_state, action=None, value: bool = False, train: bool = False,
                mesh=None):
        """point_state (B, 4, 1030); action (B, 6) for the value path.
        Returns the encoder's output (with train=True, also its batch
        statistics, over every rank's rows with a data-parallel `mesh`)."""
        if value:
            pc = point_state
            if action is not None:
                tiled = action[:, :, None].expand(*action.shape, point_state.shape[-1])
                pc = torch.cat([pc, tiled], dim=1)
            return self.value_encoder(self._prep(pc, self.value_in), train, mesh)
        return self.encoder(self._prep(point_state, self.policy_in), train, mesh)


class GoalFeature(nn.Module):
    """Grasp-pose prediction encoder (counterpart of GoalFeature in
    gaddpg_tpu/models/pointnet.py; reference: core/networks.py:150-178).

    An object cloud (B, N, 3) goes through a PointNetEncoder with 3 input
    channels (SA1 sees 6 columns: the centred xyz and the xyz) and
    `nclusters` SA1 centres; three Dense heads give a quaternion, a
    translation and a confidence logit. Returns the normalised [q, t]
    (B, 7) and the sigmoid confidence (B,); with train=True also the
    encoder's batch statistics, as PointNetEncoder returns them.

    `encoder` is the Flax module's PointNetEncoder_0; `q`, `t`, `conf` its
    Dense_0, Dense_1, Dense_2."""

    def __init__(self, nclusters: int = 128, radius: float = 0.02, scale: int = 1):
        super().__init__()
        self.encoder = PointNetEncoder(3, nclusters, radius, scale)
        width = 512 * scale
        self.q, self.t, self.conf = nn.Linear(width, 4), nn.Linear(width, 3), nn.Linear(width, 1)

    def forward(self, pc, train: bool = False):
        out = self.encoder(pc, train)
        z, stats = out if train else (out, None)
        q = self.q(z)
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
        qt = torch.cat([q, self.t(z)], dim=-1)
        conf = torch.sigmoid(self.conf(z)[..., 0])
        return (qt, conf, stats) if train else (qt, conf)
