"""Shared pieces of the image-mode parity tests (tests/test_torch_resnet.py,
test_torch_image_env.py, test_torch_image_agent.py,
test_torch_image_policy.py, test_torch_image_loop.py): Flax trees from
the port's ResNet modules and seeded random encoders. JAX is imported
only by the helpers that build JAX trees."""

import numpy as np
import torch

from gaddpg_tpu_torch.agents.state import CONV, _encoder_pairs, _encoder_stat_pairs
from gaddpg_tpu_torch.models import ResNet18Feature

S = 32  # image side, as tests/test_image_mode.py runs image mode


def np_tree(tree):
    """A Flax tree (frozen or not) as nested dicts of numpy arrays."""
    import flax
    import jax

    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def flax_tree(pairs):
    """Nested dict of numpy arrays in the Flax layout from the port's
    (tensor, path, layout) pairs: Dense kernels transposed, Conv kernels
    (kh, kw, in, out)."""
    out = {}
    for t, path, layout in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        v = t.detach().cpu().numpy()
        if layout == CONV:
            v = v.transpose(2, 3, 1, 0)
        elif layout:
            v = v.T
        node[path[-1]] = np.ascontiguousarray(v)
    return out


def resnet_variables(enc: ResNet18Feature):
    """{"params", "batch_stats"} of a Flax ResNet18Feature holding `enc`'s values."""
    return {"params": flax_tree(_encoder_pairs(enc)),
            "batch_stats": flax_tree(_encoder_stat_pairs(enc))}


def random_resnet(seed: int) -> ResNet18Feature:
    """A ResNet18Feature with seeded random weights, BatchNorm affines
    and running statistics (numpy's RandomState(seed)), so that eval mode
    exercises every statistic."""
    rng = np.random.RandomState(seed)
    enc = ResNet18Feature().eval()
    with torch.no_grad():
        for name, t in list(enc.named_parameters()) + list(enc.named_buffers()):
            if not t.is_floating_point() or name in ("mean", "std"):
                continue
            if name.endswith("running_var"):
                v = 0.5 + np.abs(rng.randn(*t.shape))
            elif name.endswith("running_mean"):
                v = 0.1 * rng.randn(*t.shape)
            elif t.dim() == 4:  # conv: lecun-normal scale
                v = rng.randn(*t.shape) / np.sqrt(t[0].numel())
            elif name.endswith("weight"):
                v = 1.0 + 0.2 * rng.randn(*t.shape)
            else:
                v = 0.1 * rng.randn(*t.shape)
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return enc


# one BasicBlock a stage (ResNet-10): the update parity tests build both
# packages' encoders at this depth, where the JAX updates trace and
# compile in half the time; the full depth is held in
# tests/test_torch_resnet.py
SHALLOW = (1, 1, 1, 1)


def shallow_resnet(mp):
    """Patch (with the MonkeyPatch `mp`) both packages' ImageFeature to build
    ResNet18Feature(stage_sizes=SHALLOW)."""
    import functools

    from gaddpg_tpu.models import resnet as jax_resnet
    from gaddpg_tpu_torch.models import resnet

    mp.setattr(jax_resnet, "ResNet18Feature",
               functools.partial(jax_resnet.ResNet18Feature, stage_sizes=SHALLOW))
    mp.setattr(resnet, "ResNet18Feature",
               functools.partial(resnet.ResNet18Feature, stage_sizes=SHALLOW))


def jax_agent_state(port, jax_cfg):
    """A fresh JAX AgentState (optimizers at count 0, targets equal to the
    heads) holding the weights of the port's image AgentState `port`."""
    import jax

    from gaddpg_tpu.agents.state import AgentState, make_optimizers
    from gaddpg_tpu_torch.agents.state import _critic_pairs, _policy_pairs

    feat = {k: {n: resnet_variables(getattr(port.feat, n))[k]
                for n in ("encoder", "value_encoder")} for k in ("params", "batch_stats")}
    policy, critic = flax_tree(_policy_pairs(port.policy)), flax_tree(_critic_pairs(port.critic))
    txs = make_optimizers(jax_cfg)
    return AgentState(
        feat_params=feat["params"], feat_stats=feat["batch_stats"], policy_params=policy,
        critic_params=critic, goal_params=None, goal_stats=None,
        policy_target=jax.tree_util.tree_map(np.copy, policy),
        critic_target=jax.tree_util.tree_map(np.copy, critic),
        policy_opt=txs["policy"].init(policy), critic_opt=txs["critic"].init(critic),
        feat_opt={n: txs[n].init(feat["params"][n]) for n in ("encoder", "value_encoder")},
        goal_opt=None, update_step=np.asarray(0, np.int32))
