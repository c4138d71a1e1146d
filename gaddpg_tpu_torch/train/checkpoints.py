"""Checkpoint save/load of an AgentState (counterpart of
gaddpg_tpu/train/checkpoints.py).

The port writes one `torch.save` file per snapshot, `agent_{surfix}.pt`
(`agent_latest`, `agent_epoch_N`), holding every module's parameters and
BatchNorm statistics (the encoders, the heads and their targets, the
GoalFeature), each optimizer's Adam moments and count (the GoalFeature's
too), and the update step.

`load_agent` also reads the JAX package's `agent_{surfix}.msgpack` (flax
`serialization.to_bytes` of its AgentState) through `train.flax_msgpack`
and `agents.state.from_flax`, point-cloud and image agents alike, so a
run trained with the JAX package resumes or is evaluated here.
"""

import os
from typing import Optional

import numpy as np
import torch

from gaddpg_tpu_torch.agents.state import AgentState, from_flax
from gaddpg_tpu_torch.train import flax_msgpack

MODULES = ("feat", "policy", "critic", "policy_target", "critic_target", "goal")
ADAM_FIELDS = {"count", "mu", "nu"}


def checkpoint_path(output_dir: str, surfix: str = "latest") -> str:
    return os.path.join(output_dir, f"agent_{surfix}.pt")


def flax_checkpoint_path(output_dir: str, surfix: str = "latest") -> str:
    """Where the JAX package writes its snapshot."""
    return os.path.join(output_dir, f"agent_{surfix}.msgpack")


def save_agent(state: AgentState, output_dir: str, surfix: str = "latest") -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = checkpoint_path(output_dir, surfix)
    torch.save({
        "modules": {m: getattr(state, m).state_dict() for m in MODULES},
        "opt": {name: {"mu": opt.mu, "nu": opt.nu, "count": opt.count}
                for name, opt in {**state.opt, "goal": state.goal_opt}.items()},
        "update_step": int(state.update_step),
    }, path)
    return path


def load_agent(template: AgentState, output_dir: str,
               surfix: str = "latest") -> Optional[AgentState]:
    """A copy of `template` (same config and device) with the snapshot's
    values, or None when there is no snapshot: `agent_{surfix}.pt`, or
    else the JAX package's `agent_{surfix}.msgpack`. Raises ValueError
    when both are there: which one is meant is not for the reader to
    guess."""
    path = checkpoint_path(output_dir, surfix)
    flax_path = flax_checkpoint_path(output_dir, surfix)
    if os.path.exists(path) and os.path.exists(flax_path):
        raise ValueError(f"both {path} and {flax_path} exist; remove the one not meant")
    if os.path.exists(flax_path):
        return load_flax_agent(template, flax_path)
    if not os.path.exists(path):
        return None
    data = torch.load(path, map_location=template.device)
    state = template.to(template.device)
    for m in MODULES:
        getattr(state, m).load_state_dict(data["modules"][m])
    opts = {**state.opt, "goal": state.goal_opt}
    with torch.no_grad():
        for name, saved in data["opt"].items():
            opt = opts[name]
            for dst, src in zip(opt.mu + opt.nu, saved["mu"] + saved["nu"], strict=True):
                dst.copy_(src)
            opt.count = int(saved["count"])
    state.update_step = int(data["update_step"])
    return state


def _adam(opt_state, where: str):
    """{"mu", "nu", "count"} of the one optax ScaleByAdamState in a decoded
    optimizer state (a chain's tuple arrives as a map keyed "0", "1", ...,
    a named tuple as a map keyed by field)."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            if set(node) == ADAM_FIELDS:
                found.append(node)
            else:
                for v in node.values():
                    walk(v)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"{where}: {len(found)} Adam states in the checkpoint, expected 1")
    adam = found[0]
    return {"mu": adam["mu"], "nu": adam["nu"], "count": int(np.asarray(adam["count"]))}


def flax_state_kwargs(tree) -> dict:
    """`from_flax`'s arguments from a decoded JAX AgentState."""
    missing = {"feat_params", "feat_stats", "policy_params", "critic_params", "policy_target",
               "critic_target", "policy_opt", "critic_opt", "feat_opt",
               "update_step"} - set(tree)
    if missing:
        raise ValueError(f"not a JAX AgentState checkpoint: no {sorted(missing)}")
    kw = dict(
        feat_params=tree["feat_params"], feat_stats=tree["feat_stats"],
        policy_params=tree["policy_params"], critic_params=tree["critic_params"],
        policy_target=tree["policy_target"], critic_target=tree["critic_target"],
        policy_opt=_adam(tree["policy_opt"], "policy_opt"),
        critic_opt=_adam(tree["critic_opt"], "critic_opt"),
        encoder_opt=_adam(tree["feat_opt"]["encoder"], "feat_opt/encoder"),
        value_encoder_opt=_adam(tree["feat_opt"]["value_encoder"], "feat_opt/value_encoder"),
        update_step=int(np.asarray(tree["update_step"])))
    if tree.get("goal_params") is not None:
        kw.update(goal_params=tree["goal_params"], goal_stats=tree["goal_stats"],
                  goal_opt=_adam(tree["goal_opt"], "goal_opt"))
    return kw


def load_flax_agent(template: AgentState, path: str) -> AgentState:
    """The JAX package's snapshot at `path` as an AgentState shaped and
    placed as `template` (its config and device)."""
    if template.cfg is None:
        raise ValueError("load_flax_agent: the template has no AgentConfig "
                         "(build it with create_agent_state or from_flax)")
    return from_flax(cfg=template.cfg, device=template.device,
                     **flax_state_kwargs(flax_msgpack.load(path)))
