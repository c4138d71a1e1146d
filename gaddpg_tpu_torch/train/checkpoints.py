"""Checkpoint save/load of an AgentState (counterpart of
gaddpg_tpu/train/checkpoints.py, in the port's own format).

One `torch.save` file per snapshot, `agent_{surfix}.pt` (`agent_latest`,
`agent_epoch_N`), holding every module's parameters and BatchNorm
statistics (the encoders, the heads and their targets, the GoalFeature),
each optimizer's Adam moments and count (the GoalFeature's too), and the
update step. The JAX package's
`.msgpack` checkpoints are not read here; `agents.state.from_flax`
carries a JAX state's trees across.
"""

import os
from typing import Optional

import torch

from gaddpg_tpu_torch.agents.state import AgentState

MODULES = ("feat", "policy", "critic", "policy_target", "critic_target", "goal")


def checkpoint_path(output_dir: str, surfix: str = "latest") -> str:
    return os.path.join(output_dir, f"agent_{surfix}.pt")


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
    values, or None when there is no snapshot."""
    path = checkpoint_path(output_dir, surfix)
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
