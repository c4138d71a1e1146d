"""Agents: configuration, state, losses, action selection and the DDPG
and BC updates."""

from gaddpg_tpu_torch.agents.bc import bc_update, make_bc_update
from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.agents.ddpg import (
    ddpg_update, exploration_noise, extract_feature, make_ddpg_update, make_select_action,
    mix_ratios,
)
from gaddpg_tpu_torch.agents.state import (
    AgentState, create_agent_state, from_flax, multistep_lr,
)

__all__ = [
    "AgentConfig", "AgentState", "bc_update", "create_agent_state", "ddpg_update",
    "exploration_noise", "extract_feature", "from_flax", "make_bc_update", "make_ddpg_update",
    "make_select_action", "mix_ratios", "multistep_lr",
]
