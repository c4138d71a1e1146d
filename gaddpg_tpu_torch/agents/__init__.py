"""Agents: configuration, state, losses, action selection and the DDPG
and BC updates."""

from gaddpg_tpu_torch.agents.bc import make_bc_update
from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.agents.ddpg import (
    exploration_noise, extract_feature, make_ddpg_update, make_select_action, mix_ratios,
)
from gaddpg_tpu_torch.agents.state import AgentState, create_agent_state, from_flax

__all__ = [
    "AgentConfig", "AgentState", "create_agent_state", "exploration_noise",
    "extract_feature", "from_flax", "make_bc_update", "make_ddpg_update",
    "make_select_action", "mix_ratios",
]
