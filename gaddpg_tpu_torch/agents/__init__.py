"""Agents: configuration, state and action selection (the serving path)."""

from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.agents.ddpg import exploration_noise, extract_feature, make_select_action
from gaddpg_tpu_torch.agents.state import AgentState, create_agent_state, from_flax

__all__ = [
    "AgentConfig", "AgentState", "create_agent_state", "exploration_noise",
    "extract_feature", "from_flax", "make_select_action",
]
