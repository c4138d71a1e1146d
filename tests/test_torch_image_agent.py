"""The image agent's DDPG update (`AgentConfig(use_image=True)`: ResNet
encoders on RGBDM images) against the JAX package: one update from a
common state on tests/test_image_mode.py's `image_batch`, within
tests/test_torch_learner.py's bounds. The BC update and `select_action`
are held in tests/test_torch_image_policy.py, the loop in
test_torch_image_loop.py.

The JAX state is built from the port's initial weights (the ResNet trees
through `Conv_0`, `BatchNorm_0`, `BasicBlock_i/{Conv,BatchNorm}_j`), one
JAX update gives it Adam moments, and `from_flax` carries it back, as
tests/test_torch_learner.py does. `image_batch` makes every row an
expert success, so the delayed actor term has no rows: its bounds are
those of an update with the actor term off. Both packages build their
encoders with one BasicBlock a stage (torch_image_common.SHALLOW): the
update's logic does not depend on the depth, and the JAX update traces
and compiles in half the time.
"""

import jax
import numpy as np
import pytest
import torch

from gaddpg_tpu.agents import ddpg as jax_ddpg
from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu_torch.agents import AgentConfig, create_agent_state, make_ddpg_update
from gaddpg_tpu_torch.models import ImageFeature
from test_image_mode import image_batch
from test_torch_learner import (
    CRITIC_PHASE, UPDATES, _check_metrics, _check_moves, _check_stats, _torch_batch, port_state,
)
from torch_image_common import S, jax_agent_state, shallow_resnet

B = 4
CFG = dict(use_image=True, image_size=S, batch_size=B, target_update_interval=1)


def image_batch_np(seed, batch=B):
    return {k: np.asarray(v) for k, v in image_batch(batch, jax.random.PRNGKey(seed)).items()}


@pytest.fixture(scope="module")
def jax_resumed():
    """(jitted JAX DDPG update, a JAX image state after one update of it
    from the port's initial weights: carried Adam moments), traced with
    the shallow encoders."""
    with pytest.MonkeyPatch.context() as mp:
        shallow_resnet(mp)
        port = create_agent_state(AgentConfig(**CFG), generator=torch.Generator().manual_seed(3),
                                  device="cpu")
        assert isinstance(port.feat, ImageFeature) and port.critic.q1_l1.in_features == 519
        update = jax.jit(jax_ddpg.make_ddpg_update(JaxAgentConfig(**CFG)))
        js = jax_agent_state(port, JaxAgentConfig(**CFG))
        return update, update(js, image_batch_np(10), jax.random.PRNGKey(11))[0]


def test_image_ddpg_update_matches_jax(jax_resumed, monkeypatch):
    """One DDPG update from the carried-over JAX state (update_step 1):
    metrics, running statistics and every group's moves within
    tests/test_torch_learner.py's bounds of an update with the actor term
    off."""
    shallow_resnet(monkeypatch)
    update, js = jax_resumed
    step, _, bounds = UPDATES["resumed"]
    batch, key = image_batch_np(20), jax.random.PRNGKey(21)
    after, want = update(js, batch, key)
    draws = np.array(jax.random.uniform(jax.random.split(key)[0], (B, 6)))
    cfg = AgentConfig(**CFG)
    port = port_state(js, cfg)
    got = make_ddpg_update(cfg, device="cpu")(port, _torch_batch(batch),
                                              noise_draws=torch.from_numpy(draws))
    assert float(got["actor_critic_loss"]) == 0.0 and float(got["critic_loss"]) > 0.0
    _check_metrics(got, want)
    assert port.update_step == int(after.update_step) == step + 1
    _check_stats(port, after)
    _check_moves(port, js, after, cfg, {**CRITIC_PHASE, **bounds})
