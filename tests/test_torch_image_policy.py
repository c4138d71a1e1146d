"""The image agent's BC update and `select_action` against the JAX
package, from a common state with carried Adam moments (one JAX BC
update), on tests/test_image_mode.py's `image_batch`, within
tests/test_torch_learner.py's bounds; the encoders built with one
BasicBlock a stage in both packages, as tests/test_torch_image_agent.py
builds them for the DDPG update."""

import jax
import numpy as np
import pytest
import torch

from gaddpg_tpu.agents import bc as jax_bc
from gaddpg_tpu.agents import ddpg as jax_ddpg
from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu_torch.agents import (
    AgentConfig, create_agent_state, make_bc_update, make_select_action,
)
from test_torch_image_agent import CFG, image_batch_np
from test_torch_learner import _check_metrics, _check_moves, _check_stats, _torch_batch, port_state
from torch_image_common import S, jax_agent_state, shallow_resnet


@pytest.fixture(scope="module")
def jax_bc_resumed():
    """(jitted JAX BC update, a JAX image state after one update of it from
    the port's initial weights), traced with the shallow encoders."""
    with pytest.MonkeyPatch.context() as mp:
        shallow_resnet(mp)
        port = create_agent_state(AgentConfig(**CFG), generator=torch.Generator().manual_seed(4),
                                  device="cpu")
        update = jax.jit(jax_bc.make_bc_update(JaxAgentConfig(**CFG)))
        js = jax_agent_state(port, JaxAgentConfig(**CFG))
        return update, update(js, image_batch_np(12), jax.random.PRNGKey(13))[0]


def test_image_bc_update_matches_jax(jax_bc_resumed, monkeypatch):
    """One BC update from the carried-over state: the policy and its
    encoder move within test_torch_learner.py's BC bounds, the critic
    side not at all [policy 0, encoder 3.0e-6]."""
    shallow_resnet(monkeypatch)
    update, js = jax_bc_resumed
    batch = image_batch_np(30)
    after, want = update(js, batch, jax.random.PRNGKey(0))
    cfg = AgentConfig(**CFG)
    port = port_state(js, cfg)
    got = make_bc_update(cfg, device="cpu")(port, _torch_batch(batch))
    _check_metrics(got, want)
    assert port.update_step == int(after.update_step) == 2
    _check_stats(port, after)
    _check_moves(port, js, after, cfg,
                 {"policy": (0.1, 2e-3), "encoder": (0.1, 5e-3), "value_encoder": (0.0, 0.0),
                  "critic": (0.0, 0.0), "policy_target": (0.0, 0.0),
                  "critic_target": (0.0, 0.0)})


def test_select_action_from_an_image(jax_bc_resumed, monkeypatch):
    """Actions and aux predictions of the eval-mode policy on RGBDM images,
    against JAX's `select_action` without noise."""
    shallow_resnet(monkeypatch)
    _, js = jax_bc_resumed
    cfg = AgentConfig(**CFG)
    img = np.random.RandomState(4).uniform(0, 1, (3, 5, S, S)).astype(np.float32)
    remain = np.full((3,), 5.0, np.float32)
    select = jax_ddpg.make_select_action(JaxAgentConfig(**CFG))
    want_a, want_aux = jax.jit(lambda st, im, t: select(st, im, t, jax.random.PRNGKey(1)))(
        js, img, remain)
    got_a, got_aux = make_select_action(cfg, device="cpu")(
        port_state(js, cfg), torch.from_numpy(img), torch.from_numpy(remain))
    assert got_a.shape == (3, 6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), rtol=1e-5, atol=1e-6)
