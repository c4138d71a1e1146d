"""One DDPG update in bfloat16 (`AgentConfig(compute_dtype="bfloat16")`)
of the port against the JAX package's, by the rule of
tests/test_torch_bf16.py, from a state with carried Adam moments at
update_step 2 (the delayed actor term on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaddpg_tpu.agents import ddpg as jax_ddpg
from gaddpg_tpu_torch.agents import make_ddpg_update
from test_torch_bf16 import DTYPES, check_update, strict_jit
from test_torch_learner import B, CFG, _jax_fresh, make_batch


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("GADDPG_PALLAS_SA", "interpret")
    monkeypatch.setenv("GADDPG_PALLAS_SA_TRAIN", "interpret")


def test_ddpg_update_bf16_matches_jax():
    js = _jax_fresh(CFG)
    batch, key = make_batch(20), jax.random.PRNGKey(21)
    compiled = {dt: strict_jit(jax_ddpg.make_ddpg_update, dt, (js, batch, key))
                for dt in DTYPES}
    # carried Adam moments: one float32 update first (the same compile)
    resumed, _ = compiled["float32"](js, make_batch(10), jax.random.PRNGKey(11))
    resumed = resumed.replace(update_step=jnp.asarray(2, jnp.int32))
    draws = np.array(jax.random.uniform(jax.random.split(key)[0], (B, 6)))
    port = check_update("ddpg", resumed, jax_ddpg.make_ddpg_update, make_ddpg_update, batch,
                        key, compiled, noise_draws=torch.from_numpy(draws))
    assert port.update_step == 3
