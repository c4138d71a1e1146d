"""The sharded image DDPG and BC updates on 2 gloo ranks against the JAX
package's `make_sharded_update` on 2 virtual CPU devices, as
tests/torch_dp_update_common.py holds the point-cloud agent's: the
port's ranks start as soon as the start state exists and run while JAX
compiles.

DDPG starts from a state with carried Adam moments (one JAX sharded
update from the port's initial weights), BC from the fresh state, on
tests/test_image_mode.py's `image_batch` (every row an expert success,
so the delayed actor term has no rows), with the encoders at one
BasicBlock a stage in both packages (torch_image_common.SHALLOW). The
bounds are tests/test_torch_image_agent.py's and
tests/test_torch_image_policy.py's against JAX (metrics, running
statistics, every group's moves), and every metric within rtol 1e-4 of
the port's own one-rank update (ROADMAP.md Queue 3 (m)). Every rank's
parameters, targets, Adam moments, running statistics and counts are
bit-identical.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from gaddpg_tpu.agents import bc as jax_bc
from gaddpg_tpu.agents import ddpg as jax_ddpg
from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu.parallel.mesh import make_mesh, make_sharded_update
from gaddpg_tpu_torch.agents import (
    AgentConfig, create_agent_state, from_flax, make_bc_update, make_ddpg_update,
)
from gaddpg_tpu_torch.agents.state import state_counts, state_tensors
from gaddpg_tpu_torch.parallel import launch
from test_torch_image_agent import image_batch_np
from test_torch_learner import (
    CRITIC_PHASE, UPDATES, _check_metrics, _check_moves, _check_stats, _torch_batch,
)
from torch_dp_ranks import image_update_rank
from torch_dp_update_common import SELF_METRIC, _copy, state_kw
from torch_image_common import S, SHALLOW, jax_agent_state, shallow_resnet

WORLD = 2
B = 4
CFG = dict(use_image=True, image_size=S, batch_size=B, target_update_interval=1)
LAUNCH_S = 180.0
BOUNDS = {  # kind -> the moves' bounds (tests/test_torch_image_agent.py, _policy.py)
    "ddpg": {**CRITIC_PHASE, **UPDATES["resumed"][2]},
    "bc": {"policy": (0.1, 2e-3), "encoder": (0.1, 5e-3), "value_encoder": (0.0, 0.0),
           "critic": (0.0, 0.0), "policy_target": (0.0, 0.0), "critic_target": (0.0, 0.0)},
}


class ImageCase:
    """One image update on WORLD ranks: JAX's sharded run, the port's
    ranks (in a thread, started with the start state) and the port's
    one-rank update."""

    def __init__(self, kind, rdv, mp):
        self.kind = kind
        shallow_resnet(mp)
        make = jax_ddpg.make_ddpg_update if kind == "ddpg" else jax_bc.make_bc_update
        self.jax_run = make_sharded_update(make(JaxAgentConfig(**CFG)), make_mesh(WORLD))
        port = create_agent_state(AgentConfig(**CFG), generator=torch.Generator().manual_seed(3),
                                  device="cpu")
        self.start = jax_agent_state(port, JaxAgentConfig(**CFG))
        self.draws = None
        if kind == "ddpg":
            self.start, _ = self.jax_run(_copy(self.start), image_batch_np(10),
                                         jax.random.PRNGKey(11))
            self.batch, self.key = image_batch_np(20), jax.random.PRNGKey(21)
            self.draws = np.array(jax.random.uniform(jax.random.split(self.key)[0], (B, 6)))
        else:
            self.batch, self.key = image_batch_np(30), jax.random.PRNGKey(0)
        self.kw = state_kw(self.start)
        self._thread = threading.Thread(target=self._launch, args=(rdv,))
        self._thread.start()

    def _launch(self, rdv):
        try:
            self._out = launch(image_update_rank, WORLD,
                               args=(self.kind, CFG, self.kw, self.batch, self.draws, SHALLOW),
                               devices=["cpu"] * WORLD, rendezvous_dir=rdv, timeout_s=LAUNCH_S)
        except Exception as e:  # noqa: BLE001 -- raised in the test
            self._out = e

    def ranks(self):
        self._thread.join()
        if isinstance(self._out, Exception):
            raise self._out
        return self._out

    def check(self):
        cfg = AgentConfig(**CFG)
        after, want = self.jax_run(_copy(self.start), self.batch, self.key)
        alone = from_flax(cfg=cfg, device="cpu", **self.kw)
        batch = _torch_batch(self.batch)
        if self.kind == "ddpg":
            mine = make_ddpg_update(cfg, "cpu")(alone, batch,
                                                noise_draws=torch.from_numpy(self.draws))
        else:
            mine = make_bc_update(cfg, "cpu")(alone, batch)
        outs = self.ranks()
        metrics, tensors, _, _, counts = outs[0]
        for other in outs[1:]:  # every rank's state is rank 0's, bit for bit
            assert other[4] == counts
            assert all(np.array_equal(a, b) for a, b in zip(other[1], tensors, strict=True))
        got = from_flax(cfg=cfg, device="cpu", **self.kw)  # rank 0's state, in a port state
        with torch.no_grad():
            for t, a in zip(state_tensors(got), tensors, strict=True):
                t.copy_(torch.from_numpy(a))
        assert counts == state_counts(alone) and counts[0] == int(after.update_step)
        _check_metrics(metrics, want)
        for k, v in mine.items():
            np.testing.assert_allclose(metrics[k], float(v), **SELF_METRIC, err_msg=k)
        _check_stats(got, after)
        _check_moves(got, self.start, after, cfg, BOUNDS[self.kind])


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    # BC first: its ranks start at once and run while JAX compiles DDPG
    with pytest.MonkeyPatch.context() as mp:
        yield {kind: ImageCase(kind, tmp_path_factory.mktemp(kind), mp) for kind in ("bc", "ddpg")}


@pytest.mark.parametrize("kind", ["ddpg", "bc"])
def test_sharded_image_update_matches_jax(kind, cases):
    cases[kind].check()
