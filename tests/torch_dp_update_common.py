"""The sharded updates against the JAX package's `make_sharded_update`
(tests/test_torch_dp_update.py on 2 ranks, test_torch_dp_update4.py on
4): the cases, the port's ranks launched beside JAX's compile, and the
checks.

DDPG starts from a JAX state with carried Adam moments (one JAX sharded
update on another batch) at update_step 2, so that the delayed actor
term is on; BC from a fresh state (its metrics read no updated
parameter). Both on one batch of 8 rows with every mask live, JAX's
target-smoothing draws injected, `from_flax` in each rank. The bounds
are tests/test_mesh.py's: metrics within rtol 1e-3 / atol 1e-4,
parameters and targets within atol 3e-3 (Adam's +-lr near zero,
ROADMAP.md Queue 3 (g)), but for the actor term: it reads the critic and
value encoder that the update has just stepped, so rounding in that step
moves it, in JAX itself by 1.3e-3 between 1 and 4 devices from carried
moments and 4.2e-3 from a fresh state (measured on this file's
batches). It is held at tests/test_torch_learner.py's bound for the
port's one-device actor term (1e-2), and every metric of the sharded
port within rtol 1e-4 of the port's own one-rank update, which shows
that sharding adds nothing to the gap. The running statistics are held
at test_torch_learner.py's bound. After the update every rank's
parameters, targets, Adam moments, running statistics and counts are
bit-identical.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaddpg_tpu.agents import bc as jax_bc
from gaddpg_tpu.agents import ddpg as jax_ddpg
from gaddpg_tpu.agents.config import AgentConfig as JaxAgentConfig
from gaddpg_tpu.parallel.mesh import make_mesh, make_sharded_update
from gaddpg_tpu_torch.agents import AgentConfig, make_bc_update, make_ddpg_update
from gaddpg_tpu_torch.parallel import launch
from test_torch_learner import (
    CFG, STATS, _adam, _groups, _jax_fresh, _leaf, _np, _torch_batch, make_batch, port_state,
)
from torch_dp_ranks import update_rank

METRIC = dict(rtol=1e-3, atol=1e-4)
AC_METRIC = dict(rtol=1e-2, atol=1e-4)  # tests/test_torch_learner.py UPDATES["resumed_actor"]
SELF_METRIC = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 3e-3
LAUNCH_S = 120.0


def state_kw(js):
    """`from_flax`'s arguments for a JAX state, as numpy trees."""
    return dict(
        feat_params=_np(js.feat_params), feat_stats=_np(js.feat_stats),
        policy_params=_np(js.policy_params), critic_params=_np(js.critic_params),
        policy_target=_np(js.policy_target), critic_target=_np(js.critic_target),
        policy_opt=_adam(js.policy_opt), critic_opt=_adam(js.critic_opt),
        encoder_opt=_adam(js.feat_opt["encoder"]),
        value_encoder_opt=_adam(js.feat_opt["value_encoder"]),
        update_step=int(js.update_step))


def _copy(tree):
    return jax.tree_util.tree_map(lambda x: x.copy(), tree)


@functools.lru_cache(maxsize=1)
def _fresh():
    """The fresh JAX state every case starts from (copied before use: the
    sharded update donates its state)."""
    return _jax_fresh(CFG)


class Case:
    """One update on `world` ranks: JAX's sharded run, the port's ranks
    (launched in a thread as soon as the start state exists, so that
    they run while JAX compiles) and the port's one-rank update."""

    def __init__(self, kind, world, rdv):
        self.kind, self.world = kind, world
        make = jax_ddpg.make_ddpg_update if kind == "ddpg" else jax_bc.make_bc_update
        self.jax_run = make_sharded_update(make(JaxAgentConfig(**CFG)), make_mesh(world))
        self.start = _copy(_fresh())
        self.draws = None
        if kind == "ddpg":
            resumed, _ = self.jax_run(_copy(self.start), make_batch(10), jax.random.PRNGKey(11))
            self.start = resumed.replace(update_step=jnp.asarray(2, jnp.int32))
            self.batch, self.key = make_batch(20), jax.random.PRNGKey(21)
            self.draws = np.array(jax.random.uniform(jax.random.split(self.key)[0],
                                                     (len(self.batch["time"]), 6)))
        else:
            self.batch, self.key = make_batch(30), jax.random.PRNGKey(0)
        self._thread = threading.Thread(target=self._launch, args=(rdv,))
        self._thread.start()

    def _launch(self, rdv):
        try:
            self._out = launch(update_rank, self.world,
                               args=(self.kind, CFG, state_kw(self.start), self.batch,
                                     self.draws),
                               devices=["cpu"] * self.world, rendezvous_dir=rdv,
                               timeout_s=LAUNCH_S)
        except Exception as e:  # noqa: BLE001 -- raised in the test
            self._out = e

    def ranks(self):
        self._thread.join()
        if isinstance(self._out, Exception):
            raise self._out
        return self._out

    def one_rank_port(self):
        cfg = AgentConfig(**CFG)
        state = port_state(self.start, cfg)
        batch = _torch_batch(self.batch)
        if self.kind == "bc":
            return make_bc_update(cfg, "cpu")(state, batch)
        return make_ddpg_update(cfg, "cpu")(state, batch,
                                            noise_draws=torch.from_numpy(self.draws))

    def check(self):
        after, want = self.jax_run(_copy(self.start), self.batch, self.key)
        if self.kind == "ddpg":
            assert float(want["actor_critic_loss"]) != 0.0  # the delayed actor term is on
        alone = self.one_rank_port()
        outs = self.ranks()
        metrics, tensors, leaves, stats, counts = outs[0]
        for other in outs[1:]:  # every rank's state is rank 0's, bit for bit
            assert other[4] == counts
            assert all(np.array_equal(a, b) for a, b in zip(other[1], tensors, strict=True))
        assert counts[0] == int(after.update_step)
        assert set(metrics) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(metrics[k], float(w), err_msg=k,
                                       **(AC_METRIC if k == "actor_critic_loss" else METRIC))
            np.testing.assert_allclose(metrics[k], float(alone[k]), **SELF_METRIC, err_msg=k)
        groups = _groups(after)
        for name, pairs in leaves.items():
            for path, got in pairs:
                np.testing.assert_allclose(got, _leaf(groups[name], path), rtol=0,
                                           atol=PARAM_ATOL, err_msg=f"{name} {path}")
        for name, pairs in stats.items():
            for path, got in pairs:
                np.testing.assert_allclose(got, _leaf(after.feat_stats[name], path), **STATS,
                                           err_msg=f"{name} {path}")
