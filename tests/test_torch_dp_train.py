"""The data-parallel train iteration: the fast dry-run tier's Trainer
(`__graft_entry__._dryrun_impl`'s configuration at the sizes of a 4-rank
dry run: 8 envs, batch 4, a ring of 64) on 2 gloo ranks against the
port's one-rank Trainer with the same seed: the counterpart of
tests/test_mesh.py::test_fused_iteration_matches_single_device, with its
rules (the one-rank Trainer is held against JAX in
tests/test_torch_train.py):

- equal buffer_idx, rollout_success and valid_scene_frac;
- the ring's reward, returns, episode_map, timestep, expert_flags and
  terminal within 1e-5;
- under 25% of action elements off by more than 1e-4, the point states'
  median within 1e-4;
- finite train_iter metrics, update_step 1 on both, every rank's agent
  state bit-identical, and the ring's points spread over the ranks.
"""

import math

import numpy as np
import pytest

from gaddpg_tpu_torch.parallel import launch
from torch_dp_ranks import trainer_rank

WORLD = 2
SIZES = 4  # the dry run's sizes for 4 ranks: 8 envs, batch 4, a ring of 64
RING_FIELDS = ("reward", "returns", "episode_map", "timestep", "expert_flags", "terminal")
LAUNCH_S = 300.0


def check_rollout(one, ranks, require_transitions=True):
    """Equal buffer_idx, rollout_success and valid_scene_frac on every
    rank, and each rank holding its share of the ring's points."""
    ref = one[0]
    assert ref["buffer_idx"] > 0 or not require_transitions
    for roll, *_, slots in ranks:
        for k in ("buffer_idx", "rollout_success", "valid_scene_frac"):
            assert roll[k] == ref[k], k
        assert slots == len(one[1]["episode_map"]) // len(ranks)


def check_ring(one, ranks, fields=RING_FIELDS):
    n = one[0]["buffer_idx"]
    for r, (_, ring, *_) in enumerate(ranks):
        for k in fields:
            np.testing.assert_allclose(ring[k][:n], one[1][k][:n], atol=1e-5,
                                       err_msg=f"rank {r} ring {k}")


def check_actions_and_points(one, ranks):
    n, ref = one[0]["buffer_idx"], one[1]
    for _, ring, *_ in ranks:
        off = float(np.mean(np.abs(ring["action"][:n] - ref["action"][:n]) > 1e-4))
        assert off < 0.25, f"{off:.0%} of action elements diverged"
        assert float(np.median(np.abs(ring["point_state"][:n] - ref["point_state"][:n]))) < 1e-4


def check_update(one, ranks):
    """Finite metrics with the one rank's keys, update_step 1, and every
    rank's agent state rank 0's bit for bit."""
    for _, _, metrics, step, tensors, _ in ranks:
        assert one[2] and metrics and set(metrics) == set(one[2])
        assert all(math.isfinite(v) for v in metrics.values()), metrics
        assert step == one[3] == 1
        assert all(np.array_equal(a, b) for a, b in zip(tensors, ranks[0][4], strict=True))


def one_rank_run(out_dir, flagship=False, library_path=None):
    """The one-rank Trainer in this process, on one CPU thread as each
    rank runs."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return trainer_rank(None, SIZES, flagship, out_dir, library_path)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(trainer_rank, WORLD, args=(SIZES, False, str(tmp_path_factory.mktemp("out"))),
                  devices=["cpu"] * WORLD, rendezvous_dir=tmp_path_factory.mktemp("rdv"),
                  timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return one_rank_run(str(tmp_path_factory.mktemp("one")))


def test_rollout_stats_equal(ranks, one_rank):
    check_rollout(one_rank, ranks)


def test_ring_fields_match(ranks, one_rank):
    check_ring(one_rank, ranks)


def test_actions_and_points_match(ranks, one_rank):
    check_actions_and_points(one_rank, ranks)


def test_sharded_update_runs(ranks, one_rank):
    check_update(one_rank, ranks)


def test_resume_and_evaluate_on_ranks(tmp_path):
    """`load_pretrained` on 2 ranks: rank 0 reads the snapshot and every
    rank holds it bit for bit; `evaluate` with the policy on fresh scenes
    and with the expert on a scene set gives the one-rank run's success
    rates."""
    import torch

    from gaddpg_tpu_torch.agents.state import state_counts, state_tensors
    from gaddpg_tpu_torch.envs.scenes import generate_scenes
    from gaddpg_tpu_torch.parallel.dryrun import tier_config, tier_library
    from gaddpg_tpu_torch.train.checkpoints import save_agent
    from gaddpg_tpu_torch.train.loop import Trainer
    from torch_dp_ranks import restore_and_evaluate_rank

    tr = Trainer(tier_config(SIZES, str(tmp_path / "src")), lib=tier_library(False),
                 device="cpu")
    with torch.no_grad():  # a state no rank builds from the seed
        for t in state_tensors(tr.agent_state):
            if t.is_floating_point():
                t.add_(0.01)
    tr.agent_state.update_step = 7
    save_agent(tr.agent_state, str(tmp_path / "snap"))
    scenes = generate_scenes(tr.env, tr.cfg.num_envs, generator=torch.Generator().manual_seed(4))
    args = (SIZES, str(tmp_path / "out"), str(tmp_path / "snap"), scenes)
    ranks = launch(restore_and_evaluate_rank, WORLD, args=args, devices=["cpu"] * WORLD,
                   rendezvous_dir=tmp_path, timeout_s=LAUNCH_S)
    one = restore_and_evaluate_rank(None, *args)
    for tensors, counts, policy, expert in ranks:
        assert counts == one[1] == state_counts(tr.agent_state) and counts[0] == 7
        assert all(np.array_equal(a, b) for a, b in zip(tensors, one[0], strict=True))
        assert (policy, expert) == one[2:]
