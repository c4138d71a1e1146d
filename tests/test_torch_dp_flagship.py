"""The flagship dry-run tier's train iteration on 2 gloo ranks against
the port's one-rank Trainer with the same seed: the CHOMP planner
expert, two dynamic clutter bodies and a procedural library
(`build_proc_library(2, seed0=11)`, built once here and handed to the
ranks as a `save_library` file), at the sizes of a 4-rank dry run (8
envs, batch 4, a ring of 64): the counterpart of
tests/test_mesh.py::test_flagship_config_iteration_matches_single_device,
with its rules: equal buffer_idx, rollout_success and valid_scene_frac;
where transitions went in, the ring's reward, returns, episode_map and
terminal within 1e-5 and finite update metrics; the ring's points spread
over the ranks; every rank's agent state bit-identical.
"""

import pytest

from gaddpg_tpu_torch.parallel import launch
from gaddpg_tpu_torch.parallel.dryrun import build_flagship_library
from test_torch_dp_train import (
    LAUNCH_S, SIZES, WORLD, check_ring, check_rollout, check_update, one_rank_run,
)
from torch_dp_ranks import trainer_rank

FIELDS = ("reward", "returns", "episode_map", "terminal")


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    return build_flagship_library(str(tmp_path_factory.mktemp("lib") / "flagship.npz"))


@pytest.fixture(scope="module")
def ranks(library, tmp_path_factory):
    return launch(trainer_rank, WORLD,
                  args=(SIZES, True, str(tmp_path_factory.mktemp("out")), library),
                  devices=["cpu"] * WORLD, rendezvous_dir=tmp_path_factory.mktemp("rdv"),
                  timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def one_rank(library, tmp_path_factory):
    return one_rank_run(str(tmp_path_factory.mktemp("one")), True, library)


def test_flagship_rollout_stats_equal(ranks, one_rank):
    check_rollout(one_rank, ranks, require_transitions=False)


def test_flagship_ring_and_update(ranks, one_rank):
    if one_rank[0]["buffer_idx"] == 0:
        pytest.fail("no transition went in: the iteration's ring and update are untested")
    check_ring(one_rank, ranks, FIELDS)
    check_update(one_rank, ranks)
