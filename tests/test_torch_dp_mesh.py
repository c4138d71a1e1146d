"""The data-parallel mesh (gaddpg_tpu_torch/parallel): the counterparts
of tests/test_mesh.py's TestMakeMesh (the rank count asked for, the
divisibility guard, Trainer's early refusal), the collectives on 2 gloo
ranks, and `launch` failing, within its timeout, when a rank raises.
"""

import time

import numpy as np
import pytest
import torch

from gaddpg_tpu_torch.parallel import (
    Mesh, RankFailure, init_mesh, launch, make_mesh, make_sharded_update,
    validate_dp_divisibility,
)
from torch_dp_ranks import mesh_checks, raise_on_one

WORLD = 2
LAUNCH_S = 60.0


def _bf16_bits(rank):
    """Rank `rank`'s bfloat16 rows of mesh_checks, as their int16 bits."""
    from torch_dp_ranks import bf16_rows

    return bf16_rows(rank).view(torch.int16).numpy()


def _cpu_mesh(world, rank=0):
    """A mesh object for the checks that run before any collective."""
    return Mesh(world=world, rank=rank, device=torch.device("cpu"))


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    return launch(mesh_checks, WORLD, devices=["cpu"] * WORLD,
                  rendezvous_dir=tmp_path_factory.mktemp("rdv"), timeout_s=LAUNCH_S)


def test_mesh_uses_requested_ranks(checks):
    assert [c["world"] for c in checks] == [WORLD] * WORLD


def test_raises_when_ranks_differ(checks):
    """make_mesh never truncates or pads: another count than the group's
    raises, and so does a mesh asked for without a process group."""
    for c in checks:
        assert f"requested a {WORLD + 1}-rank mesh" in c["too_many"]
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(WORLD)


def test_raises_when_too_few_cards(monkeypatch, tmp_path):
    """A rank asked onto a card that is not there raises before it joins."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 card"):
        init_mesh(2, 1, "cuda:1", "file://" + str(tmp_path / "rdv"))


def test_divisibility_guard():
    mesh = _cpu_mesh(8)
    validate_dp_divisibility(mesh, num_envs=16, batch_size=64)  # ok
    validate_dp_divisibility(None, num_envs=13)  # no mesh -> no-op
    with pytest.raises(ValueError, match=r"num_envs=12 \(12 % 8 = 4\)"):
        validate_dp_divisibility(mesh, num_envs=12, batch_size=64)


def test_trainer_rejects_indivisible_num_envs(monkeypatch):
    """Trainer fails on shapes that cannot shard evenly before it builds
    anything: neither the library nor the env is touched."""
    from gaddpg_tpu_torch.train import loop
    from gaddpg_tpu_torch.train.config import load_config

    def built(*_, **__):
        raise AssertionError("Trainer built something before checking its sizes")

    monkeypatch.setattr(loop, "library_from_index", built)
    monkeypatch.setattr(loop, "PandaGraspEnv", built)
    cfg = load_config(overrides={"num_envs": 12, "batch_size": 8, "buffer_size": 64,
                                 "output_dir": "output/test_guard"}, policy="BC")
    with pytest.raises(ValueError, match="num_envs=12"):
        loop.Trainer(cfg, mesh=_cpu_mesh(8), device="cpu")


def test_all_reduce_sum_and_its_backward(checks):
    """y = sum_r x_r^2 with x_r = r + 1 on every rank; each rank's loss
    y . (0, 1, 2) sends every rank the summed cotangent back."""
    for r, c in enumerate(checks):
        np.testing.assert_array_equal(c["sum"], [5.0] * 3)
        np.testing.assert_array_equal(c["sum_grad"], 2.0 * (r + 1) * WORLD * np.arange(3.0))


def test_bfloat16_moves_as_bytes(checks):
    """bfloat16 rows (the ring's frames) gathered and exchanged bit for
    bit, -0.0, infinities and subnormals included; a bfloat16 sum is
    refused."""
    for q, c in enumerate(checks):
        want = [_bf16_bits(r) for r in range(WORLD)]
        np.testing.assert_array_equal(c["bf16_gather"], np.concatenate(want))
        np.testing.assert_array_equal(c["bf16_all_to_all"],
                                      np.concatenate([w[q:q + 1] for w in want]))
        assert "bfloat16" in c["bf16_sum"]


def test_rows_move_between_ranks(checks):
    for q, c in enumerate(checks):
        want = np.concatenate([np.full((r + 1, 2), 100.0 * r + q) for r in range(WORLD)])
        np.testing.assert_array_equal(c["all_to_all"], want)
        np.testing.assert_array_equal(c["gather"], [[r] for r in range(WORLD)])


def test_replicate_places_rank_zero_everywhere(checks):
    for c in checks:
        np.testing.assert_array_equal(c["replicated"][0], [0.0, 0.0])
        np.testing.assert_array_equal(c["replicated"][1], [0])
        assert "1 rank(s) built values other than rank 0's" in c["replicate_check"]


def test_draws_are_the_global_batch_sliced(checks):
    full = torch.rand((2 * WORLD, 3), generator=torch.Generator().manual_seed(0)).numpy()
    for r, c in enumerate(checks):
        np.testing.assert_array_equal(c["draw"], full[2 * r:2 * r + 2])


def test_sharded_update_needs_an_update_built_for_its_mesh():
    from gaddpg_tpu_torch.agents import AgentConfig, make_ddpg_update

    with pytest.raises(ValueError, match="mesh="):
        make_sharded_update(make_ddpg_update(AgentConfig(), "cpu"), _cpu_mesh(2))


def test_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 raises while rank 0 blocks in a collective: launch raises
    with rank 1's traceback well within its timeout, and no rank is left
    running."""
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 fails on purpose"):
        launch(raise_on_one, WORLD, devices=["cpu"] * WORLD, rendezvous_dir=tmp_path,
               timeout_s=LAUNCH_S)
    assert time.monotonic() - t0 < LAUNCH_S / 2


def test_dryrun_exits_nonzero_when_a_tier_fails(monkeypatch, capsys):
    """Both tiers run; the flagship tier's failure is reported and the dry
    run exits 1 (the JAX dry run swallows it, `__graft_entry__.py:58-62`)."""
    from gaddpg_tpu_torch.parallel import dryrun

    def tier(fn, world, args=(), **_):
        if args[0]:  # flagship
            raise RankFailure("rank 0 failed:\nthe flagship tier fails on purpose")
        return [None] * world

    monkeypatch.setattr(dryrun, "launch", tier)
    monkeypatch.setattr(dryrun, "build_flagship_library", lambda path: path)
    assert dryrun.main(["--ranks", str(WORLD), "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert f"DRYRUN_FLAGSHIP_FAILED ranks={WORLD}" in out and f"DRYRUN_OK ranks={WORLD}" in out
