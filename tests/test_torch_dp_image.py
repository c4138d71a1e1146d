"""Image mode under the data-parallel mesh on 2 gloo ranks of the CPU
(the sharded updates against JAX are in test_torch_dp_image_update.py):

- `ImageFeature`'s train forward, both encoders, with the batch split
  over the ranks, against the one-rank forward on the whole batch: the
  outputs and every BatchNorm's statistics within 1e-5 (rtol and atol),
  the gradients of sum(output^2) (each rank's image rows, the ranks'
  summed parameter gradients) within 1e-4 of each leaf's largest, as
  tests/test_torch_dp_stats.py holds K5, K6 and the FC trunk. The
  negative control, per-rank statistics, is refused by the same rule.
- One image `Trainer` iteration (use_image, domain_rand, a 32 x 32
  camera) at the fast dry-run tier's sizes (8 envs, batch 4, a ring of
  64) against the port's one-rank Trainer with the same seed, by
  tests/test_torch_dp_train.py's rules; the ring's frames, gathered from
  the ranks, equal the one-rank ring's bit for bit; one evaluation wave
  of the updated policy gives the one-rank success rate.
"""

import numpy as np
import pytest

from gaddpg_tpu_torch.parallel import launch
from test_torch_dp_train import (
    SIZES, WORLD, check_actions_and_points, check_ring, check_rollout, check_update,
)
from torch_dp_ranks import image_feature_rank, image_trainer_rank
from torch_image_common import S

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
LAUNCH_S = 300.0
B = 8


def _arrays(seed=20):
    rng = np.random.RandomState(seed)
    return {"image": rng.uniform(0.0, 1.0, (B, 5, S, S)).astype(np.float32),
            "action": rng.uniform(-0.1, 0.1, (B, 6)).astype(np.float32), "seed": seed}


def _off(ranks, whole):
    """Failures of the rule, as messages (empty when the ranks pass)."""
    bad = []

    def close(name, got, want):
        try:
            np.testing.assert_allclose(got, want, **TOL)
        except AssertionError as e:
            bad.append(f"{name}: {str(e).splitlines()[3:5]}")

    for path, want in whole.items():
        close(f"{path} out", np.concatenate([r[path]["out"] for r in ranks]), want["out"])
        for r in ranks:
            for i, ((m, v), (wm, wv)) in enumerate(zip(r[path]["stats"], want["stats"],
                                                       strict=True)):
                close(f"{path} mean {i}", m, wm)
                close(f"{path} var {i}", v, wv)
        for i, w in enumerate(want["grads"]):
            parts = [r[path]["grads"][i] for r in ranks]
            # image rows are each rank's own; parameter gradients are shares
            got = np.concatenate(parts) if i == 0 else np.sum(parts, axis=0)
            scale = max(float(np.abs(w).max()), 1e-30)
            if np.abs(got - w).max() > GRAD_REL * scale:
                bad.append(f"{path} grad {i}: {np.abs(got - w).max() / scale:.2e} of its largest")
    return bad


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """(the ranks reduced across, the ranks with per-rank statistics), from
    one launch each."""
    arrays = _arrays()
    return tuple(launch(image_feature_rank, WORLD, args=(arrays, reduce),
                        devices=["cpu"] * WORLD,
                        rendezvous_dir=tmp_path_factory.mktemp(f"rdv{int(reduce)}"),
                        timeout_s=LAUNCH_S) for reduce in (True, False))


@pytest.fixture(scope="module")
def whole():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return image_feature_rank(None, _arrays())
    finally:
        torch.set_num_threads(threads)


def test_image_feature_split_matches_whole_batch(split, whole):
    """Half the images on each of 2 ranks == the whole batch in one
    process: both encoders' outputs, the 20 BatchNorms' statistics each,
    the gradients (through the global statistics in the backward)."""
    ranks, _ = split
    assert len(whole["policy"]["stats"]) == 20
    bad = _off(ranks, whole)
    assert not bad, bad


def test_image_per_rank_batchnorm_is_refused(split, whole):
    """The negative control: each rank normalising with its own images'
    statistics is another model, and the rule above refuses it."""
    _, per_rank = split
    bad = _off(per_rank, whole)
    assert any(" mean " in b or " var " in b for b in bad), bad


@pytest.fixture(scope="module")
def iteration(tmp_path_factory):
    """(the 2 ranks' image iteration, the one-rank one on one CPU thread,
    their evaluation success rates)."""
    import torch

    ranks = launch(image_trainer_rank, WORLD, args=(SIZES, str(tmp_path_factory.mktemp("out"))),
                   devices=["cpu"] * WORLD, rendezvous_dir=tmp_path_factory.mktemp("rdv"),
                   timeout_s=LAUNCH_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = image_trainer_rank(None, SIZES, str(tmp_path_factory.mktemp("one")))
    finally:
        torch.set_num_threads(threads)
    # as tests/test_torch_dp_train.py's checks take them, then the success rates
    return [r[:6] for r in ranks], one[:6], [r[6] for r in ranks], one[6]


def test_image_iteration_rollout_and_ring(iteration):
    ranks, one, _, _ = iteration
    check_rollout(one, ranks)
    check_ring(one, ranks)
    check_actions_and_points(one, ranks)


def test_image_iteration_frames_bit_for_bit(iteration):
    """The frames the ranks stored, gathered, equal the one-rank ring's,
    bfloat16 bit for bit (they moved as bytes)."""
    ranks, one, _, _ = iteration
    n = one[0]["buffer_idx"]
    frames = one[1]["image_state"][:n]
    assert frames.shape[1:] == (5, S, S) and (frames[:, 4] == 0).any()
    for _, ring, *_ in ranks:
        np.testing.assert_array_equal(ring["image_state"][:n], frames)


def test_image_iteration_update(iteration):
    """train_iter on the sharded frames: finite metrics, update_step 1,
    every rank's state bit-identical; then the policy evaluated on each
    rank's share of a wave gives the one-rank run's success rate."""
    ranks, one, rates, rate = iteration
    check_update(one, ranks)
    assert rates == [rate] * len(ranks)
