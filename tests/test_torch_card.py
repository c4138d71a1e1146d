"""Tests that need a CUDA card (marker `card`); each skips without one.
They import no JAX, so they run where the port runs:

    python -m pytest --noconftest -m card tests/test_torch_card.py

The seed-27 tests hold the model scale 2 DDPG update of the batch in
data/scale2_seed27.pt, card against CPU, to chip_smoke.py's nudge rule
(`crossing_verdict`): a parameter group whose moves cross their bound
passes only if one of 16 CPU updates on one-ulp nudges of the batch's
point states crosses the same bound and the card's count of moves off is
within 1% of the count of one that crosses.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    crossing_threads, crossing_verdict, move_offs, nudge_spreads, scaled_pooled,
)
from gaddpg_tpu_torch.agents import (  # noqa: E402
    AgentConfig, create_agent_state, make_ddpg_update,
)
from gaddpg_tpu_torch.ops import sa_train  # noqa: E402

DATA = Path(__file__).with_name("data")
SEED = 27
# the negative control: K5's pooled output scaled by (1 + K5_CONTROL_EPS),
# the smallest of 1e-2, 3e-3, 1e-3 that the rule refuses on the batches of
# chip_smoke.py's seeds 0-7 and 27 (chip_smoke.py --k5-scale; H100, 700 W:
# 1e-2 is refused on 7 of the 9 seeds, 3e-3 on 3, 1e-3 on seed 27 alone)
K5_CONTROL_EPS = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def seed27():
    """The CPU side of seed 27's update (chip_smoke.py --scale2-seeds 27,
    saved with its target-smoothing draws): the common state (one CPU
    update on the batch before, update_step back to 0 so that the actor
    term is on), the CPU update from it, and the moves off of the CPU
    updates on one-ulp nudges of the batch's point states, as
    chip_smoke.py computes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = torch.load(DATA / f"scale2_seed{SEED}.pt")
    batches, draws = data["batches"], data["draws"]
    cfg = AgentConfig(feature_dim=1024, target_update_interval=1, collision_aux_weight=0.1,
                      collision_demo_discount=0.5)
    state = create_agent_state(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    update_cpu = make_ddpg_update(cfg, device="cpu")
    with crossing_threads():
        update_cpu(state, batches[0], noise_draws=draws[0])
        state.update_step = 0
        start = state.to("cpu")
        update_cpu(state, batches[1], noise_draws=draws[1])
    spreads = nudge_spreads(cfg, update_cpu, start, state, batches[1], draws[1], SEED)
    return cfg, start, state, batches[1], draws[1], spreads


def card_update(card, seed27):
    """(moves off of the card's update against the CPU's, the nudges')."""
    cfg, start, cpu_state, batch, draws, spreads = seed27
    on_card = start.to(card)
    make_ddpg_update(cfg)(on_card, {k: v.to(card) for k, v in batch.items()},
                          noise_draws=draws.to(card))
    offs = move_offs(cfg, start, on_card, cpu_state)
    print(f"moves off, card vs CPU (off, of, bound): {offs}; nudges' value encoder: "
          f"{[sp['value_encoder'] for sp in spreads]}")
    return offs, spreads


@pytest.mark.card
def test_scale2_ddpg_update_seed27_card_vs_cpu(card, seed27):
    """The batch sits on a rounding tie of the reference arithmetic
    (ROADMAP.md Queue 3, not fault (h)). On the H100 (700 W) the card's
    update moves 124,875 of the value encoder's 5,571,456 elements off
    with K5/K6 in 3xTF32 (PR 7's kernels, unchanged since); with float32
    FFMA products it moved 123,686 (PR 8), against a bound of 0.2%. The
    CPU update itself, rerun on one-ulp nudges of the batch's point
    states, crossed the same bound on 7 of 16 with 123,689-123,790 (PR 8),
    and crosses on 6 of this fixture's 16 with 123,692-123,785. The card's
    count lies 0.88% above the nearest of those (the rule allows 1%): the
    event itself, plus K5's own 3xTF32 departure from the CPU, which moves
    up to 5,317 value-encoder elements off on batches with no tie (seed 5)
    and none with K5's plain version on the card (the next test)."""
    offs, spreads = card_update(card, seed27)
    verdict = crossing_verdict(offs, spreads)
    assert not verdict, f"{verdict}; moves off, card vs CPU (off, of, bound): {offs}"


@pytest.mark.card
def test_scale2_ddpg_update_seed27_with_plain_k5_on_the_card(card, seed27, monkeypatch):
    """The same update with K5's plain version in place of its kernel on
    the card (K1, K2, K6 and the rest as they run), held to the same rule.
    It falls on the CPU update's side of the tie: 0 of the value
    encoder's elements off (H100, 700 W), where PR 8's tree, with K6 on
    FFMA products, moved 123,682 (the event)."""
    monkeypatch.setattr(sa_train, "_sa_train_kernels", sa_train.sa_train_reference)
    offs, spreads = card_update(card, seed27)
    verdict = crossing_verdict(offs, spreads)
    assert not verdict, f"{verdict}; moves off, card vs CPU (off, of, bound): {offs}"


@pytest.mark.card
def test_scale2_seed27_rule_refuses_a_scaled_k5(card, seed27, monkeypatch):
    """The negative control: with K5's pooled output scaled by
    (1 + K5_CONTROL_EPS) the rule refuses the update (H100, 700 W: 125,282
    value-encoder elements off, 1.21% above the nearest crossing nudge)."""
    monkeypatch.setattr(sa_train, "_sa_train_kernels",
                        scaled_pooled(sa_train._sa_train_kernels, K5_CONTROL_EPS))
    offs, spreads = card_update(card, seed27)
    assert crossing_verdict(offs, spreads), f"accepted: {offs}, nudges {spreads}"
