"""``correct`` comes out false when the timed path is broken underneath:
the harness's run on the CPU at the tiny cells (the look for a card
skipped), once for each fault the cell can have, planted by the cell's
system's ``PATCHES`` as ``run.py --patch <name>`` plants it on the card."""

import pytest

import tiny

CHAIN_FAULTS = ("altered_answer", "half_batch", "salience_altered", "f0_shifted")
TRAIN_FAULTS = ("unchanged_state", "half_batch", "altered_answer")


@pytest.mark.parametrize("fault", CHAIN_FAULTS)
def test_chain_fault_is_not_correct(tree, fault):
    out = tiny.result(tiny.run_cpu(tree, "tiny.chain", patch=fault))
    assert out["correct"] is False


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_train_fault_is_not_correct(tree, fault):
    out = tiny.result(tiny.run_cpu(tree, "tiny.train", patch=fault))
    assert out["correct"] is False


def test_sound_runs_are_correct(tree):
    for cell in ("tiny.chain", "tiny.train"):
        assert tiny.result(tiny.run_cpu(tree, cell, seed=2 ** 31 + 11))["correct"] is True
