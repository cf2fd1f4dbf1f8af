"""The controls, at a size a test run holds: the reference in the
program's place in the next lower precision fails the cell's limits
through the harness's own comparison.  On the card, at the cells' own
sizes: ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds 1
--trace 0 --patch fp8`` (the chain) or ``--patch tf32`` (training)."""

import pytest

import tiny


@pytest.mark.parametrize("seed", [31, 32])
def test_chain_fp8_control_is_not_correct(tree, seed):
    out = tiny.result(tiny.run_cpu(tree, "tiny.chain", seed=seed, patch="fp8"))
    assert out["correct"] is False


@pytest.mark.cuda
def test_train_tf32_control_is_not_correct(tree, card):
    out = tiny.result(tiny.run_cpu(tree, "tiny.train", seed=31, patch="tf32", device="cuda"))
    assert out["correct"] is False
