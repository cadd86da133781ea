"""The control, the plain reference in the program's place computed in the
nearest precision below the cell's (TF32 for f32 with TF32 off), reads ``correct`` false: at a tiny size on the CPU, and on the card
at the cell's own size on three seeds."""

from __future__ import annotations

import pytest

from benchmark.harness import runner, spec

CONTROL = {"f32": "tf32"}
CELLS = ["mc-finetune-f32", "midas2-finetune-f32", "mc-eval-f32"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_not_correct(name, tiny_cell):
    cell = tiny_cell(name)
    out = runner.run_cell(cell, 2 ** 31 + 31, 0.1, False, "cpu",
                          rounding=CONTROL[cell.precision])
    assert out.result["correct"] is False, out.result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name, card):
    # the cell's own sizes; a short window where the check samples it
    seconds = {"train": 0.1, "eval": 5.0}
    for seed in (2 ** 31 + 41, 42, 43):
        cell = spec.load_cell(name)
        out = runner.run_cell(cell, seed, seconds[cell.entry.KIND], False,
                              card, rounding=CONTROL[cell.precision])
        assert out.result["correct"] is False, (seed, out.result["checks"])
