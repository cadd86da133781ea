"""The output check catches a broken timed path: a run with the card's
look skipped (on the CPU, at a tiny size) and a fault planted under the
program's entry reads ``correct`` false, once for each fault the cell can
have. The one-card cells have no exchange between cards to leave out."""

from __future__ import annotations

import pytest

from benchmark.harness import faults, runner

CASES = [(cell, fault)
         for cell in ("mc-finetune-f32", "midas2-finetune-f32")
         for fault in ("unchanged", "half_batch", "altered")] + [
    ("mc-eval-f32", fault) for fault in ("half_batch", "altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_reads_not_correct(name, fault, tiny_cell):
    cell = tiny_cell(name)
    with faults.planted(fault):
        out = runner.run_cell(cell, 2 ** 31 + 23, 0.1, False, "cpu")
    assert out.result["correct"] is False, out.result["checks"]


def test_faults_are_lifted_after_the_block():
    from consistent_depth_tpu_torch.models.base import DepthModel
    from consistent_depth_tpu_torch.training import engine

    before = (DepthModel.apply, engine.joint_loss)
    with faults.planted("altered"):
        assert DepthModel.apply is not before[0]
    assert (DepthModel.apply, engine.joint_loss) == before
