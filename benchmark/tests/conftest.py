"""Shared fixtures of the benchmark's tests: the repository on ``sys.path``,
the ``card`` marker, and cells cut to a size the CPU runs in seconds.

Run them from the repository root: ``python -m pytest benchmark/tests -q``.
Tests marked ``card`` need a CUDA card and skip without one; they decide
so inside the test (the ``card`` fixture), never at import.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# sizes a CPU run holds: the same networks at full width and depth, on a
# few small frames
TINY_TRAIN = {"frames": 12, "batch": 2}
TINY_SIZE = {"mc": [32, 48], "midas2": [64, 64]}


def tiny(cell):
    """``cell`` cut to TINY_* in place; returns it."""
    cell.traffic.update(TINY_TRAIN)
    cell.config["size"] = TINY_SIZE[cell.config["name"]]
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark.harness import spec

    return lambda name: tiny(spec.load_cell(name))
