"""The measurement path fails without a card and has no CPU fallback, and
fails in a checkout that holds the benchmark alone."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec

ARGS = ["--workload", "mc-finetune-f32", "--seed", "1", "--seconds", "1",
        "--trace", "0"]


def _run(root, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *ARGS], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(spec.REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
