"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.harness import runner, spec


def test_forbidden_compares_whole_top_level_names():
    found = runner.forbidden_modules([
        "consistent_depth_tpu_torch", "consistent_depth_tpu_torch.ops",
        "consistent_depth_tpu", "consistent_depth_tpu.ops.losses",
        "jax", "jax.numpy", "jaxlib.xla_client", "flax", "jaxtyping",
        "benchmark.harness"])
    assert found == ["consistent_depth_tpu", "consistent_depth_tpu.ops.losses",
                     "flax", "jax", "jax.numpy", "jaxlib.xla_client"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in runner.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "__future__", "typing"), \
                (path, name)


def test_a_run_loads_no_jax():
    """A whole run of a cell, in a process of its own."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark.harness import runner, spec\n"
        "sys.path.insert(0, %r)\n"
        "from conftest import tiny\n"
        "runner.run_cell(tiny(spec.load_cell('mc-eval-f32')), 3, 0.1, True,"
        " 'cpu')\n"
        "print(runner.forbidden_modules(sys.modules))\n"
        % (str(spec.REPO), str(spec.BENCH_DIR / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=spec.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
