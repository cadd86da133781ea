"""The port stands without JAX, and its chip smoke script refuses to run
without a CUDA card.

Neither the port nor ``chip_smoke.py`` loads any module of the JAX package,
not even one that imports no JAX: the host helpers the port needs are its
own copies (``tests/test_torch_host_copies.py`` holds them against the
originals)."""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import consistent_depth_tpu_torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's modules the port may load: none
JAX_FREE_HELPERS = []


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            consistent_depth_tpu_torch.__path__,
            prefix="consistent_depth_tpu_torch."))


def _forbidden_after(statements, forbid_cv2):
    """Run ``statements`` in a fresh interpreter at the repository root and
    return its exit status and the forbidden modules it then holds: jax,
    flax, any module of the JAX package outside JAX_FREE_HELPERS, and with
    ``forbid_cv2`` OpenCV."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        + "".join(f"{line}\n" for line in statements) +
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flax')) or "
        f"({forbid_cv2!r} and (m == 'cv2' or m.startswith('cv2.'))) or "
        "(m.split('.')[0] == 'consistent_depth_tpu' "
        f"and m not in {JAX_FREE_HELPERS!r}))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "consistent_depth_tpu_torch.serving.server" in mods
    assert "consistent_depth_tpu_torch.ops.s2d_conv" in mods
    for m in ("flow.correlation", "flow.flownet", "flow.runner",
              "flow.backends", "ops.resample", "ops.geometry",
              "ops.consistency", "ops.flow_viz", "pipeline.flow_stage",
              "ops.losses", "training", "training.engine",
              "training.optimizer", "io.image_io", "utils.frame_range",
              "utils.frame_sampling", "data.video_dataset"):
        assert "consistent_depth_tpu_torch." + m in mods
    assert JAX_FREE_HELPERS == []
    proc = _forbidden_after(
        ["import importlib", f"for m in {mods!r}:",
         "    importlib.import_module(m)"], forbid_cv2=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_without_jax():
    """Every import statement of chip_smoke.py, wherever it stands in the
    file (the port's modules are imported inside main(), OpenCV inside
    the flow stage's phase), loads nothing of JAX or the JAX package."""
    with open(os.path.join(REPO_ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    statements = [ast.unparse(n) for n in ast.walk(tree)
                  if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert any("consistent_depth_tpu_torch" in s for s in statements)
    proc = _forbidden_after(statements, forbid_cv2=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def _assert_refused(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok") is True), line


def test_chip_smoke_fails_without_cuda():
    _assert_refused(_run_smoke(REPO_ROOT))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    _assert_refused(_run_smoke(str(tmp_path)))
