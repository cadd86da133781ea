"""The port stands without JAX, and its chip smoke script refuses to run
without a CUDA card.

Of the JAX package the port imports only host modules that load neither
jax nor OpenCV (and their package ``__init__``s): the flow helpers, the
image I/O, the colour wheel, and for training the pair-batch iterator and
the frame range and pair sampling."""

import json
import os
import pkgutil
import shutil
import subprocess
import sys

import consistent_depth_tpu_torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's modules the port may load: the host helpers, the
# packages above them, and what those import themselves
JAX_FREE_HELPERS = [
    "consistent_depth_tpu", "consistent_depth_tpu.flow",
    "consistent_depth_tpu.flow.backends", "consistent_depth_tpu.io",
    "consistent_depth_tpu.io._native", "consistent_depth_tpu.io.colmap_io",
    "consistent_depth_tpu.io.image_io", "consistent_depth_tpu.io.metadata_io",
    "consistent_depth_tpu.ops", "consistent_depth_tpu.ops.flow_viz",
    "consistent_depth_tpu.data", "consistent_depth_tpu.data.video_dataset",
    "consistent_depth_tpu.utils", "consistent_depth_tpu.utils.frame_range",
    "consistent_depth_tpu.utils.frame_sampling",
]


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            consistent_depth_tpu_torch.__path__,
            prefix="consistent_depth_tpu_torch."))


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "consistent_depth_tpu_torch.serving.server" in mods
    assert "consistent_depth_tpu_torch.ops.s2d_conv" in mods
    for m in ("flow.correlation", "flow.flownet", "flow.runner",
              "flow.backends", "ops.resample", "ops.geometry",
              "ops.consistency", "ops.flow_viz", "pipeline.flow_stage",
              "ops.losses", "training", "training.engine",
              "training.optimizer"):
        assert "consistent_depth_tpu_torch." + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'cv2') or "
        "m.startswith(('jax.', 'flax', 'cv2.')) or "
        "(m.split('.')[0] == 'consistent_depth_tpu' "
        f"and m not in {JAX_FREE_HELPERS!r}))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
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
