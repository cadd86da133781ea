"""The port's CLI end to end on the CPU: the whole stage graph of
``consistent_depth_tpu_torch.cli`` on the golden fixture of
``tests/synthetic.py`` (6 frames at 32x48, flows, poses and COLMAP depth
precomputed, as ``tests/test_pipeline_e2e.py`` builds it), one directory
per run. Each package gets its weights through ``params.model_checkpoint``:
a ``.pth`` written by the JAX ``save_torch_checkpoint`` from the JAX
seed-0 ``mc`` weights.

What can be held against what:

- ``tests/golden/e2e`` was made on the 8 virtual devices that
  ``tests/conftest.py`` forces, under which the JAX driver multiplies the
  batch by the device count (2 -> 16, ``training/fine_tuning.py:132-144``).
  The port has one device. So against the goldens only what the device
  count plays no part in: the initial depth (RMSE max < 1e-3, the golden
  gate's band) and the scales (rtol 1e-3), from a run at the untamed
  seed-0 weights, as the goldens were made, with ``--num_epochs 0``.
- Everything else against the JAX CLI run on one device
  (``params.use_mesh = False``), at the tamed seed-0 weights (prediction
  head scaled by 0.05) and ``--learning_rate 4e-5``: the output trees file
  for file, the scales (rtol 1e-6), the pre-training eval losses per pair
  (1e-3 relative), the post-training eval means (0.1 relative) and the
  final depth (RMSE max < 0.02). At the CLI's default 4e-4 with the
  untamed head, this scene is chaotic after training: the port against
  itself with its weights perturbed by 1e-7 relative noise ends as far from
  its own run as from the JAX run (final-depth RMSE max 0.282 and 0.255,
  ``tools/torch_cli_noise_probe.py --head 1 --lr 0``), so no band could
  tell a fault from rounding.

The noise probe at these settings, as the largest relative gap of the
post-training eval means and the final-depth RMSE max (``python
tools/torch_cli_noise_probe.py --threads 2 1 4 --noise 1e-7 1e-6 --seeds
0 1 2``, two torch threads as here, on an 8-core CPU host): port against
JAX 0.0438 and 0.00501, the 0.0438 in the epoch-2 reprojection mean
(0.0546 against 0.0571: no small denominator; the post-training means lie
in 0.054-0.11). The port against itself spreads as far: at one and four
threads 0.0274 and 0.0374; under 1e-7 relative weight noise, seeds 0-2,
0.0153, 0.0199 and 0.0443; under 1e-6, 0.0481, 0.0419 and 0.0117; final
depth 0.00494-0.00618 in all eight. The pre-training eval means of port
and JAX differ by 6.6e-6, those under 1e-6 noise by 1.9e-6-4.0e-6, so the
two packages start as close as these perturbed runs do and end no
farther apart: the gap is rounding carried through two epochs, not a
systematic difference. The post-training band 0.1 is 2.1x the largest
spread (0.0481), where ``test_golden_parity``'s 0.05 would leave 1.04x;
the final-depth band 0.02 is 3.2x.

``--model_type monodepth2`` (the KITTI preset's backbone) runs the same
way, with no epoch: the port's entry point ``cli.main.main`` and the
one-device JAX CLI each read the default checkpoint directory
``$CDTPU_CHECKPOINT_DIR/monodepth2_mono+stereo_1024x320`` (the JAX seed-0
weights as ``encoder.pth``, whose height and width set a 64x128 feed, and
``depth.pth``; the JAX side with ``CDTPU_NO_FETCH=1``). Against each other:
the output tree file for file, the tag (``..._LR4e-05_...``, the
backbone's own learning rate), the initial depth (RMSE max < 1e-3), the
scales (rtol 1e-3) and the pre-training eval losses per pair (1e-3). The
midas2 CLI runs on the card only (``chip_smoke.py``): its ResNeXt-101 at
full width on this CPU would not fit the suite's time.

A second port run, through ``cli.main.main`` on a copy of the trained
directory with the weights as ``$CDTPU_CHECKPOINT_DIR/mc.pth``, redoes
nothing before "Fine-tuning": no file outside the tag directory changes,
and neither FlowNet2 nor any mask, render or scale pass is entered.
"""

import glob
import json
import os
import shutil
import sys
from os.path import join as pjoin

import numpy as np
import pytest
import torch

import jax

import synthetic
from consistent_depth_tpu.cli.params import (
    Video3dParamsParser as JaxParamsParser)
from consistent_depth_tpu.models import torch_import as jax_torch_import
from consistent_depth_tpu.models.mannequin_challenge import (
    MannequinChallengeModel as JaxMC)
from consistent_depth_tpu.pipeline.process import (
    DatasetProcessor as JaxDatasetProcessor)
from consistent_depth_tpu_torch.cli import main as cli_main
from consistent_depth_tpu_torch.cli.params import Video3dParamsParser
from consistent_depth_tpu_torch.io import metadata_io
from consistent_depth_tpu_torch.pipeline import (
    flow_stage, process, scale_calibration)

sys.path.insert(0, pjoin(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import compare_artifacts as ca  # noqa: E402

GOLDEN_DIR = pjoin(os.path.dirname(__file__), "golden", "e2e")
LR = "4e-5"
TAG = "B0.1_R1.0_PL1-0_LR4e-05_BS2_Oadam"
RANGE = "R_hierarchical2_mc"
TOL_PRE = 1e-3
TOL_POST_MEAN = 0.1
TOL_FINAL_RMSE = 0.02


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads, as ``tests/test_torch_fine_tuning.py`` uses: the
    suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX seed-0 ``mc`` weights as ``.pth``: untamed, and with the
    prediction head scaled by 0.05."""
    d = tmp_path_factory.mktemp("weights")
    variables = jax.tree_util.tree_map(
        np.asarray, JaxMC(checkpoint="", seed=0).variables)
    untamed = str(d / "seed0.pth")
    jax_torch_import.save_torch_checkpoint(untamed, variables)
    params = dict(variables["params"])
    params["pred_layer"] = {k: v * np.float32(0.05)
                            for k, v in params["pred_layer"].items()}
    tamed = str(d / "seed0_tamed.pth")
    jax_torch_import.save_torch_checkpoint(
        tamed, {**variables, "params": params})
    return {"untamed": untamed, "tamed": tamed}


def _port_params(path, checkpoint, extra):
    params = Video3dParamsParser().parse(
        ["--path", path] + synthetic.E2E_PIPELINE_ARGS + extra)
    params.model_checkpoint = checkpoint
    return params


def _dataset(tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp(name))
    synthetic.build_e2e_dataset(path)
    return path


MONODEPTH2_DIR = "monodepth2_mono+stereo_1024x320"
MONODEPTH2_FEED = (64, 128)


@pytest.fixture(scope="module")
def monodepth2_runs(tmp_path_factory):
    """The port's CLI (``cli.main.main``) and the one-device JAX CLI with
    ``--model_type monodepth2 --num_epochs 0`` on the seeded checkpoint
    directory, found as the default under ``$CDTPU_CHECKPOINT_DIR``."""
    from consistent_depth_tpu.models.monodepth2 import (
        Monodepth2Model as JaxMonodepth2)

    ckpt_dir = tmp_path_factory.mktemp("monodepth2_weights")
    sd = jax_torch_import.variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, JaxMonodepth2(checkpoint="", seed=0).variables))
    os.makedirs(ckpt_dir / MONODEPTH2_DIR)
    height, width = MONODEPTH2_FEED
    torch.save({**{k: torch.from_numpy(v) for k, v in sd.items()
                   if k.startswith("encoder.")},
                "height": height, "width": width, "use_stereo": False},
               str(ckpt_dir / MONODEPTH2_DIR / "encoder.pth"))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()
                if k.startswith("decoder.")},
               str(ckpt_dir / MONODEPTH2_DIR / "depth.pth"))
    args = synthetic.E2E_PIPELINE_ARGS + ["--model_type", "monodepth2",
                                          "--num_epochs", "0"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDTPU_CHECKPOINT_DIR", str(ckpt_dir))
        mp.setenv("CDTPU_NO_FETCH", "1")
        jax_path = _dataset(tmp_path_factory, "jax_monodepth2")
        jparams = JaxParamsParser().parse(["--path", jax_path] + args)
        jparams.use_mesh = False
        out["jax"] = (jax_path, JaxDatasetProcessor().process(jparams))
        port_path = _dataset(tmp_path_factory, "port_monodepth2")
        out["port"] = (port_path, cli_main.main(["--path", port_path] + args,
                                                device="cpu"))
    return out


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory, weights):
    """The port's CLI at the untamed weights with no training epoch."""
    path = _dataset(tmp_path_factory, "port_golden")
    params = _port_params(path, weights["untamed"], ["--num_epochs", "0"])
    return path, process.DatasetProcessor(device="cpu").process(params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    """The port's CLI and the one-device JAX CLI, tamed weights, lr 4e-5."""
    extra = ["--learning_rate", LR]
    jax_path = _dataset(tmp_path_factory, "jax")
    jparams = JaxParamsParser().parse(
        ["--path", jax_path] + synthetic.E2E_PIPELINE_ARGS + extra)
    jparams.model_checkpoint = weights["tamed"]
    jparams.use_mesh = False
    JaxDatasetProcessor().process(jparams)
    port_path = _dataset(tmp_path_factory, "port")
    process.DatasetProcessor(device="cpu").process(
        _port_params(port_path, weights["tamed"], extra))
    return {"port": port_path, "jax": jax_path}


def test_golden_initial_depth_and_scales(golden_run):
    path, (initial_depth_dir, out_dir, frames) = golden_run
    assert frames == list(range(6))
    # fault 1: the learning rate resolves from the mc model's default
    assert os.path.basename(out_dir) == "B0.1_R1.0_PL1-0_LR0.0004_BS2_Oadam"
    d = ca.compare_depth_dirs(pjoin(GOLDEN_DIR, "initial_depth"),
                              pjoin(initial_depth_dir, "depth"))
    assert d["frames_compared"] == 6 and not d["frames_only_a"]
    assert d["rmse_max"] < 1e-3, d
    golden = metadata_io.read_scales_csv(pjoin(GOLDEN_DIR, "scales.csv"))
    scales = metadata_io.read_scales_csv(
        pjoin(path, RANGE, "scales.csv"))
    np.testing.assert_array_equal(scales[:, 0], golden[:, 0])
    np.testing.assert_allclose(scales[:, 1], golden[:, 1], rtol=1e-3)
    # no epoch: the pre-training eval alone, and the final depth of the
    # untrained weights
    evals = os.listdir(pjoin(out_dir, "eval"))
    assert [f for f in evals if f.startswith("loss")] == [
        "loss_e0000_iter000000.json"]
    assert len(glob.glob(pjoin(out_dir, "depth", "frame_*.raw"))) == 6


def _tree(root):
    names = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(pjoin(dirpath, f), root)
            if os.sep + "tensorboard" + os.sep in os.sep + rel:
                rel = pjoin(os.path.dirname(rel), "<event file>")
            names.add(rel)
    return names


def test_same_output_tree(runs):
    port, want = _tree(runs["port"]), _tree(runs["jax"])
    assert port == want
    tag_dir = pjoin(RANGE, TAG)
    for name in ("flow_list.json", pjoin(RANGE, "scales.csv"),
                 pjoin(RANGE, "metadata_scaled.npz"),
                 pjoin(tag_dir, "checkpoints", "0002.pth"),
                 pjoin(tag_dir, "tensorboard", "<event file>"),
                 pjoin(tag_dir, "depth", "frame_000005.raw"),
                 pjoin("depth_mc", "depth", "frame_000005.raw")):
        assert name in port, name
    for sub in ("vis_flow", "vis_flow_warped",
                pjoin(RANGE, "vis_calibration_dense")):
        assert any(n.startswith(sub + os.sep) for n in port), sub


def test_scales_match_jax(runs):
    got, want = (metadata_io.read_scales_csv(pjoin(runs[k], RANGE,
                                                   "scales.csv"))
                 for k in ("port", "jax"))
    assert got.shape == want.shape == (6, 2)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)


def _losses(path, name):
    with open(pjoin(path, RANGE, TAG, "eval", name)) as f:
        return json.load(f)


def test_eval_losses_match_jax(runs):
    names = sorted(os.path.basename(f) for f in glob.glob(
        pjoin(runs["jax"], RANGE, TAG, "eval", "loss_e*.json")))
    assert len(names) == 3 and names[0] == "loss_e0000_iter000000.json"
    for name in names:
        got, want = _losses(runs["port"], name), _losses(runs["jax"], name)
        assert got.keys() == want.keys() == {"reprojection", "disparity",
                                             "mean"}
        for key in want:
            assert got[key].keys() == want[key].keys(), (name, key)
        if name == names[0]:
            for key in ("reprojection", "disparity", "mean"):
                for pair in want[key]:
                    np.testing.assert_allclose(
                        got[key][pair], want[key][pair], rtol=TOL_PRE,
                        err_msg=f"{name} {key} {pair}")
        else:
            for key in want["mean"]:
                np.testing.assert_allclose(
                    got["mean"][key], want["mean"][key], rtol=TOL_POST_MEAN,
                    err_msg=f"{name} mean {key}")


def test_final_depth_matches_jax(runs):
    d = ca.compare_depth_dirs(pjoin(runs["jax"], RANGE, TAG, "depth"),
                              pjoin(runs["port"], RANGE, TAG, "depth"))
    assert d["frames_compared"] == 6 and not d["frames_only_a"]
    assert d["rmse_max"] < TOL_FINAL_RMSE, d


def test_monodepth2_cli_matches_jax(monodepth2_runs):
    (port, (port_init, port_out, frames)), (jax_path, (jax_init, jax_out, _)) \
        = monodepth2_runs["port"], monodepth2_runs["jax"]
    assert frames == list(range(6))
    tag = os.path.basename(port_out)
    assert tag == os.path.basename(jax_out) and "_LR4e-05_" in tag, tag
    assert _tree(port) == _tree(jax_path)
    rng = "R_hierarchical2_monodepth2"
    assert os.path.relpath(port_out, port) == pjoin(rng, tag)
    assert os.path.basename(port_init) == "depth_monodepth2"
    d = ca.compare_depth_dirs(pjoin(jax_init, "depth"),
                              pjoin(port_init, "depth"))
    assert d["frames_compared"] == 6 and not d["frames_only_a"]
    assert d["rmse_max"] < 1e-3, d
    got, want = (metadata_io.read_scales_csv(pjoin(p, rng, "scales.csv"))
                 for p in (port, jax_path))
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-3)
    name = "loss_e0000_iter000000.json"
    assert sorted(os.listdir(pjoin(jax_out, "eval"))) == sorted(
        os.listdir(pjoin(port_out, "eval")))
    with open(pjoin(port_out, "eval", name)) as f:
        got = json.load(f)
    with open(pjoin(jax_out, "eval", name)) as f:
        want = json.load(f)
    assert got.keys() == want.keys() == {"reprojection", "disparity", "mean"}
    for key in want:
        assert got[key].keys() == want[key].keys(), key
        for pair in want[key]:
            np.testing.assert_allclose(got[key][pair], want[key][pair],
                                       rtol=TOL_PRE, err_msg=f"{key} {pair}")


def _mtimes(root, skip):
    out = {}
    for dirpath, _, files in os.walk(root):
        if dirpath.startswith(skip):
            continue
        for f in files:
            p = pjoin(dirpath, f)
            out[p] = os.stat(p).st_mtime_ns
    return out


def test_second_run_redoes_nothing_before_fine_tuning(
        runs, weights, tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "again")
    shutil.copytree(runs["port"], path)
    tag_dir = pjoin(path, RANGE, TAG)
    before = _mtimes(path, tag_dir)

    def entered(what):
        def fail(*args, **kwargs):
            raise AssertionError(f"the cached re-run entered {what}")
        return fail

    monkeypatch.setattr(flow_stage, "create_flow_backend",
                        entered("the flow backend"))
    monkeypatch.setattr(flow_stage.consistency, "consistent_flow_masks",
                        entered("the mask pass"))
    monkeypatch.setattr(flow_stage, "_render", entered("the flow renders"))
    monkeypatch.setattr(scale_calibration, "batched_scale_stats",
                        entered("the scale statistics"))
    monkeypatch.setattr(scale_calibration, "render_calibration",
                        entered("the calibration renders"))
    # through the entry point, which takes no checkpoint flag: the weights
    # are the default checkpoint under CDTPU_CHECKPOINT_DIR (fault 2)
    ckpt_dir = tmp_path / "checkpoints"
    ckpt_dir.mkdir()
    shutil.copy(weights["tamed"], ckpt_dir / "mc.pth")
    monkeypatch.setenv("CDTPU_CHECKPOINT_DIR", str(ckpt_dir))
    capsys.readouterr()
    _, out_dir, frames = cli_main.main(
        ["--path", path] + synthetic.E2E_PIPELINE_ARGS
        + ["--learning_rate", LR], device="cpu")
    out = capsys.readouterr().out
    assert out_dir == tag_dir and frames == list(range(6))
    assert _mtimes(path, tag_dir) == before
    for stage in ("Extracting PTS", "Extracting frames",
                  "Downscaling frames (raw)", "Downscaling frames (png)",
                  "Downscaling frames (for flow)", "Compute initial depth",
                  "Filter flow pairs"):
        assert f"[{stage}] outputs up to date, skipping." in out, stage
    assert "Existing scales file loaded." in out
    assert "Scaled metadata file exists." in out
    assert "[Fine-tuning] finished" in out


def test_cli_main_refuses_a_missing_card(tmp_path, monkeypatch):
    """``cli.main.main`` runs on the card by default: with no CUDA device
    it raises before anything is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "data")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.main(["--path", path])
    assert os.listdir(tmp_path) == []


def test_module_entry_point_refuses_a_missing_card(tmp_path):
    """``python -m consistent_depth_tpu_torch`` with no CUDA device exits
    non-zero and writes nothing, as ``chip_smoke.py`` checks on the card
    under ``CUDA_VISIBLE_DEVICES=""``."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path / "data")
    proc = subprocess.run(
        [sys.executable, "-m", "consistent_depth_tpu_torch", "--path", path,
         "--num_epochs", "2", "--resume"],
        cwd=repo, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert os.listdir(tmp_path) == []
