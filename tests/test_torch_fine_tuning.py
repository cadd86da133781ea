"""The port's fine-tune driver against the JAX driver on the CPU: the same
tiny reference-layout dataset (4 frames at 16x32, five pairs; as
tests/test_resume.py writes it) and the same tamed seed-0 ``.pth`` (the
JAX seed-0 weights, prediction head scaled by 0.05, written by the JAX
``save_torch_checkpoint``) go to both packages through
``model_checkpoint``; f32, Adam, batch 2, 2 epochs, an eval pass before
training and after each epoch, ``display_freq`` 4 (one captured image
grid).

The learning rate is 4e-5, not the demo's 4e-4: at 4e-4 this tiny
random-init scene is chaotic, and the port against itself, with its
starting weights perturbed by 1e-7 relative noise, already ends 0.033 apart
in final depth RMSE and up to 16% apart in the later eval losses
(measured), so no band could tell a fault from rounding; at 4e-5 the same
probe ends 1.2e-3 and 5e-4 apart.

Bands, those of ``test_pipeline_e2e.py::test_golden_parity`` where they
hold: the pre-training eval losses per pair within 1e-3 relative (the
golden gate's band for their mean; measured up to 1.2e-4, in the disparity
losses, whose value moves with torch's thread count); the later reprojection losses, per pair and mean, within 0.05
(measured <= 7.3e-3); the final depth maps within 0.02 relative RMSE
(``tools/compare_artifacts.py``). The later disparity losses (~0.08) are
the most sensitive numbers of the run: the 1e-7 probe above moves their
mean by 5.5% at 4e-5 where the reprojection mean moves by 1.1e-3, and the
packages differ by up to 8.8% (measured), so only their mean is held, to
0.2. The ``.pth`` files cross both ways exactly, and ``--resume``
continues to the same parameters as an uninterrupted run."""

import argparse
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
from consistent_depth_tpu.models import torch_import as jax_torch_import
from consistent_depth_tpu.models.mannequin_challenge import (
    MannequinChallengeModel as JaxMC)
from consistent_depth_tpu.training.fine_tuning import (
    DepthFineTuner as JaxFineTuner)
from consistent_depth_tpu_torch.models import torch_import
from consistent_depth_tpu_torch.models.mannequin_challenge import (
    MannequinChallengeModel)
from consistent_depth_tpu_torch.training import (
    DepthFineTuner, capture_slots, make_tag)

sys.path.insert(0, pjoin(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import compare_artifacts as ca  # noqa: E402

FRAMES = list(range(4))
LR = 4e-5
TAG = "B0.1_R1.0_PL1-0_LR4e-05_BS2_Oadam"


def _params(path, checkpoint, epochs, resume=False):
    return argparse.Namespace(
        path=path, model_type="mc", batch_size=2, num_epochs=epochs,
        learning_rate=LR, optimizer="Adam", lambda_view_baseline=0.1,
        lambda_reprojection=1.0, lambda_parameter=0, val_epoch_freq=1,
        save_epoch_freq=1, print_freq=1, display_freq=4, log_dir=None,
        use_mesh=False, model_checkpoint=checkpoint, resume=resume,
        profile_dir=None, precision="f32")


def _range_dir(path, name):
    range_dir = pjoin(path, name)
    os.makedirs(range_dir, exist_ok=True)
    shutil.copy(pjoin(path, "metadata.npz"),
                pjoin(range_dir, "metadata_scaled.npz"))
    return range_dir



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's small CPU runs. The suite runs
    files in parallel workers, and with torch's default of one thread per
    core beside another worker's XLA compile, the port's steps here ran
    ~50 times slower than alone (measured: 4 s -> 206 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dataset, the tamed ``.pth``, and one fine-tune + save_depth by
    each package."""
    path = str(tmp_path_factory.mktemp("finetune"))
    scene = synthetic.make_scene(num_frames=4, H=16, W=32)
    synthetic.write_dataset_dir(path, scene, synthetic.make_pairs(4))
    variables = jax.tree_util.tree_map(
        np.asarray, JaxMC(checkpoint="", seed=0).variables)
    params = dict(variables["params"])
    params["pred_layer"] = {k: v * np.float32(0.05)
                            for k, v in params["pred_layer"].items()}
    checkpoint = pjoin(path, "tamed.pth")
    jax_torch_import.save_torch_checkpoint(
        checkpoint, {**variables, "params": params})

    jft = JaxFineTuner(_range_dir(path, "R_jax"), FRAMES,
                       _params(path, checkpoint, 2))
    jft.fine_tune()
    jft.save_depth()
    ft = DepthFineTuner(_range_dir(path, "R_port"), FRAMES,
                        _params(path, checkpoint, 2), device="cpu")
    ft.fine_tune()
    ft.save_depth()
    return {"path": path, "checkpoint": checkpoint, "jax": jft, "port": ft}


def _tree(root):
    names = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(pjoin(dirpath, f), root)
            if rel.startswith("tensorboard" + os.sep):
                rel = pjoin("tensorboard", "<event file>")
            names.add(rel)
    return names


def test_same_output_tree(runs):
    port, jax_dir = runs["port"].out_dir, runs["jax"].out_dir
    assert os.path.basename(port) == os.path.basename(jax_dir) == TAG
    names = _tree(port)
    assert names == _tree(jax_dir)
    assert {"checkpoints/0001.pth", "checkpoints/0002.pth",
            "tensorboard/<event file>"} <= names
    assert sum(n.startswith("depth/") for n in names) == 2 * len(FRAMES)
    assert len([n for n in names if n.startswith("eval/loss_e")]) == 3


def test_eval_losses_match_jax(runs):
    port_eval = pjoin(runs["port"].out_dir, "eval")
    jax_eval = pjoin(runs["jax"].out_dir, "eval")
    names = sorted(os.path.basename(f)
                   for f in glob.glob(pjoin(jax_eval, "loss_e*.json")))
    assert len(names) == 3 and names[0].startswith("loss_e0000_")
    for name in names:
        with open(pjoin(port_eval, name)) as f:
            got = json.load(f)
        with open(pjoin(jax_eval, name)) as f:
            want = json.load(f)
        assert got.keys() == want.keys() == {"reprojection", "disparity",
                                             "mean"}
        for key in want:
            assert got[key].keys() == want[key].keys(), (name, key)
            if name == names[0]:
                bands = dict.fromkeys(want[key], 1e-3)
            elif key == "reprojection":
                bands = dict.fromkeys(want[key], 0.05)
            elif key == "mean":
                bands = {"reprojection": 0.05, "disparity": 0.2}
            else:
                continue
            for pair, band in bands.items():
                np.testing.assert_allclose(
                    got[key][pair], want[key][pair], rtol=band,
                    err_msg=f"{name} {key} {pair}")


def test_final_depth_matches_jax(runs):
    d = ca.compare_depth_dirs(pjoin(runs["jax"].out_dir, "depth"),
                              pjoin(runs["port"].out_dir, "depth"))
    assert d["frames_compared"] == len(FRAMES) and not d["frames_only_a"]
    assert d["rmse_max"] < 0.02, d


def test_checkpoints_cross_both_ways(runs):
    """The port's 0002.pth loads into the JAX model with the port's final
    weights and running stats, and the JAX driver's 0002.pth loads
    strict=True into the port model with the JAX driver's."""
    port, jft = runs["port"], runs["jax"]
    final = port.model.net.state_dict()
    jmodel = JaxMC(checkpoint=pjoin(port.checkpoints_dir, "0002.pth"))
    crossed = torch_import.state_dict_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, jmodel.variables))
    assert set(crossed) == {k for k in final
                            if not k.endswith("num_batches_tracked")}
    for k, v in crossed.items():
        np.testing.assert_array_equal(v, final[k].numpy(), err_msg=k)

    model = MannequinChallengeModel(
        checkpoint=pjoin(jft.checkpoints_dir, "0002.pth"), device="cpu")
    want = torch_import.state_dict_from_jax_variables(
        jax.tree_util.tree_map(np.asarray,
                               jft.engine.variables_of(jft.state)))
    got = model.net.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_resume_matches_uninterrupted_run(runs, capsys):
    """One epoch, then ``--resume`` to two: the second run starts at epoch
    1 from ``full_0001`` and ends on the uninterrupted run's parameters,
    running stats and Adam state."""
    range_dir = _range_dir(runs["path"], "R_resume")
    first = DepthFineTuner(range_dir, FRAMES,
                           _params(runs["path"], runs["checkpoint"], 1,
                                   resume=True), device="cpu")
    first.fine_tune()
    assert os.path.isfile(pjoin(first.checkpoints_dir, "full_0001",
                                "state.pt"))
    capsys.readouterr()
    second = DepthFineTuner(range_dir, FRAMES,
                            _params(runs["path"], runs["checkpoint"], 2,
                                    resume=True), device="cpu")
    second.fine_tune()
    out = capsys.readouterr().out
    assert "Resumed from" in out and "(epoch 1)" in out
    assert "Epoch = 0," not in out.split("Resumed from")[1]
    assert os.path.isfile(pjoin(second.checkpoints_dir, "full_0002",
                                "state.pt"))
    whole = runs["port"].engine
    assert second.engine.step == whole.step == 6
    for k, v in whole.model.net.state_dict().items():
        assert torch.equal(second.model.net.state_dict()[k], v), k
    opt = second.engine.optimizer.state_dict()["state"]
    for i, s in whole.optimizer.state_dict()["state"].items():
        for n, v in s.items():
            assert torch.equal(opt[i][n], v), (i, n)


def test_capture_slots_rule():
    """The display-freq rule of the JAX driver (fine_tuning.py:299-309):
    the step whose running pair count hits a multiple of display_freq gets
    the next slot, up to the capacity."""
    valids = [np.ones(4, np.float32)] * 30 + [np.array([1, 1, 0, 0],
                                                       np.float32)]
    slots = capture_slots(valids, 0, 20, 8)
    assert list(np.nonzero(slots >= 0)[0]) == [4, 9, 14, 19, 24, 29]
    assert list(slots[slots >= 0]) == list(range(6))
    # from 96 pairs in: 100 after step 0; capacity 2 drops the rest
    slots = capture_slots(valids, 96, 100, 2)
    assert list(np.nonzero(slots >= 0)[0]) == [0, 25]
    assert make_tag(_params("", "", 1)) == TAG


def test_fine_tuner_refuses_a_missing_card(tmp_path, monkeypatch):
    """The default device is the card: with no CUDA device the driver
    raises before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DepthFineTuner(str(tmp_path), FRAMES, _params(str(tmp_path), "", 1))
    assert os.listdir(tmp_path) == []
