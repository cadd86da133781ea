"""Port's flow backend, CLI and flow stage against the JAX package's.

- ``TorchFlowBackend.process_pairs`` against ``JaxFlowBackend`` on the
  same random FlowNet2 weights and PNG frames, compared at the ``.raw``
  files: rtol 1e-4, atol 1e-4 * max |flow| (the cascade band of
  tests/test_torch_flownet.py);
- the CLI plumbing, as tests/test_flow_runner.py checks the JAX CLI, and
  one real CLI run on the CPU;
- ``create_flow_backend`` with and without a checkpoint in
  ``CDTPU_CHECKPOINT_DIR``, and ``Flow.compute_flow`` through it;
- ``mask_valid_correspondences``, ``check_good_flow_pairs`` and
  ``visualize_flow`` against the JAX ``Flow`` on the same ``flow/`` files,
  compared at the PNGs and the JSON. A mask is a threshold on an f32 sum,
  so a pixel whose sum lies within the last bits of the threshold may
  flip: at most 0.1% of mask pixels may differ, and a rendered colour by
  at most one level (the bands of chip_smoke.py).
"""

import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistent_depth_tpu.flow.runner import JaxFlowBackend
from consistent_depth_tpu.io import image_io
from consistent_depth_tpu.ops import consistency as jax_consistency
from consistent_depth_tpu.ops import flow_viz as jax_flow_viz
from consistent_depth_tpu.pipeline.flow_stage import Flow as JaxFlow
from consistent_depth_tpu_torch.flow import backends, flownet, runner
from consistent_depth_tpu_torch.ops import consistency, flow_viz
from consistent_depth_tpu_torch.pipeline.flow_stage import Flow
from test_torch_flownet import random_variables

PAIRS = [(0, 1), (1, 0), (1, 2), (2, 1)]
MASK_BAND = 1e-3


@pytest.fixture(scope="module")
def flownet2_variables():
    x = jnp.zeros((1, 64, 64, 3))
    import consistent_depth_tpu.flow.flownet as jax_flownet

    return random_variables(jax_flownet.FlowNet2(), x, x, seed=21)


def _write_frames(frame_dir, n, shape, seed):
    os.makedirs(frame_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        cv2.imwrite(os.path.join(frame_dir, f"frame_{i:06d}.png"),
                    rng.integers(0, 255, shape).astype(np.uint8))


def test_process_pairs_matches_jax(flownet2_variables, tmp_path):
    """60x70 frames: the network runs at 64x64, and both backends resize
    the flow back and then to the 48x32 output."""
    frame_dir = str(tmp_path / "color_flow")
    _write_frames(frame_dir, 2, (60, 70, 3), seed=1)
    pairs = [(0, 1), (1, 0)]
    jax_fmt = str(tmp_path / "jax_{:06d}_{:06d}.raw")
    JaxFlowBackend(variables=flownet2_variables, full=True,
                   homography=False).process_pairs(
                       frame_dir, pairs, jax_fmt, (48, 32))
    port_fmt = str(tmp_path / "port_{:06d}_{:06d}.raw")
    backend = runner.TorchFlowBackend(variables=flownet2_variables,
                                      full=True, homography=False,
                                      device="cpu")
    backend.process_pairs(frame_dir, pairs, port_fmt, (48, 32))
    for pair in pairs:
        want = image_io.load_raw_float32_image(jax_fmt.format(*pair))
        got = image_io.load_raw_float32_image(port_fmt.format(*pair))
        assert got.shape == (32, 48, 2) and np.isfinite(got).all()
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_cli_plumbing(tmp_path, monkeypatch):
    """The standalone CLI reads image pairs, writes .raw flow (+ a PNG),
    skips existing outputs, and hands --homography and --device to the
    backend."""
    rng = np.random.default_rng(0)
    for i in (1, 2):
        cv2.imwrite(str(tmp_path / f"im{i}.png"),
                    (rng.random((16, 24, 3)) * 255).astype(np.uint8))
    calls = []

    class FakeBackend:
        def __init__(self, **kw):
            calls.append(kw)

        def compute_pair(self, im1, im2):
            assert im1.shape == (16, 24, 3) and im1.dtype == np.float32
            return np.stack([np.ones((16, 24), np.float32),
                             np.zeros((16, 24), np.float32)], -1)

    monkeypatch.setattr(runner, "TorchFlowBackend", FakeBackend)
    out = tmp_path / "sub" / "flow.raw"
    argv = ["--im1", str(tmp_path / "im1.png"),
            "--im2", str(tmp_path / "im2.png"),
            "--out", str(out), "--size", "8", "12",
            "--visualize", "--no-homography", "--device", "cpu"]
    runner.main(argv)

    assert calls[0]["homography"] is False
    assert calls[0]["device"] == "cpu"
    flow = image_io.load_raw_float32_image(str(out))
    assert flow.shape == (8, 12, 2)
    # resize_flow rescales the u component by the width ratio 12/24
    np.testing.assert_allclose(flow[..., 0], 0.5, atol=1e-6)
    assert (tmp_path / "sub" / "flow.png").is_file()

    n = len(calls)
    runner.main(argv)
    assert len(calls) == n + 1  # constructed once more, compute skipped


def test_cli_runs_seeded_network(tmp_path):
    _write_frames(str(tmp_path), 2, (64, 64, 3), seed=2)
    out = tmp_path / "flow.raw"
    runner.main(["--im1", str(tmp_path / "frame_000000.png"),
                 "--im2", str(tmp_path / "frame_000001.png"),
                 "--out", str(out), "--no-homography", "--device", "cpu"])
    flow = image_io.load_raw_float32_image(str(out))
    assert flow.shape == (64, 64, 2) and np.isfinite(flow).all()


def test_create_backend_without_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("CDTPU_CHECKPOINT_DIR", str(tmp_path))
    b = backends.create_flow_backend("FlowNet2", device="cpu")
    assert isinstance(b, backends.PrecomputedFlowBackend)


def _dataset(path, H=32, W=48, n=3, seed=3):
    rng = np.random.default_rng(seed)
    for sub in ("color_flow", "color_down"):
        os.makedirs(os.path.join(path, sub), exist_ok=True)
    for i in range(n):
        im = rng.random((H, W, 3)).astype(np.float32)
        cv2.imwrite(os.path.join(path, "color_flow", f"frame_{i:06d}.png"),
                    (im * 255).astype(np.uint8))
        image_io.save_raw_float32_image(
            os.path.join(path, "color_down", f"frame_{i:06d}.raw"), im)


def test_create_backend_and_compute_flow(tmp_path, monkeypatch):
    """A checkpoint in CDTPU_CHECKPOINT_DIR selects the port's FlowNet2
    backend (homography except for KITTI); Flow.compute_flow runs it on
    the frame pairs and the mask stage consumes its output."""
    ckpt_dir = tmp_path / "checkpoints"
    ckpt_dir.mkdir()
    seeded = runner.TorchFlowBackend(checkpoint=None, full=False, seed=5,
                                     device="cpu")
    torch.save(seeded.net.state_dict(), str(ckpt_dir / "flownet2-kitti.pth"))
    os.symlink(str(ckpt_dir / "flownet2-kitti.pth"),
               str(ckpt_dir / "flownet2.pth"))
    monkeypatch.setenv("CDTPU_CHECKPOINT_DIR", str(ckpt_dir))

    kitti = backends.create_flow_backend("FlowNet2-KITTI", device="cpu")
    assert isinstance(kitti, runner.TorchFlowBackend)
    assert kitti.homography is False
    assert type(kitti.net) is flownet.FlowNet2CSS
    assert kitti.device == torch.device("cpu")
    plain = backends.create_flow_backend("FlowNet2", device="cpu")
    assert plain.homography is True

    path = str(tmp_path / "ds")
    _dataset(path)
    stage = Flow(path, str(tmp_path / "out"), device="cpu")
    stage.compute_flow(PAIRS, checkpoint="FlowNet2-KITTI")
    for (i, j) in PAIRS:
        f = image_io.load_raw_float32_image(
            os.path.join(path, "flow", f"flow_{i:06d}_{j:06d}.raw"))
        assert f.shape == (32, 48, 2) and np.isfinite(f).all()
    stage.mask_valid_correspondences()
    for (i, j) in PAIRS:
        m = cv2.imread(
            os.path.join(path, "mask", f"mask_{i:06d}_{j:06d}.png"), 0)
        assert m is not None and m.shape == (32, 48)


@pytest.fixture()
def flow_dirs(tmp_path):
    """Two copies of one dataset with flow/ files: one for each package.
    Flows are a translation plus noise, so that the masks mix kept and
    dropped pixels."""
    path = str(tmp_path / "jax")
    _dataset(path, H=24, W=32)
    rng = np.random.default_rng(4)
    os.makedirs(os.path.join(path, "flow"))
    for (i, j) in PAIRS:
        sign = 1.0 if i < j else -1.0
        flow = (sign * np.array([1.5, -0.5])
                + 0.6 * rng.standard_normal((24, 32, 2))).astype(np.float32)
        image_io.save_raw_float32_image(
            os.path.join(path, "flow", f"flow_{i:06d}_{j:06d}.raw"), flow)
    port = str(tmp_path / "port")
    shutil.copytree(path, port)
    return path, port, tmp_path


def _pngs(directory):
    return {n: cv2.imread(os.path.join(directory, n), cv2.IMREAD_UNCHANGED)
            for n in sorted(os.listdir(directory))}


def test_mask_and_visualize_match_jax(flow_dirs):
    jax_path, port_path, tmp = flow_dirs
    JaxFlow(jax_path, str(tmp / "jax_out")).mask_valid_correspondences(
        batch_pairs=1)
    Flow(port_path, str(tmp / "port_out"),
         device="cpu").mask_valid_correspondences(batch_pairs=1)
    want = _pngs(os.path.join(jax_path, "mask"))
    got = _pngs(os.path.join(port_path, "mask"))
    assert sorted(got) == sorted(want) == sorted(
        f"mask_{i:06d}_{j:06d}.png" for (i, j) in PAIRS)
    kept = np.mean([np.mean(m > 0) for m in want.values()])
    assert 0.05 < kept < 0.95
    for name in want:
        assert np.mean(got[name] != want[name]) <= MASK_BAND, name

    # visualisation reads each package's own masks; give both the JAX
    # ones so that the panels compare the rendering alone
    shutil.rmtree(os.path.join(port_path, "mask"))
    shutil.copytree(os.path.join(jax_path, "mask"),
                    os.path.join(port_path, "mask"))
    JaxFlow(jax_path, str(tmp / "jax_out")).visualize_flow(warp=True)
    Flow(port_path, str(tmp / "port_out"),
         device="cpu").visualize_flow(warp=True, batch_pairs=1)
    for sub in ("vis_flow", "vis_flow_warped"):
        want = _pngs(os.path.join(jax_path, sub))
        got = _pngs(os.path.join(port_path, sub))
        assert sorted(got) == sorted(want) and want
        for name in want:
            assert got[name].shape == want[name].shape, name
            diff = np.abs(got[name].astype(int) - want[name].astype(int))
            assert diff.max() <= 1, (name, diff.max())


def test_check_good_flow_pairs_matches_jax(flow_dirs):
    jax_path, port_path, tmp = flow_dirs
    JaxFlow(jax_path, str(tmp / "jax_out")).mask_valid_correspondences()
    shutil.copytree(os.path.join(jax_path, "mask"),
                    os.path.join(port_path, "mask"))
    for d in ("jax_out", "port_out"):
        os.makedirs(tmp / d)
    want = JaxFlow(jax_path, str(tmp / "jax_out")).check_good_flow_pairs(
        PAIRS, 0.2)
    got = Flow(port_path, str(tmp / "port_out"),
               device="cpu").check_good_flow_pairs(PAIRS, 0.2)
    assert os.path.basename(got) == os.path.basename(want)
    with open(got) as f, open(want) as g:
        assert json.load(f) == json.load(g)


def test_consistent_flow_masks_matches_jax():
    rng = np.random.default_rng(9)
    flows = (rng.standard_normal((3, 2, 20, 28, 2)) * 0.4).astype(np.float32)
    colors = rng.random((3, 2, 20, 28, 3)).astype(np.float32)
    want = np.asarray(jax_consistency.consistent_flow_masks(
        jnp.asarray(flows), jnp.asarray(colors), 1.0, 0.5))
    got = consistency.consistent_flow_masks(
        torch.from_numpy(flows), torch.from_numpy(colors), 1.0, 0.5).numpy()
    assert got.shape == want.shape == (3, 2, 20, 28)
    assert 0.05 < want.mean() < 0.95
    assert np.mean(got != want) <= MASK_BAND


def test_flow_to_image_matches_jax():
    rng = np.random.default_rng(10)
    flows = (rng.standard_normal((2, 12, 16, 2)) * 3).astype(np.float32)
    flows[0, 0, 0] = [2e7, 0.0]          # an unknown-flow pixel
    flows[1] = 0.0                       # a zero flow (max radius 0)
    want = np.asarray(jax_flow_viz.flow_to_image_jnp(jnp.asarray(flows)))
    got = flow_viz.flow_to_image_torch(torch.from_numpy(flows)).numpy()
    assert got.shape == (2, 12, 16, 3)
    assert np.abs(got - want).max() <= 1.0
    # the host renderer of the JAX package agrees with the device one
    np.testing.assert_array_equal(
        jax_flow_viz.flow_to_image(flows[0]).astype(np.float32),
        np.asarray(want[0]))
