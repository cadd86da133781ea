"""The port's last host and model functions against the JAX package's, on
the same numpy inputs made from a seed, on the CPU:

- ``DepthModel``'s ``forward``, ``parameters`` and ``save``: a ``.pth``
  that either package saves gives the other the same eval depth (1e-5
  relative), ``forward`` with ``metadata["scales"]`` is ``apply``
  bitwise, and a train-mode ``forward`` moves the BN running stats as
  JAX's does (rtol = atol = 1e-4, the band of tests/test_torch_epoch.py's
  eval passes);
- ``ops/geometry_np.py``: equal to the JAX module (1e-6) and to the
  port's torch ``ops/geometry.py`` on the CPU (1e-5);
- ``utils/depth_alignment.py``: each mode against JAX (rtol 1e-12, both
  f64 numpy; RANSAC with the same seed picks the same scale);
- ``utils/calibration.py``: on a sparse model of tests/synthetic.py's
  plane scene at a known scale, the per-frame scales equal JAX's (rtol
  1e-9), both recover the scale (1e-5), and a frame without a depth file
  is skipped alike;
- ``ops/geometry.py::calibrate_scale`` (1e-5) and the weighted MSE and
  RMSE losses, values and gradients (1e-6);
- ``visualize_calibration_pair``: the two PNGs of a pair within 1 LSB of
  the JAX function's;
- ``apply_mask``, ``create_video`` (the command line it hands a stand-in
  ``ffmpeg``), ``to_in_range``, ``dotdict``, ``suppressed_stdout``, and
  ``python -m consistent_depth_tpu_torch.io.image_io`` (the same ``.raw``
  and ``.png`` output files as the JAX CLI from a seeded image).
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import synthetic
from consistent_depth_tpu.io import colmap_io as jax_colmap
from consistent_depth_tpu.io import image_io as jax_image_io
from consistent_depth_tpu.models.mannequin_challenge import (
    MannequinChallengeModel as JaxMC)
from consistent_depth_tpu.ops import geometry as jax_geometry
from consistent_depth_tpu.ops import geometry_np as jax_geometry_np
from consistent_depth_tpu.ops import losses as jax_losses
from consistent_depth_tpu.pipeline import scale_calibration as jax_sc
from consistent_depth_tpu.utils import calibration as jax_calibration
from consistent_depth_tpu.utils import depth_alignment as jax_alignment
from consistent_depth_tpu.utils import frame_sampling as jax_sampling
from consistent_depth_tpu.utils import helpers as jax_helpers
from consistent_depth_tpu.utils import visualization as jax_vis
from consistent_depth_tpu_torch.io import colmap_io, image_io
from consistent_depth_tpu_torch.models import torch_import
from consistent_depth_tpu_torch.models.mannequin_challenge import (
    MannequinChallengeModel)
from consistent_depth_tpu_torch.ops import geometry, geometry_np, losses
from consistent_depth_tpu_torch.pipeline import scale_calibration
from consistent_depth_tpu_torch.utils import (calibration, depth_alignment,
                                              frame_sampling, helpers,
                                              visualization)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# DepthModel: forward, parameters, save
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """A port ``mc`` at seed 0 with the head tamed (x 0.05) and seeded BN
    running stats, saved by the port; the JAX model that loads it; and
    that JAX model saved again."""
    d = tmp_path_factory.mktemp("depth_model")
    model = MannequinChallengeModel(checkpoint="", device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in model.net.state_dict().items():
            if name.startswith("pred_layer."):
                t.mul_(0.05)
            elif name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
    port_pth, jax_pth = str(d / "port.pth"), str(d / "jax.pth")
    model.save(port_pth)
    jax_model = JaxMC(checkpoint=port_pth)
    jax_model.save(jax_pth)
    images = np.random.default_rng(0).random((1, 2, H, W, 3),
                                             dtype=np.float32)
    return model, jax_model, port_pth, jax_pth, images


def test_port_save_loads_in_jax(crossed):
    model, jax_model, port_pth, _, images = crossed
    want = np.asarray(jax_model.forward(images, train=False))
    with torch.no_grad():
        got = model.forward(images, train=False).numpy()
    assert got.shape == want.shape == (1, 2, H, W)
    assert _rel(got, want) < 1e-5
    # the file holds every key of the network, in f32
    sd = torch_import.load_checkpoint(port_pth)
    assert sd.keys() == model.net.state_dict().keys()
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())


def test_jax_save_loads_in_port(crossed):
    model, jax_model, _, jax_pth, images = crossed
    back = MannequinChallengeModel(checkpoint=jax_pth, device="cpu")
    want = np.asarray(jax_model.forward(images, train=False))
    with torch.no_grad():
        got = back.forward(images, train=False).numpy()
    assert _rel(got, want) < 1e-5
    # the parameters and running stats come back bitwise
    sd = model.net.state_dict()
    for k, v in back.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_forward_with_scales_is_apply(crossed):
    model, _, _, _, images = crossed
    scales = np.array([[0.5, 3.0]], np.float32)
    with torch.no_grad():
        got = model.forward(images, {"scales": scales}, train=False)
        want = model.apply(torch.from_numpy(images),
                           torch.from_numpy(scales), train=False)
        plain = model.forward(images, {"other": 1}, train=False)
    assert torch.equal(got, want)
    assert torch.equal(got, plain * torch.tensor([0.5, 3.0])[None, :, None,
                                                            None])
    params = model.parameters()
    assert params.keys() == dict(model.net.named_parameters()).keys()
    assert all(isinstance(p, torch.nn.Parameter) for p in params.values())


def test_train_forward_moves_running_stats_as_jax(crossed):
    _, _, port_pth, _, images = crossed
    model = MannequinChallengeModel(checkpoint=port_pth, device="cpu")
    jax_model = JaxMC(checkpoint=port_pth)
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    with torch.no_grad():
        got = model.forward(images).numpy()
    want = np.asarray(jax_model.forward(images))
    assert _rel(got, want) < 1e-4
    jax_stats = torch_import.state_dict_from_jax_variables(
        {"batch_stats": jax.tree_util.tree_map(
            np.asarray, jax_model.variables["batch_stats"])})
    sd = model.net.state_dict()
    assert len(jax_stats) > 100
    for k, v in jax_stats.items():
        assert not torch.equal(sd[k], before[k]), k
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# numpy geometry
# ---------------------------------------------------------------------------

def _geometry_inputs(seed=0):
    rng = np.random.default_rng(seed)
    intr = np.array([40.0, 42.0, 23.5, 15.5], np.float32)
    depth = rng.uniform(1, 3, (H, W)).astype(np.float32)
    extr = []
    for _ in range(2):
        q = rng.standard_normal(4)
        R = colmap_io.qvec2rotmat(q / np.linalg.norm(q))
        extr.append(np.concatenate([R, rng.standard_normal((3, 1))], 1))
    return intr, depth, np.stack(extr).astype(np.float32)


def test_geometry_np_matches_jax_and_torch():
    intr, depth, extr = _geometry_inputs()
    grid = geometry_np.pixel_grid((H, W))
    np.testing.assert_array_equal(grid, jax_geometry_np.pixel_grid((H, W)))
    np.testing.assert_array_equal(grid, geometry.pixel_grid((H, W)).numpy())
    t = torch.from_numpy
    rays = geometry_np.pixels_to_rays(grid, intr)
    pts = geometry_np.pixels_to_points(intr, depth, grid)
    moved = geometry_np.reproject_points(pts, extr[0], extr[1])
    uv = geometry_np.project(moved, intr)
    cases = {
        "rays": (rays, jax_geometry_np.pixels_to_rays(grid, intr),
                 geometry.pixels_to_rays(t(grid), t(intr))),
        "points": (pts, jax_geometry_np.pixels_to_points(intr, depth, grid),
                   geometry.pixels_to_points(t(intr), t(depth), t(grid))),
        "reproject": (moved, jax_geometry_np.reproject_points(
            pts, extr[0], extr[1]), geometry.reproject_points(
            t(pts), t(extr[0]), t(extr[1]))),
        "project": (uv, jax_geometry_np.project(moved, intr),
                    geometry.project(t(moved), t(intr))),
    }
    for name, (got, want, port) in cases.items():
        assert got.dtype == want.dtype, name
        assert _rel(got, want) < 1e-6, name
        assert _rel(got, port.numpy()) < 1e-5, name
    data = np.random.default_rng(1).random((H, W, 3))
    uv = uv + np.array([40.0, -10.0])  # some samples fall off the border
    np.testing.assert_array_equal(geometry_np.sample_nearest(data, uv),
                                  jax_geometry_np.sample_nearest(data, uv))


# ---------------------------------------------------------------------------
# depth alignment
# ---------------------------------------------------------------------------

def _alignment_inputs(seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(1, 5, (24, 32))
    pred = gt / 2.5 + rng.normal(0, 0.01, gt.shape) + 0.3
    pred[rng.random(gt.shape) < 0.1] *= 3  # outliers
    pred[0, :4] = np.nan
    gt[1, :3] = np.inf
    mask = (rng.random(gt.shape) > 0.2).astype(np.float32)
    return pred.astype(np.float32), gt, mask


@pytest.mark.parametrize("mode", ["scale", "scale-shift", "ransac"])
@pytest.mark.parametrize("masked", [False, True])
def test_align_depths_matches_jax(mode, masked):
    pred, gt, mask = _alignment_inputs()
    mask = mask if masked else None
    got = depth_alignment.align_depths(pred, gt, mode, mask)
    want = jax_alignment.align_depths(pred, gt, mode, mask)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.isnan(got[0, 0])


def test_fit_functions_match_jax():
    pred, gt, mask = _alignment_inputs(1)
    for name in ("fit_scale", "fit_scale_shift", "fit_scale_ransac"):
        got = getattr(depth_alignment, name)(pred, gt, mask)
        want = getattr(jax_alignment, name)(pred, gt, mask)
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)
    for seed in (0, 3):
        assert (depth_alignment.fit_scale_ransac(pred, gt, iters=7, seed=seed)
                == jax_alignment.fit_scale_ransac(pred, gt, iters=7,
                                                  seed=seed))
    # empty selections: both fall back to 1
    none = np.zeros_like(mask)
    assert depth_alignment.fit_scale(pred, gt, none) == 1.0
    assert depth_alignment.fit_scale_ransac(pred, gt, none) == 1.0


def test_align_depths_unknown_mode():
    pred, gt, _ = _alignment_inputs()
    for mod in (depth_alignment, jax_alignment):
        with pytest.raises(ValueError, match="unknown alignment mode 'x'"):
            mod.align_depths(pred, gt, "x")


# ---------------------------------------------------------------------------
# sparse-point calibration
# ---------------------------------------------------------------------------

SCALE = 2.75


def _write_sparse_scene(path):
    """``chip_smoke.write_sparse_plane`` on tests/synthetic.py's plane scene
    (4 frames, 30 points each, frame 3 without a depth file): a sparse
    model at 1/SCALE the scene's size, written by the port."""
    scene = synthetic.make_scene(num_frames=4, H=H, W=W)
    return chip_smoke.write_sparse_plane(colmap_io, image_io, geometry_np,
                                         scene, str(path), SCALE, 30)


def test_sparse_calibration_matches_jax(tmp_path):
    have = _write_sparse_scene(tmp_path)
    fmt = str(tmp_path / "depth" / "frame_{:06d}.raw")
    got = calibration.calibrate_w_sparse_colmap(
        str(tmp_path / "sparse"), fmt, (W, H))
    want = jax_calibration.calibrate_w_sparse_colmap(
        str(tmp_path / "sparse"), fmt, (W, H))
    assert sorted(got) == sorted(want) == have
    for f in have:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-9)
        np.testing.assert_allclose(got[f], SCALE, rtol=1e-5)


def test_sparse_calibration_parts_match_jax(tmp_path):
    _write_sparse_scene(tmp_path)
    _, images, points = colmap_io.read_model(str(tmp_path / "sparse"))
    _, jimages, jpoints = jax_colmap.read_model(str(tmp_path / "sparse"))
    extr = colmap_io.images_to_extrinsics(images, [1])
    xy, depth = calibration.project_sparse_points(images[1], points, extr[0])
    jxy, jdepth = jax_calibration.project_sparse_points(
        jimages[1], jpoints, extr[0])
    np.testing.assert_array_equal(xy, jxy)
    np.testing.assert_allclose(depth, jdepth, rtol=1e-12)
    assert len(depth) == 27
    inv = np.full((H, W), 0.5, np.float32)
    inv[:4] = np.nan
    for size_old in (None, (2 * W, 2 * H)):
        assert (calibration.calibrate_frame_w_sparse_colmap(
                    xy, depth, inv, size_old)
                == jax_calibration.calibrate_frame_w_sparse_colmap(
                    xy, depth, inv, size_old))
    assert calibration.calibrate_frame_w_sparse_colmap(
        xy, -depth, inv) is None
    # no observed point: empty arrays
    images[1].point3D_ids = np.full_like(images[1].point3D_ids, -1)
    xy, depth = calibration.project_sparse_points(images[1], points, extr[0])
    assert xy.shape == (0, 2) and depth.shape == (0,)


# ---------------------------------------------------------------------------
# geometry.calibrate_scale and the weighted losses (torch entry points)
# ---------------------------------------------------------------------------

def test_calibrate_scale_matches_jax():
    scene = synthetic.make_scene(num_frames=3, H=H, W=W)
    for pair in ([0, 1], [2, 0]):
        extr, intr = scene["extrinsics"][pair], scene["intrinsics"][pair]
        depths = scene["depths"][pair] * np.float32(1.7)
        want = float(jax_geometry.calibrate_scale(
            jnp.asarray(extr), jnp.asarray(intr), jnp.asarray(depths)))
        got = geometry.calibrate_scale(torch.from_numpy(extr),
                                       torch.from_numpy(intr),
                                       torch.from_numpy(depths))
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("name", ["weighted_mse_loss", "weighted_rmse_loss"])
def test_weighted_losses_match_jax(name):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 10, 2)).astype(np.float32)
    target = rng.standard_normal((3, 8, 10, 2)).astype(np.float32)
    weights = rng.random((3, 8, 10)).astype(np.float32)
    weights[2] = 0.0  # the eps clamp of an all-zero weight map
    jfn = getattr(jax_losses, name)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(target),
                          jnp.asarray(weights)))
    jgrads = jax.grad(lambda a, b: jfn(a, jnp.asarray(target), b).sum(),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(weights))
    xt, wt = (torch.from_numpy(x).requires_grad_(),
              torch.from_numpy(weights).requires_grad_())
    got = getattr(losses, name)(xt, torch.from_numpy(target), wt)
    got.sum().backward()
    assert got.shape == (3,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    for g, jg in zip((xt.grad, wt.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# calibration renders
# ---------------------------------------------------------------------------

def test_visualize_calibration_pair_matches_jax(tmp_path):
    scene = synthetic.make_scene(num_frames=3, H=H, W=W)
    color_fmt = str(tmp_path / "color_{:06d}.png")
    depth_fmt = str(tmp_path / "depth_{:06d}.raw")
    for i in range(3):
        cv2.imwrite(color_fmt.format(i),
                    np.uint8(np.round(scene["frames"][i] * 255)))
        if i != 2:
            image_io.save_raw_float32_image(depth_fmt.format(i),
                                            1.0 / scene["depths"][i])
    extr = scene["extrinsics"].astype(np.float64)
    intr = scene["intrinsics"].astype(np.float64)
    scale_calibration.visualize_calibration_pair(
        extr, intr, depth_fmt, color_fmt, (1, 0), str(tmp_path / "port"),
        device="cpu")
    jax_sc.visualize_calibration_pair(extr, intr, depth_fmt, color_fmt,
                                      (1, 0), str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "frame_000000.png", "frame_000000_warped_to_000001.png",
        "frame_000001.png", "frame_000001_warped_to_000000.png"]
    for n in names:
        a = cv2.imread(str(tmp_path / "port" / n)).astype(int)
        b = cv2.imread(str(tmp_path / "jax" / n)).astype(int)
        assert a.shape == b.shape == (H, W, 3)
        assert np.abs(a - b).max() <= 1, n
    # a pair with a missing depth file writes nothing
    scale_calibration.visualize_calibration_pair(
        extr, intr, depth_fmt, color_fmt, (2, 0), str(tmp_path / "none"),
        device="cpu")
    assert not os.path.exists(tmp_path / "none")


# ---------------------------------------------------------------------------
# small helpers and the image CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 1])
def test_apply_mask_matches_jax(channels):
    rng = np.random.default_rng(channels)
    im = rng.random((H, W, channels)).squeeze()
    mask = rng.random((H, W)) > 0.5
    for color in (None, [10, 20, 30][:channels]):
        np.testing.assert_array_equal(
            visualization.apply_mask(im, mask, color),
            jax_vis.apply_mask(im, mask, color))


def test_create_video_command(tmp_path):
    """The command line handed to ``ffmpeg_bin`` (a script that records
    its arguments), as the JAX function builds it; an existing output is
    left alone."""
    fake = tmp_path / "ffmpeg"
    fake.write_text("#!/bin/sh\n"
                    "printf '%s\\n' \"$@\" > \"$(dirname \"$0\")/args_$$\"\n"
                    "touch \"$(eval echo \\${$#})\"\n")
    fake.chmod(0o755)
    got = []
    for mod, out in ((visualization, "port.mp4"), (jax_vis, "jax.mp4")):
        mod.create_video("frame_%06d.png", str(tmp_path / out), str(fake))
        (args,) = [p for p in tmp_path.iterdir() if p.name.startswith("args_")]
        got.append(args.read_text().splitlines())
        args.unlink()
        assert (tmp_path / out).exists()
    assert got[0][:-1] == got[1][:-1] == [
        "-r", "30", "-i", "frame_%06d.png", "-c:v", "libx264", "-crf", "27",
        "-pix_fmt", "yuv420p"]
    visualization.create_video("x", str(tmp_path / "port.mp4"), str(fake))
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("args_")]


def test_to_in_range_matches_jax():
    pairs = [(0, 1), (3, 5), (5, 6), (2, 9), (4, 4)]
    for rng_ in (None, (0, 6), (3, 5), (10, 12)):
        assert (frame_sampling.to_in_range(pairs, rng_)
                == jax_sampling.to_in_range(pairs, rng_))


def test_dotdict_and_suppressed_stdout(capsys):
    for mod in (helpers, jax_helpers):
        d = mod.dotdict(a=1)
        d.b = 2
        assert d == {"a": 1, "b": 2} and d.a == 1 and d.missing is None
        del d.a
        assert d == {"b": 2}
        with mod.suppressed_stdout():
            print("hidden")
        print("shown")
    assert capsys.readouterr().out == "shown\nshown\n"


def _image_cli(pkg, src, out):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.io.image_io", "--input_image", src,
         "--output_image", out, "--max_size", "32"], cwd=REPO_ROOT,
        capture_output=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))


@pytest.mark.parametrize("ext", [".raw", ".png"])
def test_image_io_cli_matches_jax(tmp_path, ext):
    """A seeded 40x60 PNG resized to a long side of 32 and written as
    ``.raw`` and ``.png``: the same bytes from both CLIs. A ``.raw`` input
    is refused by both (the loader reads image files only)."""
    rng = np.random.default_rng(0)
    src = str(tmp_path / "in.png")
    cv2.imwrite(src, rng.integers(0, 256, (40, 60, 3), dtype=np.uint8))
    outs = []
    for pkg in ("consistent_depth_tpu_torch", "consistent_depth_tpu"):
        out = str(tmp_path / f"{pkg}{ext}")
        assert _image_cli(pkg, src, out).returncode == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    if ext == ".raw":
        assert image_io.load_raw_float32_image(
            str(tmp_path / f"consistent_depth_tpu_torch{ext}")).shape == (
            21, 32, 3)
        for pkg in ("consistent_depth_tpu_torch", "consistent_depth_tpu"):
            proc = _image_cli(pkg, str(tmp_path / f"{pkg}{ext}"),
                              str(tmp_path / "again.raw"))
            assert (proc.returncode != 0
                    and b"cannot identify image file" in proc.stderr)
