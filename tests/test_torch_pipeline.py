"""The port's pipeline modules and CLI against the JAX package's, on the
CPU: each test gives the same inputs to both.

- the flag table: the same ``Namespace`` for the command lines of
  ``tests/test_params.py``, and the same flags with the same defaults;
- the model defaults the CLI resolves from (fault 1) and the default
  checkpoint under ``CDTPU_CHECKPOINT_DIR`` (fault 2);
- the stage graph: ``describe()``, probe skipping, a disabled stage that
  never probes, the probes on a pre-populated directory;
- the video probes with their ``sys.exit`` messages, and ``sample_pairs``;
- ``load_image`` with ``max_size`` and ``align`` on odd sizes (exact);
- the scale statistics on seeded stacks with NaNs, infinities and even
  counts, against ``_batched_scale_stats`` (rtol 1e-6) and numpy's
  ``nanmedian``;
- ``warp_image`` and the calibration renders (1e-5);
- the COLMAP readers on models the JAX writers wrote (exact), and the
  COLMAP driver's command chain, cache and fail-fast on a stub binary;
- the video export's ffmpeg command lines;
- a ``DatasetProcessor()`` with no card raises before it writes.
"""

import argparse
import os
import shutil
import stat
from os.path import join as pjoin

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import synthetic
from consistent_depth_tpu.cli.params import (
    Video3dParamsParser as JaxParamsParser)
from consistent_depth_tpu.io import colmap_io as jax_colmap_io
from consistent_depth_tpu.io import image_io as jax_image_io
from consistent_depth_tpu.models import registry as jax_registry
from consistent_depth_tpu.ops import geometry as jax_geometry
from consistent_depth_tpu.pipeline import colmap_processor as jax_colmap
from consistent_depth_tpu.pipeline import make_video as jax_make_video
from consistent_depth_tpu.pipeline import process as jax_process
from consistent_depth_tpu.pipeline import video as jax_video
from consistent_depth_tpu.pipeline.scale_calibration import (
    _batched_scale_stats)
from consistent_depth_tpu.utils import frame_range as jax_frame_range
from consistent_depth_tpu_torch.cli.params import Video3dParamsParser
from consistent_depth_tpu_torch.io import colmap_io, image_io
from consistent_depth_tpu_torch.models import registry
from consistent_depth_tpu_torch.models.mannequin_challenge import (
    MannequinChallengeModel)
from consistent_depth_tpu_torch.ops import geometry
from consistent_depth_tpu_torch.pipeline import (
    colmap_processor, make_video, process, scale_calibration, video)
from consistent_depth_tpu_torch.utils import frame_range
from test_colmap_driver import STUB, _calls, stub_colmap  # noqa: F401
from test_colmap_io import _assert_models_equal, _random_model

COMMAND_LINES = {
    "default": ["--path", "x"],
    "kitti": ["--path", "x", "--configure", "kitti"],
    "overrides": ["--path", "x", "--learning_rate", "0.01",
                  "--lambda_view_baseline", "0.5", "--align", "8"],
    "frame_range": ["--path", "x", "--frame_range", "0,5-7"],
}


def _flat(ns):
    out = dict(vars(ns))
    fr = out.pop("frame_range")
    out["frame_range"] = (fr.name, fr.set.set)
    return out


@pytest.mark.parametrize("argv", list(COMMAND_LINES.values()),
                         ids=list(COMMAND_LINES))
def test_command_lines_parse_as_jax(argv):
    got = Video3dParamsParser().parse(argv)
    want = JaxParamsParser().parse(argv)
    assert isinstance(got.frame_range, frame_range.NamedOptionalSet)
    assert _flat(got) == _flat(want)


# the port's backbone that the JAX package lacks: Depth Anything V2-Large
PORT_ONLY_MODELS = ["dav2-large"]


def test_flag_surface_matches_jax():
    def surface(parser):
        return {a.option_strings[0] if a.option_strings else a.dest:
                (a.default, a.choices, a.nargs, a.type is None)
                for a in parser._actions}

    want = surface(JaxParamsParser().parser)
    default, choices, nargs, untyped = want["--model_type"]
    want["--model_type"] = (default, choices + PORT_ONLY_MODELS, nargs,
                            untyped)
    assert surface(Video3dParamsParser().parser) == want


def test_model_defaults_match_jax(tmp_path, monkeypatch):
    """Fault 1: the defaults the CLI resolves ``--learning_rate 0``,
    ``--lambda_view_baseline -1`` and ``--align 0`` from, for every
    backbone the flag takes (the JAX package's, and the port's own
    dav2-large, DA2's encoder rate and midas2's disparity weight at its
    patch size); midas2, monodepth2 and dav2-large are the real adapters,
    and with their default weights missing they raise, naming the path,
    before any download or build."""
    from consistent_depth_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2Model)
    from consistent_depth_tpu_torch.models.midas_v2 import MidasV2Model
    from consistent_depth_tpu_torch.models.monodepth2 import Monodepth2Model

    assert registry.get_depth_model_list() == \
        jax_registry.get_depth_model_list() + PORT_ONLY_MODELS
    for name in jax_registry.get_depth_model_list():
        got, want = registry.get_depth_model(name), \
            jax_registry.get_depth_model(name)
        for attr in ("align", "learning_rate", "lambda_view_baseline"):
            assert getattr(got, attr) == getattr(want, attr), (name, attr)
    assert MannequinChallengeModel.learning_rate == 0.0004
    assert MannequinChallengeModel.lambda_view_baseline == 0.1
    assert (DepthAnythingV2Model.align, DepthAnythingV2Model.learning_rate,
            DepthAnythingV2Model.lambda_view_baseline) == (14, 5e-6, 1e-4)
    monkeypatch.setenv("CDTPU_CHECKPOINT_DIR", str(tmp_path))
    for name, cls, default in (
            ("midas2", MidasV2Model, "midas2.pth"),
            ("monodepth2", Monodepth2Model,
             "monodepth2_mono+stereo_1024x320"),
            ("dav2-large", DepthAnythingV2Model,
             "depth_anything_v2_vitl.pth")):
        assert registry.get_depth_model(name) is cls
        with pytest.raises(FileNotFoundError) as err:
            registry.create_depth_model(name, device="cpu")
        assert str(tmp_path / default) in str(err.value)


def test_default_checkpoint_under_checkpoint_dir(tmp_path, monkeypatch):
    """Fault 2: with CDTPU_CHECKPOINT_DIR set, the default weights are
    ``$CDTPU_CHECKPOINT_DIR/mc.pth``; a missing one still raises, naming
    that path, and nothing is fetched."""
    from consistent_depth_tpu_torch.models import torch_import

    monkeypatch.delenv("CDTPU_CHECKPOINT_DIR", raising=False)
    assert MannequinChallengeModel.default_checkpoint_path() == \
        "checkpoints/mc.pth"
    monkeypatch.setenv("CDTPU_CHECKPOINT_DIR", str(tmp_path))
    want = str(tmp_path / "mc.pth")
    assert MannequinChallengeModel.default_checkpoint_path() == want
    with pytest.raises(FileNotFoundError, match="mc.pth"):
        MannequinChallengeModel(device="cpu")
    seeded = MannequinChallengeModel(checkpoint="", seed=3, device="cpu")
    torch_import.save_checkpoint(want, seeded.net.state_dict())
    loaded = MannequinChallengeModel(device="cpu")
    for k, v in seeded.net.state_dict().items():
        assert torch.equal(loaded.net.state_dict()[k], v), k


def _params(module, path):
    parser = (Video3dParamsParser if module is process else JaxParamsParser)
    return parser().parse(["--path", path, "--model_type", "mc"])


def test_describe_matches_jax(tmp_path):
    got = process.DatasetProcessor(device="cpu").describe(
        _params(process, str(tmp_path)))
    want = jax_process.DatasetProcessor().describe(
        _params(jax_process, str(tmp_path)))
    assert got == want
    assert got[:2] == ["Extracting PTS", "Extracting frames"]
    assert got[-1] == "Export visualization videos"


def test_stage_probe_skips_and_disabled_never_probes():
    """As ``tests/test_process_stages.py`` holds the JAX stages."""
    calls = []
    process.Stage("x", run=lambda s: calls.append("x"),
                  done=lambda s: True).execute(process.PipelineState(None))
    process.Stage("y", run=lambda s: calls.append("y"),
                  done=lambda s: False).execute(process.PipelineState(None))
    assert calls == ["y"]
    process.Stage("z", run=lambda s: 1 / 0, done=lambda s: 1 / 0,
                  enabled=lambda s: False).execute(process.PipelineState(None))


def test_probes_fire_on_existing_artifacts(tmp_path):
    """The frames/downscale/initial-depth/filter probes give the JAX
    graph's answers on a directory the fixture pre-populated, and an empty
    initial-depth directory reads as not done in both."""
    path = str(tmp_path)
    synthetic.build_e2e_dataset(path)
    answers = {}
    for module in (process, jax_process):
        graph = (process.DatasetProcessor(device="cpu") if module is process
                 else jax_process.DatasetProcessor())._build_graph(
                     _params(module, path))
        vid = (video if module is process else jax_video).Video(path)
        state = module.PipelineState(
            params=_params(module, path), path=path, out_dir=path,
            video=vid, initial_depth_dir=pjoin(path, "depth_mc"))
        answers[module] = {st.name: bool(st.done(state))
                           for st in graph
                           if st.done is not None and "final" not in st.name}
    assert answers[process] == answers[jax_process]
    assert answers[process]["Extracting PTS"]
    assert answers[process]["Downscaling frames (for flow)"]
    assert not answers[process]["Compute initial depth"]
    assert not answers[process]["Filter flow pairs"]


def _frames_txt(path, n, lines=None):
    with open(pjoin(path, "frames.txt"), "w") as f:
        f.write(f"{n}\n64\n48\n" + "".join(
            f"{i / 30:.6f}\n" for i in range(n if lines is None else lines)))


def _exit_message(fn):
    with pytest.raises(SystemExit) as exc:
        fn()
    return str(exc.value.code)


def test_video_probes_and_exit_messages(tmp_path):
    path = str(tmp_path)
    _frames_txt(path, 3)
    frame_dir = pjoin(path, "color_full")
    os.makedirs(frame_dir)
    for i in (0, 1, 2):
        open(pjoin(frame_dir, f"frame_{i:06d}.png"), "w").close()
    open(pjoin(frame_dir, "preview.png"), "w").close()   # not a frame
    vids = [video.Video(path), jax_video.Video(path)]
    for v in vids:
        assert v.check_extracted_pts() and v.frame_count == 3
        assert v.check_frames(frame_dir, "png")
        assert not v.check_frames(pjoin(path, "absent"), "png")
    os.remove(pjoin(frame_dir, "frame_000002.png"))
    msgs = [_exit_message(lambda v=v: v.check_frames(frame_dir, "png"))
            for v in vids]
    assert msgs[0] == msgs[1] and "expected to find 3 files" in msgs[0]
    open(pjoin(frame_dir, "frame_000007.png"), "w").close()
    msgs = [_exit_message(lambda v=v: v.check_frames(frame_dir, "png"))
            for v in vids]
    assert msgs[0] == msgs[1] and "did not find expected file" in msgs[0]
    _frames_txt(path, 3, lines=2)
    msgs = [_exit_message(v.check_extracted_pts) for v in vids]
    assert msgs == ["frames.txt has wrong number of lines"] * 2
    os.remove(pjoin(path, "frames.txt"))
    msgs = [_exit_message(lambda v=v: type(v)(path, "nope.mp4").extract_pts())
            for v in vids]
    assert msgs[0] == msgs[1] and "not found" in msgs[0]


@pytest.mark.parametrize("ops", [["hierarchical2"], ["consecutive"],
                                 ["hierarchical", "exhausted"]])
@pytest.mark.parametrize("subset", [None, {0, 2, 3, 4, 7, 8, 9}])
def test_sample_pairs_matches_jax(ops, subset):
    got = video.sample_pairs(frame_range.FrameRange(
        frame_range.OptionalSet(subset), num_frames=10), ops)
    want = jax_video.sample_pairs(jax_frame_range.FrameRange(
        jax_frame_range.OptionalSet(subset), num_frames=10), ops)
    assert sorted(map(tuple, got)) == sorted(map(tuple, want))


@pytest.mark.parametrize("hw", [(37, 53), (61, 29), (20, 24)])
@pytest.mark.parametrize("max_size,align", [(None, 1), (24, 1), (24, 16),
                                            (40, 3), (48, 32)])
def test_load_image_matches_jax(tmp_path, hw, max_size, align):
    import cv2

    img = np.random.default_rng(hw[0]).integers(
        0, 256, (*hw, 3), dtype=np.uint8)
    fn = str(tmp_path / "im.png")
    cv2.imwrite(fn, img)
    got = image_io.load_image(fn, max_size=max_size, align=align)
    want = jax_image_io.load_image(fn, max_size=max_size, align=align)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if max_size is not None:
        assert max(got.shape[:2]) <= max(max_size, 1) + align
        if align > 1:
            assert got.shape[0] % align == 0 and got.shape[1] % align == 0


def _scale_stacks(seed, N=5, H=7, W=10):
    rng = np.random.default_rng(seed)
    inv_src = rng.uniform(0.2, 2.0, (N, H, W)).astype(np.float32)
    inv_cmp = rng.uniform(0.1, 1.5, (N, H, W)).astype(np.float32)
    inv_cmp[rng.random((N, H, W)) < 0.3] = np.nan
    inv_cmp[0, 0, :3] = 0.0          # infinite ratios: not counted
    inv_cmp[1] = np.nan              # a small even count: W finite
    inv_cmp[1, 0] = rng.uniform(0.1, 1.5, W)
    inv_cmp[2] = np.nan              # no finite ratio
    inv_src[3, 2, 2] = np.nan
    return inv_src, inv_cmp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_stats_match_jax(seed):
    inv_src, inv_cmp = _scale_stacks(seed)
    got = [t.numpy() for t in scale_calibration.batched_scale_stats(
        torch.from_numpy(inv_src), torch.from_numpy(inv_cmp))]
    want = [np.asarray(t) for t in _batched_scale_stats(
        jnp.asarray(inv_src), jnp.asarray(inv_cmp))]
    for g, w, name in zip(got, want, ("median", "std", "valid_ratio")):
        np.testing.assert_allclose(g, w, rtol=1e-6, equal_nan=True,
                                   err_msg=name)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (inv_src / inv_cmp).reshape(len(inv_src), -1)
    ratio[~np.isfinite(ratio)] = np.nan
    with pytest.warns(RuntimeWarning):   # the frame with no finite ratio
        numpy_median = np.nanmedian(ratio, axis=1)
    np.testing.assert_allclose(got[0], numpy_median, rtol=1e-6,
                               equal_nan=True)
    # an even count, where torch.nanmedian (the lower middle value) would
    # differ, and a frame with none
    assert list(np.isfinite(ratio).sum(axis=1)[1:3]) == [10, 0]


def test_nanmedian_of_an_even_count_is_the_mean_of_the_middle_two():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0, float("nan")]])
    med, _, _ = scale_calibration.batched_scale_stats(x, torch.ones_like(x))
    assert float(med[0]) == 2.5 == float(np.nanmedian(x.numpy()))
    assert float(torch.nanmedian(x)) == 2.0


def _warp_inputs(seed=0):
    scene = synthetic.make_scene(num_frames=4, H=12, W=20, seed=seed)
    return (scene["frames"], scene["depths"] * np.float32(1.1),
            scene["extrinsics"], scene["intrinsics"])


@pytest.mark.parametrize("tgt", [[1, 0, 3, 2], [3, 3, 0, 1]])
def test_warp_image_matches_jax(tgt):
    arrays = _warp_inputs()
    got = geometry.warp_image(*map(torch.from_numpy, arrays), tgt).numpy()
    want = np.asarray(jax_geometry.warp_image(*map(jnp.asarray, arrays), tgt))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    uv = geometry.warping_field(
        *(torch.from_numpy(a) for a in (arrays[2], arrays[3], arrays[1])),
        tgt).numpy()
    np.testing.assert_allclose(uv, np.asarray(jax_geometry.warping_field(
        *(jnp.asarray(a) for a in (arrays[2], arrays[3], arrays[1])), tgt)),
        rtol=1e-5, atol=1e-4)


def test_warps_take_an_index_tensor():
    """An index tensor gives what the same list gives, bit for bit."""
    arrays = [torch.from_numpy(a) for a in _warp_inputs()]
    tgt = [3, 3, 0, 1]
    assert torch.equal(geometry.warp_image(*arrays, torch.tensor(tgt)),
                       geometry.warp_image(*arrays, tgt))
    fields = [geometry.warping_field(arrays[2], arrays[3], arrays[1], t)
              for t in (torch.tensor(tgt), tgt)]
    assert torch.equal(*fields)


def test_calibration_render_matches_per_pair_warps():
    """The batched render warps each (frame, anchor) pair as the JAX
    per-pair ``warp_image(..., [1, 0])`` does, and converts to uint8."""
    colors, depths, extr, intr = _warp_inputs(1)
    pairs = [(1, 0), (2, 0), (3, 0)]

    def stack(a):
        return torch.from_numpy(np.stack([a[list(p)] for p in pairs]))

    colors_u8, warped_u8 = scale_calibration.render_calibration(
        stack(colors), stack(depths), stack(extr), stack(intr))
    for b, p in enumerate(pairs):
        want = np.asarray(jax_geometry.warp_image(
            *(jnp.asarray(a[list(p)]) for a in (colors, depths, extr, intr)),
            [1, 0]))
        want_u8 = np.clip(want * 255, 0, 255).astype(np.uint8)
        assert np.abs(warped_u8[b].numpy().astype(int)
                      - want_u8.astype(int)).max() <= 1
        np.testing.assert_array_equal(
            colors_u8[b].numpy(),
            np.clip(colors[list(p)] * 255, 0, 255).astype(np.uint8))


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_readers_on_jax_written_models(tmp_path, ext):
    model = _random_model(np.random.default_rng(len(ext)))
    jax_colmap_io.write_model(*model, str(tmp_path), ext=ext)
    got = colmap_io.read_model(str(tmp_path), ext=ext)
    _assert_models_equal(got, jax_colmap_io.read_model(str(tmp_path), ext=ext))
    _assert_models_equal(got, model)
    cams, ims, _ = got
    for size in ((48, 32), (640, 480)):
        for a, b in zip(colmap_io.convert_calibration(cams, ims, size),
                        jax_colmap_io.convert_calibration(
                            *jax_colmap_io.read_model(str(tmp_path), ext)[:2],
                            size)):
            np.testing.assert_array_equal(a, b)


def test_colmap_dense_array_and_quaternions(tmp_path):
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.5, 3.0, (13, 17)).astype(np.float32)
    fn = str(tmp_path / "frame_000000.png.geometric.bin")
    jax_colmap_io.write_array(depth, fn)
    np.testing.assert_array_equal(colmap_io.read_array(fn),
                                  jax_colmap_io.read_array(fn))
    np.testing.assert_array_equal(colmap_io.read_array(fn), depth)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    R = colmap_io.qvec2rotmat(q)
    np.testing.assert_array_equal(R, jax_colmap_io.qvec2rotmat(q))
    np.testing.assert_array_equal(colmap_io.rotmat2qvec(R),
                                  jax_colmap_io.rotmat2qvec(R))


def _driver_calls(module, stub, tmp_path, argv, name):
    bin_path, images, log = stub
    ws = str(tmp_path / name)
    args = module.COLMAPParams().parse_args([images, ws] + argv)
    args.colmap_bin_path = bin_path
    n = len(_calls(log))
    module.main(args)
    module.main(args)   # the second run takes the cached stages
    return [[a.replace(ws, "<ws>") for a in c] for c in _calls(log)[n:]]


@pytest.mark.parametrize("argv", [
    ["--camera_params", "525,320,240", "--dense_max_size", "384"],
    ["--sparse", "--matcher", "sequential"],
], ids=["dense", "sparse_sequential"])
def test_colmap_driver_chain_matches_jax(stub_colmap, tmp_path, argv):
    got = _driver_calls(colmap_processor, stub_colmap, tmp_path, argv, "p")
    want = _driver_calls(jax_colmap, stub_colmap, tmp_path, argv, "j")
    assert got == want
    matcher = ("sequential" if "sequential" in argv else "exhaustive") + \
        "_matcher"
    dense = [] if "--sparse" in argv else ["image_undistorter",
                                           "patch_match_stereo"]
    # the second run takes the cached mapper and dense stages
    assert [c[0] for c in got] == ["feature_extractor", matcher, "mapper",
                                   *dense, "feature_extractor", matcher]


def test_colmap_driver_fail_fast_and_keep_going(stub_colmap, tmp_path):
    bin_path, images, log = stub_colmap
    fail_bin = str(tmp_path / "colmap_fail")
    with open(bin_path) as f:
        body = f.read().replace("mapper|point_triangulator)",
                                "never_matches)")
    with open(fail_bin, "w") as f:
        f.write(body)
    os.chmod(fail_bin, os.stat(fail_bin).st_mode | stat.S_IEXEC)
    msgs = []
    ws = str(tmp_path / "ws")
    for module in (colmap_processor, jax_colmap):
        shutil.rmtree(ws, ignore_errors=True)
        args = module.COLMAPParams().parse_args([images, ws, "--sparse"])
        with pytest.raises(RuntimeError) as exc:
            module.COLMAPProcessor(fail_bin).process(args)
        msgs.append(str(exc.value))
        proc = module.COLMAPProcessor(fail_bin, fail_fast=False)
        proc.process(args)
        assert not proc.check_sparse(proc.sparse_dir(ws, 0))
    assert msgs[0] == msgs[1] and "'mapper' failed" in msgs[0]
    with pytest.raises(FileNotFoundError, match="sparse model"):
        scale_calibration._read_colmap_poses(
            str(tmp_path), colmap_processor.COLMAPProcessor.sparse_dir(ws, 0))


def test_make_video_command_lines_match_jax(tmp_path, monkeypatch):
    """The export's ffmpeg invocations, recorded by a fake ``subprocess.run``
    that creates each output, in order and argument for argument."""
    import cv2

    rng = np.random.default_rng(6)
    root = str(tmp_path)
    for sub in ("color", "depth_a/depth", "depth_b", "depth_short"):
        os.makedirs(pjoin(root, sub))
        n = 2 if sub == "depth_short" else 3
        for i in range(n):
            cv2.imwrite(pjoin(root, sub, f"frame_{i:06d}.png"),
                        rng.integers(0, 256, (10, 14, 3), dtype=np.uint8))
    cv2.imwrite(pjoin(root, "depth_b", "frame_000001.png"),
                rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
    calls = {}
    for module in (make_video, jax_make_video):
        record = calls[module] = []

        def fake_run(cmd, check=False, record=record):
            record.append(list(cmd))
            open(cmd[-1], "w").close()
            return 0

        monkeypatch.setattr(module.subprocess, "run", fake_run)
        monkeypatch.setattr(module.shutil, "which", lambda b: "/bin/" + b)
        args = module.MakeVideoParams().parser.parse_args(
            ["--color_dir", "color", "--out_dir", "videos",
             "--video3d_dir", root, "--depth_dirs", "depth_a", "depth_b",
             "depth_short", "absent"])
        assert module.main(args) == 0
        shutil.rmtree(pjoin(root, "videos"))
    assert calls[make_video] == calls[jax_make_video]
    assert len(calls[make_video]) >= 8


def test_make_video_params_share_the_namespace():
    ns = argparse.Namespace(path="x", size=384)
    got = make_video.MakeVideoParams().parser.parse_args(
        ["--color_dir", "c", "--out_dir", "o", "--depth_dirs", "a"],
        namespace=ns)
    assert got is ns and got.size == 384 and got.ffmpeg == "ffmpeg"


def test_processor_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process.DatasetProcessor()
    assert os.listdir(tmp_path) == []
    assert process.DatasetProcessor(device="cpu").device.type == "cpu"
