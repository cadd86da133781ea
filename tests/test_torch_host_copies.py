"""The port's copies of the JAX package's host helpers against the
originals: pair sampling over a frame range, the pair-batch iterator, the
``.raw`` float32 codec, the flow resize and homography composition, the
colour wheel and host flow renderer, the depth visualisation and its magma
table, the TensorBoard event writer, the dataset loaders, and the CLI's
helpers: the stage banners, the frame-range parser, the sampling mode
names, the image resize and writer, and the small artifact formats of
``io/metadata_io.py``.

Both sides are plain numpy (and OpenCV for the image helpers) computing
the same arithmetic in the same order, so every comparison is exact."""

import os
from os.path import join as pjoin

import numpy as np
import pytest

import synthetic
from consistent_depth_tpu.data import video_dataset as jax_video_dataset
from consistent_depth_tpu.data.video_dataset import (
    PairBatchIterator as JaxPairBatchIterator)
from consistent_depth_tpu.flow import backends as jax_backends
from consistent_depth_tpu.io import image_io as jax_image_io
from consistent_depth_tpu.io import metadata_io as jax_metadata_io
from consistent_depth_tpu.ops import flow_viz as jax_flow_viz
from consistent_depth_tpu.training import summaries as jax_summaries
from consistent_depth_tpu.utils import frame_range as jax_frame_range
from consistent_depth_tpu.utils import frame_sampling as jax_sampling
from consistent_depth_tpu.utils import helpers as jax_helpers
from consistent_depth_tpu.utils import visualization as jax_visualization
from consistent_depth_tpu_torch.data import video_dataset
from consistent_depth_tpu_torch.data.video_dataset import PairBatchIterator
from consistent_depth_tpu_torch.flow import backends
from consistent_depth_tpu_torch.io import image_io, metadata_io
from consistent_depth_tpu_torch.ops import flow_viz
from consistent_depth_tpu_torch.training import summaries
from consistent_depth_tpu_torch.utils import (
    frame_range, frame_sampling, helpers, visualization)


def _pairs(fr, fs, mode, num_frames, two_way, subset):
    rng = fr.FrameRange(fr.OptionalSet(subset), num_frames=num_frames)
    opts = [fs.SamplePairsOptions(fs.SamplePairsMode[mode.name])]
    pairs = fs.SamplePairs.sample(opts, rng, two_way=two_way)
    return sorted(map(tuple, pairs)), sorted(
        map(tuple, fs.SamplePairs.to_one_way(pairs)))


@pytest.mark.parametrize("two_way", [False, True], ids=["one_way", "two_way"])
@pytest.mark.parametrize("num_frames", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("mode", list(jax_sampling.SamplePairsMode),
                         ids=lambda m: m.name.lower())
def test_frame_sampling_matches_jax(mode, num_frames, two_way):
    for subset in (None, set(range(0, num_frames, 3))):
        want = _pairs(jax_frame_range, jax_sampling, mode, num_frames,
                      two_way, subset)
        got = _pairs(frame_range, frame_sampling, mode, num_frames, two_way,
                     subset)
        assert got == want


@pytest.mark.parametrize("num_pairs,batch,seed,shuffle,drop_last", [
    (715, 4, 0, True, False), (10, 4, 3, True, False),
    (10, 4, 3, True, True), (9, 3, 1, False, False), (3, 8, 5, True, False),
])
def test_pair_batch_iterator_matches_jax(num_pairs, batch, seed, shuffle,
                                         drop_last):
    kw = dict(shuffle=shuffle, seed=seed, drop_last=drop_last)
    ours = PairBatchIterator(num_pairs, batch, **kw)
    theirs = JaxPairBatchIterator(num_pairs, batch, **kw)
    assert ours.steps_per_epoch() == theirs.steps_per_epoch()
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        want = list(theirs.epoch(epoch))
        assert len(got) == len(want) == ours.steps_per_epoch()
        for (gi, gv), (wi, wv) in zip(got, want):
            assert gi.dtype == wi.dtype and gv.dtype == wv.dtype
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("shape", [(5, 7), (6, 4, 2), (3, 9, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_raw_float32_round_trip_across_packages(tmp_path, shape, writer):
    img = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    path = str(tmp_path / "im.raw")
    write, read = ((image_io, jax_image_io) if writer == "port"
                   else (jax_image_io, image_io))
    write.save_raw_float32_image(path, img)
    back = read.load_raw_float32_image(path)
    assert back.dtype == np.float32 and back.shape == shape
    np.testing.assert_array_equal(back, img)
    # the same bytes from either writer
    other = str(tmp_path / "other.raw")
    read.save_raw_float32_image(other, img)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("size_wh", [(48, 20), (17, 33)])
def test_resize_flow_matches_jax(size_wh):
    flow = (np.random.default_rng(1).standard_normal((24, 40, 2)) * 3
            ).astype(np.float32)
    np.testing.assert_array_equal(backends.resize_flow(flow, size_wh),
                                  jax_backends.resize_flow(flow, size_wh))


@pytest.mark.parametrize("seed", [0, 1])
def test_compose_homography_flow_matches_jax(seed):
    rng = np.random.default_rng(seed)
    flow = (rng.standard_normal((18, 26, 2)) * 2).astype(np.float32)
    H = np.eye(3) + 0.01 * rng.standard_normal((3, 3))
    np.testing.assert_array_equal(
        backends.compose_homography_flow(flow, H),
        jax_backends.compose_homography_flow(flow, H))


def test_color_wheel_and_host_renderer_match_jax():
    np.testing.assert_array_equal(flow_viz.make_color_wheel(),
                                  jax_flow_viz.make_color_wheel())
    assert flow_viz._UNKNOWN_FLOW_THRESH == jax_flow_viz._UNKNOWN_FLOW_THRESH
    rng = np.random.default_rng(2)
    flow = (rng.standard_normal((20, 30, 2)) * 5).astype(np.float32)
    flow[0, 0] = 1e8          # unknown flow
    flow[1, 1, 0] = np.nan
    got = flow_viz.flow_to_image(flow)
    assert got.dtype == np.uint8 and got.shape == (20, 30, 3)
    np.testing.assert_array_equal(got, jax_flow_viz.flow_to_image(flow))


def test_magma_table_matches_jax():
    lut = jax_visualization._magma_lut()
    assert visualization.MAGMA_LUT.shape == (256, 3)
    assert visualization.MAGMA_LUT.dtype == np.uint8
    np.testing.assert_array_equal(visualization.MAGMA_LUT, lut[:, 0])


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_visualize_depth_matches_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 4.0, (24, 40)).astype(np.float32)
    depth[0, :2] = [np.nan, -1.0]
    for lo, hi in ((None, None), (0.0, 2.0)):
        got = visualization.visualize_depth(depth, lo, hi)
        assert got.dtype == np.uint8 and got.shape == (24, 40, 3)
        np.testing.assert_array_equal(
            got, jax_visualization.visualize_depth(depth, lo, hi))
    for side, module in (("port", visualization), ("jax", jax_visualization)):
        src = tmp_path / side
        src.mkdir()
        for i in range(3):
            image_io.save_raw_float32_image(
                str(src / f"frame_{i:06d}.raw"), depth * (i + 1))
        module.visualize_depth_dir(str(src), str(src), force=True,
                                   min_percentile=1, max_percentile=99)
    for i in range(3):
        name = f"frame_{i:06d}.png"
        assert (_read_bytes(tmp_path / "port" / name)
                == _read_bytes(tmp_path / "jax" / name)), name
        assert cv2.imread(str(tmp_path / "port" / name)).shape == (24, 40, 3)


def test_summary_writer_bytes_match_jax(tmp_path, monkeypatch):
    """The same scalars, images and histogram give the same event-file
    name and bytes from both writers (the clock patched)."""
    rng = np.random.default_rng(4)
    image = rng.random((3, 10, 14), dtype=np.float32)
    grid = summaries.make_image_grid(rng.random((5, 6, 7, 1)), normalize=True)
    values = rng.standard_normal(200)
    files = {}
    for side, module in (("port", summaries), ("jax", jax_summaries)):
        monkeypatch.setattr(module.time, "time", lambda: 1700000000.25)
        log_dir = tmp_path / side
        with module.SummaryWriter(str(log_dir)) as w:
            w.add_scalar("Train/loss", 0.125, 3)
            w.add_scalar("validation/disparity/mean", np.float32(2.5), 7)
            w.add_image("Train/image", image, 3)
            w.add_image("Train/pred_full", grid, 4)
            w.add_histogram("validation/reprojection", values, 7)
        (name,) = os.listdir(log_dir)
        files[side] = (name, _read_bytes(log_dir / name))
    assert files["port"] == files["jax"]


def test_make_image_grid_matches_jax():
    rng = np.random.default_rng(5)
    images = rng.random((11, 6, 7, 3)).astype(np.float32)
    for kw in ({}, {"normalize": True}, {"nrow": 4, "pad": 1}):
        np.testing.assert_array_equal(
            summaries.make_image_grid(images, **kw),
            jax_summaries.make_image_grid(images, **kw))


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dataset"))
    scene = synthetic.make_scene(num_frames=5, H=16, W=32)
    synthetic.write_dataset_dir(path, scene, synthetic.make_pairs(5))
    return path


def test_video_pair_dataset_matches_jax(tiny_dataset):
    meta = pjoin(tiny_dataset, "metadata.npz")
    scales = {i: 1.0 + 0.1 * i for i in range(5)}
    for kw in ({}, {"scales": scales}, {"scales": 2.0}):
        got = video_dataset.VideoPairDataset(tiny_dataset, meta, **kw)
        want = jax_video_dataset.VideoPairDataset(tiny_dataset, meta, **kw)
        assert got.pairs == want.pairs and len(got) == 7
        a, b = got.load(), want.load()
        assert a.num_pairs == b.num_pairs == 7
        for k, v in b.__dict__.items():
            if v is None:
                assert getattr(a, k) is None, k
                continue
            assert getattr(a, k).dtype == v.dtype, k
            np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)
    # without metadata the cameras are zeros
    a = video_dataset.VideoPairDataset(tiny_dataset).load()
    assert not a.intrinsics.any() and a.intrinsics.shape == (7, 2, 4)


def test_video_frame_dataset_matches_jax(tiny_dataset):
    fmt = pjoin(tiny_dataset, "color_down", "frame_{:06d}.raw")
    got = video_dataset.VideoFrameDataset(fmt)
    want = jax_video_dataset.VideoFrameDataset(fmt, range(5))
    assert len(got) == len(want) == 5
    for indices in ([0, 1, 2, 3], [4]):
        (ga, gi), (wa, wi) = got.load_batch(indices), want.load_batch(indices)
        assert gi == wi and ga.dtype == wa.dtype == np.float32
        np.testing.assert_array_equal(ga, wa)
    png = video_dataset.load_color(pjoin(tiny_dataset, "color_down_png",
                                         "frame_000002.png"))
    np.testing.assert_array_equal(png, jax_video_dataset.load_color(
        pjoin(tiny_dataset, "color_down_png", "frame_000002.png")))


def test_banners_match_jax(tmp_path, capsys):
    for module in (helpers, jax_helpers):
        module.print_title("Processing dataset 'x'")
        module.print_banner("Compute flow")
        module.mkdir_ifnotexists(str(tmp_path / "a" / "b"))
        module.mkdir_ifnotexists(str(tmp_path / "a" / "b"))
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "****  Compute flow  ****" in out
    assert os.path.isdir(tmp_path / "a" / "b")


@pytest.mark.parametrize("text", ["", "0", "0,5-7", "3,1,2,9-12,11",
                                  "0-0,4", "5-3", "-1"])
def test_parse_frame_range_matches_jax(text):
    def parse(module):
        try:
            r = module.parse_frame_range(text)
        except ValueError as e:
            return "ValueError", str(e)
        return r.name, r.set.set

    assert parse(frame_range) == parse(jax_frame_range)


def test_sample_pairs_mode_names_match_jax():
    assert frame_sampling.SamplePairsMode.names() == \
        jax_sampling.SamplePairsMode.names()
    assert {k: v.value for k, v in
            frame_sampling.SamplePairsMode.name_mode_map().items()} == {
        k: v.value for k, v in
        jax_sampling.SamplePairsMode.name_mode_map().items()}


@pytest.mark.parametrize("hw,max_size,align", [
    ((37, 53), 24, 16), ((61, 29), 40, 3), ((448, 768), 384, 16),
    ((448, 768), 1024, 64), ((20, 24), 100, 1)])
def test_resize_to_target_matches_jax(hw, max_size, align):
    img = np.random.default_rng(hw[1]).random((*hw, 3), dtype=np.float32)
    np.testing.assert_array_equal(
        image_io.resize_to_target(img, max_size, align=align),
        jax_image_io.resize_to_target(img, max_size, align=align))


@pytest.mark.parametrize("ext", [".png", ".raw"])
def test_save_image_bytes_match_jax(tmp_path, ext):
    img = np.random.default_rng(7).random((9, 11, 3), dtype=np.float32)
    image_io.save_image(str(tmp_path / ("port" + ext)), img)
    jax_image_io.save_image(str(tmp_path / ("jax" + ext)), img)
    assert (_read_bytes(tmp_path / ("port" + ext))
            == _read_bytes(tmp_path / ("jax" + ext)))


def test_metadata_formats_match_jax(tmp_path):
    """Each artifact written by either package reads back the same from
    both, and both writers write the same bytes."""
    rng = np.random.default_rng(8)
    intr = rng.random((4, 4)).astype(np.float32)
    extr = rng.random((4, 3, 4)).astype(np.float32)
    scales = np.stack([np.arange(4.0), rng.random(4)], axis=1)
    pairs = [(0, 1), (1, 0), (2, 3)]
    for side, module in (("port", metadata_io), ("jax", jax_metadata_io)):
        d = tmp_path / side
        d.mkdir()
        module.write_frames_txt(str(d / "frames.txt"), module.FramesTxt(
            3, 768, 448, ["0.000000", "0.033367", "0.066733"]))
        module.write_metadata(str(d / "metadata.npz"), intr, extr,
                              scales=scales)
        module.write_flow_list(str(d / "flow_list.json"), pairs)
        module.write_scales_csv(str(d / "scales.csv"), scales)
    for name in ("frames.txt", "flow_list.json", "scales.csv"):
        assert (_read_bytes(tmp_path / "port" / name)
                == _read_bytes(tmp_path / "jax" / name)), name
    for side in ("port", "jax"):
        d = tmp_path / side
        assert vars(metadata_io.read_frames_txt(str(d / "frames.txt"))) == \
            vars(jax_metadata_io.read_frames_txt(str(d / "frames.txt")))
        meta = metadata_io.read_metadata(str(d / "metadata.npz"))
        for k, v in jax_metadata_io.read_metadata(
                str(d / "metadata.npz")).items():
            np.testing.assert_array_equal(meta[k], v)
        assert metadata_io.read_flow_list(str(d / "flow_list.json")) == \
            jax_metadata_io.read_flow_list(str(d / "flow_list.json")) == \
            pairs
        np.testing.assert_array_equal(
            metadata_io.read_scales_csv(str(d / "scales.csv")), scales)
        assert metadata_io.scales_to_map(scales) == \
            jax_metadata_io.scales_to_map(scales)
