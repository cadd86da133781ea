"""The port's copies of the JAX package's host helpers against the
originals: pair sampling over a frame range, the pair-batch iterator, the
``.raw`` float32 codec, the flow resize and homography composition, and
the colour wheel and host flow renderer.

Both sides are plain numpy (and OpenCV for the flow helpers) computing the
same arithmetic in the same order, so every comparison is exact."""

import numpy as np
import pytest

from consistent_depth_tpu.data.video_dataset import (
    PairBatchIterator as JaxPairBatchIterator)
from consistent_depth_tpu.flow import backends as jax_backends
from consistent_depth_tpu.io import image_io as jax_image_io
from consistent_depth_tpu.ops import flow_viz as jax_flow_viz
from consistent_depth_tpu.utils import frame_range as jax_frame_range
from consistent_depth_tpu.utils import frame_sampling as jax_sampling
from consistent_depth_tpu_torch.data.video_dataset import PairBatchIterator
from consistent_depth_tpu_torch.flow import backends
from consistent_depth_tpu_torch.io import image_io
from consistent_depth_tpu_torch.ops import flow_viz
from consistent_depth_tpu_torch.utils import frame_range, frame_sampling


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
