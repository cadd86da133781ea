"""Port's DepthServer (plain path on the CPU, f32) against the JAX
package's DepthServer (f32) on the same weights and frames.

Covers a ragged last batch, two resolution buckets with an unaligned frame
size, interleaved infer_videos, flush_max_wait ordering and a dispatch
pipeline deeper than one batch. Tolerance on depth: f32, rtol = atol =
1e-4 (the hourglass parity band of tests/test_hourglass.py; depth is
exp(log-depth), so its relative error is the log-depth's absolute error).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consistent_depth_tpu.models import layers as jax_layers
from consistent_depth_tpu.models.hourglass import HourglassModel as JaxHourglass
from consistent_depth_tpu.models.mannequin_challenge import (
    MannequinChallengeModel as JaxMC,
)
from consistent_depth_tpu.serving import (
    DepthServer as JaxServer,
    ServeConfig as JaxConfig,
)
from consistent_depth_tpu_torch.models import torch_import
from consistent_depth_tpu_torch.models.mannequin_challenge import (
    MannequinChallengeModel,
)
from consistent_depth_tpu_torch.serving import DepthServer, ServeConfig
from test_torch_hourglass import randomize_batch_stats

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    variables = JaxHourglass().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False)
    variables = randomize_batch_stats(variables, seed=1)
    jax_model = JaxMC(variables=variables)
    port = MannequinChallengeModel(checkpoint="", device="cpu")
    sd = torch_import.state_dict_from_jax_variables(variables)
    port.net.load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    yield jax_model, port
    jax_layers.set_compute_dtype(None)


def _servers(models, **kw):
    jax_model, port = models
    kw.setdefault("batch_size", 2)
    ours = DepthServer(ServeConfig(precision="f32", device="cpu", **kw),
                       model=port)
    theirs = JaxServer(JaxConfig(precision="f32", **kw), model=jax_model)
    return ours, theirs


def _assert_same_stream(ours, theirs):
    """Both streams yield the same keys in the same order, with depths
    within tolerance."""
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (key, a), (_, b) in zip(ours, theirs):
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, err_msg=str(key), **TOL)


def test_infer_frames_ragged_last_batch(models):
    frames = np.random.default_rng(0).random((5, 32, 48, 3), np.float32)
    ours, theirs = _servers(models)
    got = ours.infer_frames(frames)       # 3 batches, the last padded
    assert got.shape == (5, 32, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, theirs.infer_frames(frames), **TOL)


def test_multi_resolution_buckets(models):
    """An unaligned size is edge-padded to the aligned bucket and the
    depth cropped back; two resolutions use two buckets."""
    rng = np.random.default_rng(1)
    reqs = [("s0", rng.random((30, 44, 3), np.float32)),
            ("b0", rng.random((48, 64, 3), np.float32)),
            ("s1", rng.random((30, 44, 3), np.float32)),
            ("b1", rng.random((48, 64, 3), np.float32))]
    ours, theirs = _servers(models)
    got = list(ours.serve(iter(reqs)))
    assert dict(got)["s0"].shape == (30, 44)
    assert dict(got)["b1"].shape == (48, 64)
    _assert_same_stream(got, list(theirs.serve(iter(reqs))))


def test_infer_videos_interleaved(models):
    rng = np.random.default_rng(2)
    videos = {"a": rng.random((3, 32, 48, 3), np.float32),
              "b": rng.random((5, 32, 48, 3), np.float32)}
    ours, theirs = _servers(models)
    got, want = ours.infer_videos(videos), theirs.infer_videos(videos)
    for vid, frames in videos.items():
        assert got[vid].shape == frames.shape[:3]
        np.testing.assert_allclose(got[vid], want[vid], **TOL)


def test_flush_max_wait_order(models):
    """A straggler bucket is flushed after flush_max_wait foreign requests
    instead of at the end of the stream, in the JAX server's order."""
    rng = np.random.default_rng(4)
    reqs = [("s0", rng.random((32, 48, 3), np.float32))] + [
        (f"b{i}", rng.random((64, 64, 3), np.float32)) for i in range(6)]
    ours, theirs = _servers(models, flush_max_wait=2)
    got = list(ours.serve(iter(reqs)))
    order = [k for k, _ in got]
    assert order.index("s0") < order.index("b4")
    _assert_same_stream(got, list(theirs.serve(iter(reqs))))


def test_max_in_flight_deeper_pipeline(models):
    frames = np.random.default_rng(5).random((7, 32, 48, 3), np.float32)
    ours, theirs = _servers(models, max_in_flight=3)
    shallow, _ = _servers(models, max_in_flight=1)
    got = ours.infer_frames(frames)
    np.testing.assert_allclose(got, shallow.infer_frames(frames),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got, theirs.infer_frames(frames), **TOL)


def test_bf16_results_travel_as_f16(models):
    """Under bf16 the result buffer is f16 and the caller gets f32 depth
    close to the f32 server's (relative L2 band of tests/test_bf16.py)."""
    _, port = models
    frames = np.random.default_rng(6).random((3, 32, 48, 3), np.float32)
    f32 = DepthServer(ServeConfig(precision="f32", device="cpu",
                                  batch_size=2), model=port)
    want = f32.infer_frames(frames)
    try:
        bf16 = DepthServer(ServeConfig(precision="bf16", device="cpu",
                                       batch_size=2), model=port)
        flight = bf16._dispatch(list(frames[:2]), (32, 48), [0, 1])
        assert flight.host_out.dtype == torch.float16
        got = bf16.infer_frames(frames)
    finally:
        port.to("cpu", torch.float32)   # the model is shared by the module
    assert got.dtype == np.float32
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.05
