"""Depth Anything V2-Large (``dav2-large``, ``models/depth_anything_v2.py``
and ``models/vit.py``) in the port, on the CPU. The JAX package has no
transformer, so the port is held against the benchmark's plain reference
(``benchmark/reference/dav2-large.py``, written from the published code),
on the benchmark's seeded weights.

- At the published widths and depth, on the meta device: 335,315,649
  parameters (304,368,640 in the encoder, 30,947,009 in the head), the
  released key names, the same keys and shapes as the reference.
- The offset-bicubic position resize: the learned grid returned as it is
  for a square 518 x 518 input, 37 x 63 positions at 518 x 882, equal to the
  reference's resize and not to a resize to that size without the offset.
- ``init_parameters`` fills every parameter (each first set to NaN) with
  DINOv2's values, and a seed fixes them.
- A network of the same design at a small size (width 64, 2 heads, 4
  blocks tapped at 0-3, head features 16) at 70 x 126: depth and the
  gradients of a loss of it against the reference. Both compute in f32 with
  the library's CPU kernels (the port's convs channels_last, the
  reference's NCHW; both attentions on the CPU flash kernel), so the
  gaps are summation order only: depth within 2e-6 of the largest value
  (measured 1.4e-7 over three seeds; f32's epsilon is 1.2e-7), each
  parameter's gradient of a weighted mean log-depth within 3e-4 of its
  norm (measured 2.0e-6-7.5e-5, the worst leaf of three seeds; the
  reference's own f32 gradients lie 2.8e-4-3.4e-3 from its f64 ones).
- The training engine gives ``mask_token`` and ``refinenet4.resConfUnit1``,
  never used, an exact zero gradient, and Adam leaves them as they were.
- The spans and ``ops/transformer.py::launch_counts``: 4 linears and 1
  attention a block, the two transposed convs counted as linears, each
  forward and backward in its span; none entered with tracing off.
- midas2's ``FeatureFusionBlock`` (now with an optional ``out_conv`` and
  ``size``): its keys, and its output bitwise that of the block before.
- The small network through ``DepthServer``, a bf16 ``train_epoch`` and an
  ``eval_epoch``, and the CLI's ``--model_type dav2-large`` (one epoch on
  the synthetic dataset, whose 32 x 48 frames it feeds at 28 x 42).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import synthetic
from benchmark.harness import spec, weights
from benchmark.reference import common
from consistent_depth_tpu_torch.models import depth_anything_v2 as da
from consistent_depth_tpu_torch.models import layers, midas_v2, vit
from consistent_depth_tpu_torch.ops import transformer
from consistent_depth_tpu_torch.ops.losses import LossWeights
from consistent_depth_tpu_torch.training import (
    TrainingEngine, create_optimizer)
from consistent_depth_tpu_torch.utils import tracing

NAME = "dav2-large"
SMALL = dict(img_size=70, dim=64, depth=4, heads=2, taps=(0, 1, 2, 3),
             features=16, out_channels=(16, 32, 64, 64))
H, W = 70, 126
# each block: qkv, proj, fc1, fc2; the head: the two transposed convs
LINEARS = 4 * SMALL["depth"] + 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    """``dav2-large`` built at SMALL wherever the port builds it."""
    monkeypatch.setattr(da.DepthAnythingV2Model, "_make_module",
                        lambda self: da.DepthAnythingV2(**SMALL))


def _reference():
    return spec.reference_module(NAME), spec.configs_of()[NAME]


def _seeded_model(seed=4):
    """The small port model with the benchmark's weights (LayerScale 1,
    the output conv tamed)."""
    ref, config = _reference()
    model = da.DepthAnythingV2Model(checkpoint="", device="cpu")
    weights.make(model.net, seed, ref, config)
    return model


def test_published_size_on_meta():
    ref, config = _reference()
    with torch.device("meta"):
        net = da.DepthAnythingV2()
        want = ref.build()

    def count(m):
        return sum(p.numel() for p in m.parameters())

    assert count(net) == config["parameters"] == 335315649
    assert count(net.pretrained) == 304368640
    assert count(net.depth_head) == 30947009
    got = {k: v.shape for k, v in net.state_dict().items()}
    assert got == {k: v.shape for k, v in want.state_dict().items()}
    # published widths: nothing cut
    assert len(net.pretrained.blocks) == 24 and net.taps == (4, 11, 17, 23)
    attn = net.pretrained.blocks[0].attn
    assert attn.heads == 16 and attn.qkv.weight.shape == (3072, 1024)
    assert net.pretrained.blocks[0].mlp.fc1.weight.shape == (4096, 1024)
    assert net.pretrained.pos_embed.shape == (1, 1 + 37 * 37, 1024)
    assert net.depth_head.scratch.layer1_rn.weight.shape == (256, 256, 3, 3)
    assert not list(net.buffers())


def test_released_key_names():
    with torch.device("meta"):
        keys = set(da.DepthAnythingV2().state_dict())
    block = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
             "attn.proj.weight", "attn.proj.bias", "ls1.gamma", "norm2.weight",
             "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
             "mlp.fc2.bias", "ls2.gamma")
    want = {f"pretrained.{k}" for k in (
        "patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token",
        "pos_embed", "mask_token", "norm.weight", "norm.bias")}
    want |= {f"pretrained.blocks.{i}.{k}" for i in range(24) for k in block}
    head = [f"projects.{i}" for i in range(4)] + [
        f"resize_layers.{i}" for i in (0, 1, 3)] + [
        f"scratch.refinenet{i}.{u}.conv{c}" for i in range(1, 5)
        for u in ("resConfUnit1", "resConfUnit2") for c in (1, 2)] + [
        f"scratch.refinenet{i}.out_conv" for i in range(1, 5)] + [
        "scratch.output_conv1", "scratch.output_conv2.0",
        "scratch.output_conv2.2"]
    want |= {f"depth_head.{m}.{p}" for m in head for p in ("weight", "bias")}
    want |= {f"depth_head.scratch.layer{i}_rn.weight" for i in range(1, 5)}
    assert keys == want


def test_offset_bicubic_position_resize():
    ref, _ = _reference()
    enc = vit.DinoVisionTransformer(img_size=518, dim=8, depth=1, heads=2)
    layers.init_parameters(enc, torch.Generator().manual_seed(1))
    # a square input of the grid's own size: the learned grid as it is
    assert enc.interpolate_pos_encoding(37 * 37, 518, 518) is enc.pos_embed
    got = enc.interpolate_pos_encoding(37 * 63, 518, 882)
    assert got.shape == (1, 1 + 37 * 63, 8)
    assert torch.equal(got[:, 0], enc.pos_embed[:, 0])
    # the reference's resize, written from the published code
    r = ref.DinoVisionTransformer(518, 8, 1, 2)
    r.pos_embed = enc.pos_embed
    want = r.interpolate_pos_encoding(torch.empty(1, 1 + 37 * 63, 8), 518, 882)
    assert torch.equal(got, want)
    # the offset moves the sample points: not the resize to 37 x 63
    grid = enc.pos_embed[:, 1:].reshape(1, 37, 37, 8).permute(0, 3, 1, 2)
    by_size = F.interpolate(grid, size=(37, 63), mode="bicubic",
                            align_corners=False)
    by_size = by_size.permute(0, 2, 3, 1).reshape(1, -1, 8)
    assert not torch.allclose(got[:, 1:], by_size, atol=1e-6)


def test_init_parameters_fills_every_parameter():
    def init(seed):
        with torch.device("meta"):
            net = da.DepthAnythingV2(**SMALL)
        net = net.to_empty(device="cpu")
        for p in net.parameters():
            p.data.fill_(float("nan"))
        layers.init_parameters(net, torch.Generator().manual_seed(seed))
        return net

    net = init(3)
    state = net.state_dict()
    assert all(bool(torch.isfinite(v).all()) for v in state.values())
    again = init(3).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in state.items())
    other = init(4).state_dict()
    assert not torch.equal(other["pretrained.pos_embed"],
                           state["pretrained.pos_embed"])
    enc = net.pretrained
    assert bool((enc.blocks[0].ls1.gamma == 1.0).all())
    assert not enc.mask_token.any()
    assert bool((enc.norm.weight == 1).all()) and not enc.norm.bias.any()
    qkv = enc.blocks[1].attn.qkv
    assert not qkv.bias.any() and float(qkv.weight.abs().max()) <= 0.04
    assert float(qkv.weight.std()) == pytest.approx(0.02 * 0.88, rel=0.1)
    assert 0 < float(enc.cls_token.abs().max()) < 1e-5
    assert float(enc.pos_embed.std()) == pytest.approx(0.02 * 0.88, rel=0.1)


@pytest.mark.parametrize("seed", [4, 2 ** 31 + 7])
def test_port_against_reference(small, seed):
    ref, config = _reference()
    model = _seeded_model(seed)
    net = ref.build(**SMALL)
    weights.make(net, seed, ref, config)
    common.f32_policy()
    images = torch.rand((2, 2, H, W, 3),
                        generator=torch.Generator().manual_seed(seed))
    got = model.apply(images, train=True)
    want = ref.depth(net, images)
    assert got.shape == want.shape == (2, 2, H, W)
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap < 2e-6, gap
    weight = torch.linspace(0.5, 1.5, H * W).reshape(H, W)
    (torch.log(got) * weight).mean().backward()
    (torch.log(want) * weight).mean().backward()
    port = model.parameters()
    for k, p in net.named_parameters():
        if p.grad is None:
            assert port[k].grad is None, k
            continue
        gap = float((port[k].grad - p.grad).norm() / p.grad.norm())
        assert gap < 3e-4, (k, gap)


@pytest.fixture(scope="module")
def scene_data():
    scene = synthetic.make_scene(num_frames=4, H=H, W=W)
    return synthetic.build_pair_arrays(scene, synthetic.make_pairs(4))


def _engine(model, precision="f32"):
    ref, config = _reference()
    return TrainingEngine(
        model, create_optimizer("Adam", config["learning_rate"]),
        LossWeights(lambda_view_baseline=config["lambda_view_baseline"]),
        precision=precision)


UNUSED = ("pretrained.mask_token",
          "depth_head.scratch.refinenet4.resConfUnit1.")


def test_unused_parameters_get_exact_zero_gradients(small, scene_data):
    engine = _engine(_seeded_model())
    before = {k: p.detach().clone() for k, p in engine.params.items()}
    out = engine.train_epoch(engine.put_data(scene_data),
                             np.array([[0, 1]]), np.ones((1, 2), np.float32))
    assert not bool(out["skipped_nan"].any())
    unused = [k for k in engine.params if k.startswith(UNUSED)]
    assert len(unused) == 5
    for k in unused:
        p = engine.params[k]
        assert p.grad is not None and not p.grad.any(), k
        assert torch.equal(p, before[k]), k
    assert not torch.equal(engine.params["pretrained.cls_token"],
                           before["pretrained.cls_token"])


def test_spans_and_launch_counts(small, scene_data, monkeypatch):
    engine = _engine(_seeded_model())
    data = engine.put_data(scene_data)
    idx, valid = np.array([[0, 1]]), np.ones((1, 2), np.float32)
    transformer.reset_counts()
    with tracing.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.train_epoch(data, idx, valid)
    # one forward of the batch's 4 frames
    assert transformer.launch_counts() == (LINEARS, SMALL["depth"])
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    count = {n: sum(e[0] == n for e in events) for n in (
        tracing.LINEAR_FORWARD, tracing.LINEAR_BACKWARD,
        tracing.ATTENTION_FORWARD, tracing.ATTENTION_BACKWARD)}
    assert count == {tracing.LINEAR_FORWARD: LINEARS,
                     tracing.LINEAR_BACKWARD: LINEARS,
                     tracing.ATTENTION_FORWARD: SMALL["depth"],
                     tracing.ATTENTION_BACKWARD: SMALL["depth"]}

    def inside(child, parent):
        ps = [e for e in events if e[0] == parent]
        return all(any(p[1] <= c[1] and c[2] <= p[2] for p in ps)
                   for c in events if c[0] == child)

    for child, parent in ((tracing.LINEAR_FORWARD, tracing.STEP_FORWARD),
                          (tracing.ATTENTION_FORWARD, tracing.STEP_FORWARD),
                          (tracing.LINEAR_BACKWARD, tracing.STEP_BACKWARD),
                          (tracing.ATTENTION_BACKWARD,
                           tracing.STEP_BACKWARD)):
        assert inside(child, parent), (child, parent)

    def refuse(*args, **kwargs):
        raise AssertionError("a span entered record_function with tracing "
                             "off")

    monkeypatch.setattr(tracing, "record_function", refuse)
    transformer.reset_counts()
    with torch.no_grad():
        engine.model.apply(data["frames"][None, :2])
    assert transformer.launch_counts() == (LINEARS, SMALL["depth"])


def _old_fusion_forward(block, x, skip=None):
    """``FeatureFusionBlock.forward`` before it took ``out_conv`` and
    ``size`` (frozen copy)."""
    if skip is not None:
        x = x + block.resConfUnit1(skip)
    y = block.resConfUnit2(x)
    h, w = y.shape[2:]
    return F.interpolate(y, size=(2 * h, 2 * w), mode="bilinear",
                         align_corners=True)


def test_midas_fusion_block_unchanged():
    block = midas_v2.FeatureFusionBlock(16)
    layers.init_parameters(block, torch.Generator().manual_seed(5))
    assert not any(k.startswith("out_conv") for k in block.state_dict())
    g = torch.Generator().manual_seed(6)
    x, skip = (torch.randn((2, 16, 6, 10), generator=g) for _ in range(2))
    with torch.no_grad():
        assert torch.equal(block(x, skip), _old_fusion_forward(block, x, skip))
        assert torch.equal(block(x), _old_fusion_forward(block, x))
    with torch.device("meta"):
        midas = midas_v2.MidasNet()
    assert not any("out_conv" in k for k in midas.state_dict())


def test_serving_and_engine_passes(small, scene_data):
    from consistent_depth_tpu_torch.serving.server import (
        DepthServer, ServeConfig)

    model = _seeded_model()
    server = DepthServer(ServeConfig(model_type=NAME, precision="f32",
                                     batch_size=2, device="cpu"),
                         model=model)
    assert server.align == 14
    rng = np.random.default_rng(0)
    frames = [rng.random((60, 120, 3), dtype=np.float32) for _ in range(3)]
    out = dict(server.serve(enumerate(frames)))
    assert sorted(out) == [0, 1, 2]
    assert all(d.shape == (60, 120) and np.isfinite(d).all()
               for d in out.values())
    # the served depth is the model's on the frame padded to 70 x 126
    padded = np.pad(frames[0], ((0, 10), (0, 6), (0, 0)), mode="edge")
    with torch.no_grad():
        want = model.apply(torch.from_numpy(padded)[None, None])[0, 0]
    np.testing.assert_allclose(out[0], want[:60, :120].numpy(), rtol=1e-5)

    for precision in ("bf16", "f32"):
        engine = _engine(_seeded_model(), precision)
        data = engine.put_data(scene_data)
        train = engine.train_epoch(data, np.array([[0, 1], [2, 3]]),
                                   np.ones((2, 2), np.float32))
        ev = engine.eval_epoch(data, np.array([[0, 1], [2, 3]]),
                               np.ones((2, 2), np.float32))
        assert bool(torch.isfinite(train["loss"]).all()), precision
        assert not bool(train["skipped_nan"].any()), precision
        assert bool(torch.isfinite(ev["loss"]).all()), precision


def test_cli_model_type(small, tmp_path, monkeypatch):
    from consistent_depth_tpu_torch.cli import main as cli_main

    ckpt_dir = tmp_path / "checkpoints"
    ckpt_dir.mkdir()
    _seeded_model().save(str(ckpt_dir / "depth_anything_v2_vitl.pth"))
    monkeypatch.setenv("CDTPU_CHECKPOINT_DIR", str(ckpt_dir))
    path = str(tmp_path / "video")
    os.makedirs(path)
    synthetic.build_e2e_dataset(path)
    args = ["--path", path, "--batch_size", "2", "--num_epochs", "1",
            "--model_type", NAME]
    initial_depth_dir, out_dir, frames = cli_main.main(args, device="cpu")
    assert frames == list(range(6))
    # the backbone's own learning rate and disparity weight
    assert os.path.basename(out_dir) == "B0.0001_R1.0_PL1-0_LR5e-06_BS2_Oadam"
    depth_files = sorted(os.listdir(os.path.join(out_dir, "depth")))
    assert len([f for f in depth_files if f.endswith(".raw")]) == 6
