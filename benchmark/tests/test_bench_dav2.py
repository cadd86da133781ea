"""The ``dav2-large`` configuration's parts: the reference's FLOP at the
cell's size against a hand count, the benchmark's weights alike in the
port's network and the reference's, the two roofline readers of the
transformer's spans, the cell's check at a small size (the port passes its
limits, the TF32 control and each planted fault do not), and on the card
the port's linear and attention Functions and a small network against the
reference."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import roofline, spec, weights
from benchmark.reference import common

NAME = "dav2-large"
# a network of the same design, small enough for the CPU: width 64, 2
# heads, 4 blocks tapped at 0-3, head features 16, at 70 x 126 (5 x 9
# patches, the position grid 5 x 5)
SMALL = dict(img_size=70, dim=64, depth=4, heads=2, taps=(0, 1, 2, 3),
             features=16, out_channels=(16, 32, 64, 64))
SMALL_HW = (70, 126)


def _conv(H, W, ci, co, k):
    return 2 * H * W * ci * co * k * k


def test_forward_flop_by_hand():
    """One 518 x 882 frame: a 37 x 63 patch grid, 2332 tokens."""
    ref = spec.reference_module(NAME)
    h0, w0 = 37, 63
    P = h0 * w0
    L = P + 1
    D, F_, heads = 1024, 4096, 16
    linear = 24 * sum(2 * L * i * o for i, o in
                      ((D, 3 * D), (D, D), (D, F_), (F_, D)))
    # the transposed convs, one linear each over the patch pixels
    linear += 2 * P * 256 * 256 * 16 + 2 * P * 512 * 512 * 4
    attention = 24 * 4 * heads * L * L * (D // heads)
    f = 256
    sizes = [(148, 252), (74, 126), (37, 63), (19, 32)]
    conv = _conv(h0, w0, 3, D, 14)                              # patch
    conv += sum(_conv(h0, w0, D, c, 1) for c in (256, 512, 1024, 1024))
    conv += _conv(19, 32, 1024, 1024, 3)                        # stride 2
    conv += sum(_conv(H, W, c, f, 3)
                for (H, W), c in zip(sizes, (256, 512, 1024, 1024)))
    # fusion blocks 4..1: residual units (one in 4, two elsewhere) at the
    # block's input size, out_conv at the size it resizes to
    conv += 2 * _conv(19, 32, f, f, 3) + _conv(37, 63, f, f, 1)
    conv += 4 * _conv(37, 63, f, f, 3) + _conv(74, 126, f, f, 1)
    conv += 4 * _conv(74, 126, f, f, 3) + _conv(148, 252, f, f, 1)
    conv += 4 * _conv(148, 252, f, f, 3) + _conv(296, 504, f, f, 1)
    conv += _conv(296, 504, f, 128, 3)                          # output_conv1
    conv += _conv(518, 882, 128, 32, 3) + _conv(518, 882, 32, 1, 1)
    log = roofline._trace(ref, 1, 518, 882)
    assert (len(log.convs), len(log.linears), len(log.attentions),
            len(log.conv_transposes)) == (31, 98, 24, 0)
    assert sum(p.flop for p in log.linears) == linear
    assert sum(p.flop for p in log.attentions) == attention
    assert sum(p.flop for p in log.convs) == conv
    assert roofline.forward_flop(ref, 518, 882) == linear + attention + conv
    # ~2.44 TFLOP a frame: 1418 linears, 535 attention, 488 convs
    assert round((linear + attention + conv) / 1e9) == 2441
    # the stride-1 3x3 convs the k x k kernels take: 4 transitions, 14
    # residual-unit convs, the two output 3x3s
    assert sum(c.kxk for c in log.convs) == 20
    b = roofline.bounds_s(ref, 8, 518, 882, "f32", backward=True)
    assert b["linear"] > b["attention"] > b["kxk"] > 0


def _small_pair(seed):
    from consistent_depth_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2)

    ref = spec.reference_module(NAME)
    config = spec.configs_of()[NAME]
    net = ref.build(**SMALL)
    port = DepthAnythingV2(**SMALL)
    weights.make(net, seed, ref, config)
    weights.make(port, seed, ref, config)
    return ref, net, port


def test_weights_alike_in_port_and_reference():
    _, net, port = _small_pair(2 ** 31 + 3)
    got = port.state_dict()
    assert got.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(v, got[k]), k
    config = spec.configs_of()[NAME]
    blocks = port.pretrained.blocks
    assert all(bool((b.ls1.gamma == config["layer_scale"]).all())
               and bool((b.ls2.gamma == config["layer_scale"]).all())
               for b in blocks)
    assert float(port.depth_head.scratch.output_conv2[2].bias[0]) == \
        config["output_bias_shift"]
    # the transposed convs' draw: N(0, 1 / Ci)
    w = port.depth_head.resize_layers[1].weight
    assert float(w.std()) == pytest.approx(32 ** -0.5, rel=0.1)


def _record(spans, bounds):
    return {"kind": "train", "window_s": 1.0, "units": 16, "flop": 1e12,
            "peak_flops": 1e15, "steps": 4, "issue_s": 0.5, "setup_s": 2.0,
            "trace": {"window_s": 0.6, "busy_s": 0.5, "device_ops": [],
                      "idle_gaps": [], "spans": spans, "bounds_s": bounds}}


SPANS = {"engine.step": {"device_s": 0.0, "count": 4},
         "linear.forward": {"device_s": 0.4, "count": 392},
         "linear.backward": {"device_s": 0.6, "count": 392},
         "attention.forward": {"device_s": 0.2, "count": 96},
         "attention.backward": {"device_s": 0.3, "count": 96}}
BOUNDS = {"kxk": 0.01, "linear": 0.25, "attention": 0.1}


def test_roofline_readers():
    lin = spec.metric_reader("linear_roofline.train")
    att = spec.metric_reader("attention_roofline.train")
    assert lin.read(_record(SPANS, BOUNDS)) == pytest.approx(25.0)
    assert att.read(_record(SPANS, BOUNDS)) == pytest.approx(20.0)
    # a program without the spans (the parent's), a network without the
    # class, an untraced run, an eval cell: nothing to read
    convs_only = {k: v for k, v in SPANS.items()
                  if not k.startswith(("linear", "attention"))}
    for reader in (lin, att):
        assert reader.read(_record(convs_only, BOUNDS)) is None
        assert reader.read(_record(SPANS, {"kxk": 0.01, "linear": 0.0,
                                           "attention": 0.0})) is None
        untraced = dict(_record(SPANS, BOUNDS), trace=None)
        assert reader.read(untraced) is None
        assert reader.read(dict(_record(SPANS, BOUNDS), kind="eval")) is None


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_transformer_functions_on_the_card(card, dtype, tol):
    """The port's linear and attention, forward and backward, against f64;
    q, k and v as views of one qkv product, as the encoder makes them."""
    from consistent_depth_tpu_torch.ops import transformer

    g = torch.Generator(device=card).manual_seed(7)
    B, L, heads, d = 2, 777, 4, 64
    x = torch.randn((B, L, heads * d), generator=g, device=card)
    w = torch.randn((3 * heads * d, heads * d), generator=g,
                    device=card) * (heads * d) ** -0.5
    b = torch.randn((3 * heads * d,), generator=g, device=card)
    ct = torch.randn((B, L, heads * d), generator=g, device=card)

    def run(x, w, b, lin, att):
        x, w, b = (t.detach().requires_grad_(True) for t in (x, w, b))
        qkv = lin(x, w, b).reshape(B, L, 3, heads, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = att(q, k, v).transpose(1, 2).reshape(B, L, heads * d)
        (o * ct.to(o.dtype)).sum().backward()
        return [t.double() for t in (o, x.grad, w.grad, b.grad)]

    transformer.reset_counts()
    got = run(x.to(dtype), w.to(dtype), b.to(dtype), transformer.linear,
              transformer.attention)
    assert transformer.launch_counts() == (1, 1)
    want = run(x.double(), w.double(), b.double(), F.linear,
               F.scaled_dot_product_attention)
    for name, a, e in zip(("out", "dx", "dw", "db"), got, want):
        gap = float((a - e).abs().max() / e.abs().max())
        assert gap < tol, (name, gap)


@pytest.mark.card
def test_small_network_against_reference_on_the_card(card):
    """The port's network (k x k kernels, cuBLAS, the memory-efficient
    attention) against the reference (cuDNN, cuBLAS, SDPA), f32 TF32 off:
    disparity and the gradients of a scalar of it."""
    _, net, port = _small_pair(11)
    net, port = net.to(card), port.to(card,
                                      memory_format=torch.channels_last)
    common.f32_policy()
    x = torch.rand((4, 3, *SMALL_HW), generator=torch.Generator(
        device=card).manual_seed(3), device=card)
    d_ref, d_port = net(x), port(x)
    gap = float((d_port - d_ref).abs().max() / d_ref.abs().max())
    assert gap < 1e-4, gap
    (1.0 / d_ref).sum().backward()
    (1.0 / d_port).sum().backward()
    got = dict(port.named_parameters())
    for k, p in net.named_parameters():
        if p.grad is None:
            assert got[k].grad is None, k
            continue
        gap = float((got[k].grad - p.grad).norm() / p.grad.norm())
        assert gap < 1e-3, (k, gap)


@pytest.fixture
def small_cell(monkeypatch):
    """The ``dav2-large-finetune-f32`` cell with the network of SMALL on
    both sides, 12 frames at 70 x 126, batch 2, and the cell's own
    limits."""
    from consistent_depth_tpu_torch.models import depth_anything_v2 as da

    cell = spec.load_cell(NAME + "-finetune-f32")
    cell.traffic.update(frames=12, batch=2)
    cell.config["size"] = list(SMALL_HW)
    build = cell.reference.build
    monkeypatch.setattr(cell.reference, "build",
                        lambda **kw: build(**{**SMALL, **kw}))
    monkeypatch.setattr(da.DepthAnythingV2Model, "_make_module",
                        lambda self: da.DepthAnythingV2(**SMALL))
    with torch.device("meta"):
        cell.config["parameters"] = sum(
            p.numel() for p in da.DepthAnythingV2(**SMALL).parameters())
    return cell


@pytest.mark.parametrize("rounding,fault,correct", [
    (None, None, True), ("tf32", None, False), (None, "half_batch", False),
    (None, "altered", False), (None, "unchanged", False)])
def test_check_at_a_small_size(small_cell, rounding, fault, correct):
    """The whole entry on the CPU: the port passes the cell's limits, and
    the control and each planted fault do not."""
    from benchmark.harness import faults, runner

    with faults.planted(fault):
        out = runner.run_cell(small_cell, 2 ** 31 + 57, 0.1, False, "cpu",
                              rounding=rounding)
    assert out.result["correct"] is correct, out.result["checks"]
    assert out.result["attempted"] > 0 and out.result["failed"] == 0
