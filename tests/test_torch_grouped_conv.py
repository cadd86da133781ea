"""The port's grouped 3x3 conv (``consistent_depth_tpu_torch/ops/
grouped_conv.py``) on the CPU, where its grad-weight is the plain version
that stands in for ``csrc/grouped_wgrad.cu``.

- ``grouped_conv``'s output, grad-input, grad-weight and grad-bias against
  ``nn.Conv2d(groups=32)`` autograd at midas2's seven classes (ResNeXt-101
  32x8d's ``Bottleneck.conv2``: 256 channels at stride 1, 512 and 1024 and
  2048 at strides 2 and 1) on a small odd image, f32 and f64, with and
  without a bias. Both sides sum the same products in another order: f32
  within 1e-5 of the largest value, f64 within 1e-12.
- The plain grad-weight against ``torch.nn.grad.conv2d_weight``.
- The kernel's split plan: every output pixel in exactly one split, at the
  classes at 224x384 batch 8 and at odd sizes, and the workspace's size.
- The routing: exactly the 33 ``Bottleneck.conv2`` of ``MidasNet()`` are
  ``grouped``; no conv of the hourglass, the ResNet-18 or MiDaS's decoder.
- The counters, the C entry's declaration against ``ops/_cuda.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from consistent_depth_tpu_torch.models import hourglass, layers, midas_v2
from consistent_depth_tpu_torch.models.resnet import (
    Bottleneck, ResNet18Features)
from consistent_depth_tpu_torch.ops import _cuda
from consistent_depth_tpu_torch.ops import grouped_conv as gc

GROUPS = 32
# midas2's classes: (channels, stride, input height and width at 224x384)
CLASSES = [(256, 1, 56, 96), (512, 2, 56, 96), (512, 1, 28, 48),
           (1024, 2, 28, 48), (1024, 1, 14, 24), (2048, 2, 14, 24),
           (2048, 1, 7, 12)]
CLASS_IDS = [f"c{c}_s{s}" for c, s, _, _ in CLASSES]
SMALL = (2, 7, 9)   # batch, odd height and width
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _inputs(C, stride, dtype, seed, size=SMALL):
    N, H, W = size
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, C, H, W), generator=g, dtype=dtype)
    w = torch.randn((C, C // GROUPS, 3, 3), generator=g, dtype=dtype) / 12
    b = torch.randn((C,), generator=g, dtype=dtype)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    ct = torch.randn((N, C, ho, wo), generator=g, dtype=dtype)
    cl = torch.channels_last
    return x.to(memory_format=cl), w.to(memory_format=cl), b, \
        ct.to(memory_format=cl)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("C,stride,H,W", CLASSES, ids=CLASS_IDS)
def test_grouped_conv_matches_conv2d(C, stride, H, W, dtype, bias):
    x, w, b, ct = _inputs(C, stride, dtype, seed=C + stride)
    conv = torch.nn.Conv2d(C, C, 3, stride, 1, groups=GROUPS, bias=bias,
                           dtype=dtype)
    with torch.no_grad():
        conv.weight.copy_(w)
        if bias:
            conv.bias.copy_(b)
    xa = x.clone().requires_grad_()
    want = conv(xa)
    want.backward(ct)

    xb = x.clone().requires_grad_()
    wb = w.clone().requires_grad_()
    bb = b.clone().requires_grad_() if bias else None
    before = gc.route_counts["plain"]
    got = gc.grouped_conv(xb, wb, bb, stride, GROUPS)
    got.backward(ct)
    assert gc.route_counts["plain"] == before + 1
    assert got.shape == want.shape
    tol = TOL[dtype]
    assert _rel(got.detach(), want.detach()) <= tol
    assert _rel(xb.grad, xa.grad) <= tol
    assert _rel(wb.grad, conv.weight.grad) <= tol
    assert wb.grad.dtype == dtype
    if bias:
        assert _rel(bb.grad, conv.bias.grad) <= tol


@pytest.mark.parametrize("C,stride,H,W", CLASSES, ids=CLASS_IDS)
def test_reference_matches_conv2d_weight(C, stride, H, W):
    x, w, _, ct = _inputs(C, stride, torch.float64, seed=7 * C + stride)
    want = torch.nn.grad.conv2d_weight(x, w.shape, ct, stride=stride,
                                       padding=1, groups=GROUPS)
    got = gc.grouped_conv_grad_weight_reference(x, ct, stride, GROUPS)
    assert got.shape == (C, C // GROUPS, 3, 3)
    assert _rel(got, want) <= TOL[torch.float64]
    # bf16 inputs sum in f32 and round once
    xb, cb = x.to(torch.bfloat16), ct.to(torch.bfloat16)
    got16 = gc.grouped_conv_grad_weight_reference(xb, cb, stride, GROUPS)
    want16 = torch.nn.grad.conv2d_weight(
        xb.double(), w.shape, cb.double(), stride=stride, padding=1,
        groups=GROUPS)
    assert got16.dtype == torch.bfloat16
    assert _rel(got16.double(), want16) <= 2 ** -8


def test_grouped_conv_without_grad_is_conv2d():
    """With no input needing a gradient (eval, serving) the call is
    ``F.conv2d`` itself, and counts nothing."""
    x, w, b, _ = _inputs(256, 2, torch.float32, seed=3)
    gc.reset_counts()
    got = gc.grouped_conv(x, w, b, 2, GROUPS)
    assert torch.equal(got, F.conv2d(x, w, b, 2, 1, 1, GROUPS))
    with torch.no_grad():
        got = gc.grouped_conv(x, w.requires_grad_(), b, 2, GROUPS)
    assert torch.equal(got, F.conv2d(x, w, b, 2, 1, 1, GROUPS))
    assert gc.launch_count() == 0


def test_bf16_classes_stay_on_the_library():
    """Off the CPU only f32 takes the grad-weight's route (the kernel);
    bf16 and f64 stay on the library, a meta tensor standing in for the
    card's. On the CPU every dtype takes the plain version."""
    for dtype, routed in ((torch.float32, True), (torch.bfloat16, False),
                          (torch.float64, False)):
        assert gc._routed(torch.empty(1, device="meta", dtype=dtype)) == (
            routed)
        assert gc._routed(torch.empty(1, dtype=dtype))
    x, w, _, ct = _inputs(512, 2, torch.bfloat16, seed=5)
    wg = w.clone().requires_grad_()
    gc.grouped_conv(x, wg, None, 2, GROUPS).backward(ct)
    want = gc.grouped_conv_grad_weight_reference(x, ct, 2, GROUPS)
    assert torch.equal(wg.grad, want)


def _segment_pixels(plan, seg):
    """(n, y, x0, count) of segment ``seg``: ``count`` output pixels of
    row y of image n from column x0, as csrc/grouped_wgrad.cu decodes it
    (``decode`` and ``nv`` in grouped_wgrad_kernel)."""
    t, xs = divmod(seg, -(-plan.wo // gc.TILE_X))
    n, y = divmod(t, plan.ho)
    x0 = xs * gc.TILE_X
    return n, y, x0, min(gc.TILE_X, plan.wo - x0)


def _plan_cover(plan, N):
    """How often each output pixel falls in a split of ``plan``, as the
    kernel walks its segments: block b sums segments [segments * b //
    splits, segments * (b + 1) // splits)."""
    hits = np.zeros((N, plan.ho, plan.wo), np.int64)
    for b in range(plan.splits):
        lo = plan.segments * b // plan.splits
        hi = plan.segments * (b + 1) // plan.splits
        assert hi > lo
        for seg in range(lo, hi):
            n, y, x0, count = _segment_pixels(plan, seg)
            assert 0 < count <= gc.TILE_X
            hits[n, y, x0:x0 + count] += 1
    return hits


@pytest.mark.parametrize(
    "size", [(8, None, None), (1, 7, 9), (3, 13, 37), (1, 1, 1),
             (2, 3, 61), (5, 17, 8)],
    ids=["224x384_b8", "odd_7x9", "odd_13x37", "one_pixel", "wide_3x61",
         "tile_17x8"])
def test_plan_covers_every_pixel_once(size):
    N, h, w = size
    for C, stride, H, W in CLASSES:
        H, W = (H, W) if h is None else (h, w)
        plan = gc._plan(N, H, W, C, GROUPS, stride)
        cg = C // GROUPS
        assert (plan.ho, plan.wo) == ((H - 1) // stride + 1,
                                      (W - 1) // stride + 1)
        assert plan.segments == N * plan.ho * -(-plan.wo // gc.TILE_X)
        assert (_plan_cover(plan, N) == 1).all()
        # one f32 partial of dW a split, each block's 9 warps x 32 lanes
        # x 64 sums
        assert plan.workspace == plan.splits * C * cg * 9
        assert plan.workspace == (plan.splits * plan.channel_blocks
                                  * gc.TAPS * gc.LANES * 64)
        per_sm = min(gc.MAX_BLOCKS_PER_SM, gc.SMEM_PER_SM // (
            plan.smem + gc.SMEM_PER_BLOCK_RESERVED))
        assert per_sm >= 1
        assert plan.splits == min(plan.segments, round(
            gc.WAVES * gc.SMS * per_sm / plan.channel_blocks))


def test_plan_at_midas2_shapes():
    """The f32 splits at batch 8 and 224x384, the workspace bytes and
    the shared bytes a block of the two stages asks for."""
    want = {(256, 1): (264, 1, 77824), (512, 2): (66, 4, 60416),
            (512, 1): (66, 4, 38912), (1024, 2): (16, 16, 30208),
            (1024, 1): (16, 16, 19456), (2048, 2): (4, 64, 17152),
            (2048, 1): (4, 64, 11776)}
    for C, stride, H, W in CLASSES:
        plan = gc._plan(8, H, W, C, GROUPS, stride)
        assert (plan.splits, plan.channel_blocks, plan.smem) == want[
            (C, stride)]
        assert 4 * plan.workspace <= 20 * 2 ** 20


def test_takes():
    ok = dict(in_channels=256, out_channels=256, kernel_size=(3, 3),
              stride=(1, 1), padding=(1, 1), dilation=(1, 1), groups=32,
              padding_mode="zeros")
    assert gc.takes(**ok)
    assert gc.takes(**{**ok, "stride": (2, 2)})
    assert gc.takes(**{**ok, "in_channels": 2048, "out_channels": 2048})
    for change in ({"groups": 1}, {"kernel_size": (5, 5)},
                   {"stride": (3, 3)}, {"stride": (1, 2)},
                   {"padding": (0, 0)}, {"dilation": (2, 2)},
                   {"padding_mode": "reflect"}, {"out_channels": 512},
                   {"in_channels": 128, "out_channels": 128},
                   {"in_channels": 768, "out_channels": 768},
                   {"groups": 16, "in_channels": 128,
                    "out_channels": 128}):
        assert not gc.takes(**{**ok, **change}), change


def test_routing():
    """Exactly midas2's 33 Bottleneck.conv2 are ``grouped`` (and none of
    them ``routed``); the hourglass, the ResNet-18 and MiDaS's decoder have
    no grouped conv."""
    with torch.device("meta"):
        midas = midas_v2.MidasNet()
        others = [hourglass.HourglassModel(), ResNet18Features()]
    grouped = [n for n, m in midas.named_modules()
               if isinstance(m, layers.SameConv2d) and m.grouped]
    conv2 = [f"{n}.conv2" for n, m in midas.named_modules()
             if isinstance(m, Bottleneck)]
    assert len(grouped) == 33 and grouped == conv2
    assert all(n.startswith("pretrained.layer") for n in grouped)
    assert not any(m.routed for n, m in midas.named_modules()
                   if n in grouped)
    for net in others:
        assert not any(m.grouped for m in net.modules()
                       if isinstance(m, layers.SameConv2d))


def test_same_conv2d_takes_grouped_conv():
    """SameConv2d's grouped conv equals nn.Conv2d in value and gradients,
    and goes through the grad-weight once per backward."""
    g = torch.Generator().manual_seed(0)
    conv = layers.SameConv2d(512, 512, 3, 2, 1, groups=GROUPS, bias=False)
    layers.init_parameters(conv, g)
    plain = torch.nn.Conv2d(512, 512, 3, 2, 1, groups=GROUPS, bias=False)
    plain.load_state_dict(conv.state_dict())
    assert conv.grouped and not conv.routed
    x = torch.randn((2, 512, 7, 9), generator=g).to(
        memory_format=torch.channels_last)
    gc.reset_counts()
    conv(x).square().sum().backward()
    plain(x).square().sum().backward()
    assert gc.launch_count() == gc.route_counts["plain"] == 1
    assert _rel(conv.weight.grad, plain.weight.grad) <= 1e-5


def test_counts_reset():
    gc.route_counts["kernel"] += 3
    gc.route_counts["plain"] += 2
    gc.route_counts["layout_copies"] += 1
    assert gc.launch_count() >= 5
    gc.reset_counts()
    assert gc.launch_count() == 0
    assert set(gc.route_counts.values()) == {0}


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "int64_t": ctypes.c_int64}


def test_entry_matches_argtypes():
    """ops/_cuda.py's argtypes for ``grouped_wgrad`` are its ``extern "C"``
    declaration's parameters, in order."""
    text = (Path(_cuda.CSRC_DIR) / "grouped_wgrad.cu").read_text()
    extern = text[text.index('extern "C" {'):]
    m = re.search(r"int\s+grouped_wgrad\s*\(([^)]*)\)", extern)
    assert m
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [p.rsplit(" ", 1)[0].replace(" *", "*") for p in params]
    assert [_C_TYPES[t] for t in types] == _cuda.GROUPED_WGRAD_ARGTYPES
