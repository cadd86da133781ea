"""The FLOP and byte arithmetic against hand counts, and the traffic
generator's counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch.nn as nn

from benchmark.harness import roofline, spec, traffic


def test_peaks():
    assert roofline.PEAK_TFLOPS["bf16"] == 989.0
    # TF32's 495 TFLOP/s at three products per f32-accurate product
    assert roofline.PEAK_TFLOPS["f32"] == pytest.approx(165.0)
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def test_conv_bound_by_hand():
    # mc's 56x96 64->64 k=11 at batch 8: bound by operations in f32
    flop, t, by = roofline.conv_bound("forward", 8, 56, 96, 11, 64, 64, "f32")
    assert flop == 2 * 8 * 56 * 96 * 121 * 64 * 64
    assert t == pytest.approx(flop / 165e12)
    assert by == "operations"
    # mc's heads, 224x384 64->2 k=3 in f32: bound by bytes
    flop, t, by = roofline.conv_bound("forward", 8, 224, 384, 3, 64, 2, "f32")
    elems = 8 * 224 * 384 * (64 + 2) + 9 * 64 * 2 + 2
    assert t == pytest.approx(elems * 4 / 3.35e12)
    assert by == "bytes"
    # grad-input has no bias; bf16 elements are 2 bytes
    _, t, _ = roofline.conv_bound("grad_input", 8, 224, 384, 3, 64, 2, "bf16")
    assert t == pytest.approx((8 * 224 * 384 * 66 + 9 * 128) * 2 / 3.35e12)


def test_mc_bounds_match_the_port_record():
    mc = spec.reference_module("mc")
    # PERF.md's f32 bounds of a batch-8 forward and of the grad-inputs
    fwd = roofline.kxk_bound_s(mc, 8, 224, 384, "f32", grad_input=False)
    both = roofline.kxk_bound_s(mc, 8, 224, 384, "f32", grad_input=True)
    assert round(fwd * 1e3, 2) == 4.54
    assert round((both - fwd) * 1e3, 2) == 4.38
    assert round(1e3 * roofline.kxk_bound_s(mc, 8, 224, 384, "bf16", False),
                 3) == 0.850
    convs = roofline.convs_of(mc, 8, 224, 384)
    # the port's launches per f32 step: 68 forward, 67 grad-input (the
    # stem's input needs none)
    assert sum(c.kxk for c in convs) == 68
    assert sum(c.kxk and c.needs_grad_input for c in convs) == 67
    midas = spec.reference_module("midas2")
    assert round(1e3 * roofline.kxk_bound_s(midas, 8, 224, 384, "f32", False),
                 2) == 3.12
    assert sum(c.kxk for c in roofline.convs_of(midas, 8, 224, 384)) == 20


class _Tiny:
    """A reference module with two convs, counted by hand."""

    @staticmethod
    def build():
        return nn.Sequential(nn.Conv2d(3, 8, 3, padding=1),
                             nn.Conv2d(8, 8, 3, 2, 1, groups=2))

    @staticmethod
    def depth(net, images):
        B, N, H, W, C = images.shape
        return net(images.reshape(B * N, H, W, C).permute(0, 3, 1, 2))


def test_forward_flop_by_hand():
    got = roofline.forward_flop(_Tiny, 16, 20)
    assert got == 2 * 16 * 20 * 8 * 3 * 9 + 2 * 8 * 10 * 8 * 4 * 9
    convs = roofline.convs_of(_Tiny, 2, 16, 20)
    assert [c.kxk for c in convs] == [True, False]
    assert [c.needs_grad_input for c in convs] == [False, True]


def test_mc_forward_flop():
    mc = spec.reference_module("mc")
    # 2 x (multiply-adds) of every conv of the hourglass at 224x384
    assert roofline.forward_flop(mc, 224, 384) == 105664806912


def test_demo_pairs_and_batches():
    pairs = traffic.hierarchical2_pairs(244)
    assert len(pairs) == 715
    assert (pairs[:, 0] < pairs[:, 1]).all()
    idx, valid = traffic.epoch_batches(715, 4, seed=2 ** 31 + 5, epoch=0)
    assert idx.shape == (179, 4) and valid.sum() == 715
    assert sorted(idx.ravel()[valid.ravel() > 0]) == list(range(715))
    again, _ = traffic.epoch_batches(715, 4, seed=2 ** 31 + 5, epoch=0)
    assert (idx == again).all()
    idx, valid = traffic.eval_batches(715, 4)
    assert idx[-1].tolist() == [712, 713, 714, 714]
    assert valid[-1].tolist() == [1, 1, 1, 0]


def test_seeded_data_repeats():
    tr = {"frames": 6}
    a = traffic.pair_dataset(tr, (8, 12), 2 ** 31 + 3, "cpu")
    b = traffic.pair_dataset(tr, (8, 12), 2 ** 31 + 3, "cpu")
    c = traffic.pair_dataset(tr, (8, 12), 2 ** 31 + 4, "cpu")
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
    assert not np.array_equal(a["frames"].numpy(), c["frames"].numpy())
