"""The FLOP and byte arithmetic against hand counts, and the traffic
generator's counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch
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
    assert len(roofline.convs_of(mc, 1, 224, 384)) == 156


def test_midas2_forward_flop():
    midas = spec.reference_module("midas2")
    assert roofline.forward_flop(midas, 224, 384) == 120683888640
    assert len(roofline.convs_of(midas, 1, 224, 384)) == 125
    # nothing but convs: no linear or attention work
    b = roofline.bounds_s(midas, 8, 224, 384, "f32", backward=True)
    assert b == {"kxk": roofline.kxk_bound_s(midas, 8, 224, 384, "f32",
                                             True),
                 "linear": 0.0, "attention": 0.0}


def test_linear_and_attention_bounds_by_hand():
    # ViT-L's MLP up-projection over 2 x 1009 tokens in f32: operations
    flop, t, by = roofline.linear_bound(1, 2018, 1024, 4096, "f32", bias=True)
    assert flop == 2 * 2018 * 1024 * 4096
    assert t == pytest.approx(flop / 165e12) and by == "operations"
    # a batched product of activations reads both per batch: bytes in bf16
    flop, t, by = roofline.linear_bound(32, 16, 64, 16, "bf16",
                                        b_elems=32 * 64 * 16)
    assert t == pytest.approx(32 * (16 * 64 + 64 * 16 + 16 * 16) * 2
                              / 3.35e12) and by == "bytes"
    # attention over 16 heads of 64, 1009 tokens: forward and backward
    flop, t, _ = roofline.attention_bound("forward", 32, 1009, 1009, 64, "f32")
    assert flop == 4 * 32 * 1009 * 1009 * 64
    assert t == pytest.approx(max(flop / 165e12,
                                  4 * 32 * 64 * 4 * 1009 / 3.35e12))
    flop_b, t_b, _ = roofline.attention_bound("backward", 32, 1009, 1009, 64,
                                              "f32")
    assert flop_b == 2 * flop and t_b == pytest.approx(2 * t)


class _MHA:
    """A reference module of one nn.MultiheadAttention of width 32, 4
    heads, over a frame's values read as tokens of 32."""

    @staticmethod
    def build():
        return nn.MultiheadAttention(32, 4, batch_first=True)

    @staticmethod
    def depth(net, images):
        x = images.reshape(images.shape[0] * images.shape[1], -1, 32)
        return net(x, x, x, need_weights=False)[0]


def test_multi_head_attention_refused():
    # a composite's products go unseen inside its handler: refused, with
    # the calls a reference writes instead
    with pytest.raises(ValueError, match="multi_head_attention_forward.*"
                                         "scaled_dot_product_attention"):
        roofline.forward_flop(_MHA, 4, 8)


class _Broadcast:
    """A (4, 3) matrix on the left of a frame's values read as a batch of
    (3, 8) matrices: the left operand is broadcast over the batch."""

    @staticmethod
    def build():
        return nn.Linear(3, 4)

    @staticmethod
    def depth(net, images):
        return net.weight @ images.reshape(-1, 3, 8)


def test_broadcast_matmul_reads_each_operand_once():
    # 2 frames of 4 x 8 x 3: a batch of 8 (3, 8) matrices under one (4, 3)
    (p,) = roofline._trace(_Broadcast, 2, 4, 8).linears
    assert (p.batch, p.M, p.K, p.N, p.a_elems, p.b_elems) == (
        8, 4, 3, 8, 12, 8 * 3 * 8)
    t = roofline.bounds_s(_Broadcast, 2, 4, 8, "f32", False)["linear"]
    assert t == pytest.approx((12 + 8 * 3 * 8 + 8 * 4 * 8) * 4 / 3.35e12,
                              rel=1e-12)


class _Uncounted:
    @staticmethod
    def build():
        return nn.Linear(3, 3)

    @staticmethod
    def depth(net, images):
        return torch.einsum("...c,dc->...d", images, net.weight)


def test_uncounted_product_is_refused():
    with pytest.raises(ValueError, match="einsum"):
        roofline.forward_flop(_Uncounted, 4, 4)


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
