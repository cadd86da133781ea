"""The benchmark's seeded weights (``harness/weights.py``): the convs' draw
is unchanged, every parameter of a transformer's layers gets a value from
the seed alike whether its network is built normally or on the meta device,
and a buffer that no rule fills raises."""

from __future__ import annotations

import pytest
import torch
import torch.nn as nn

from benchmark.harness import roofline, spec, traffic, weights
from benchmark.reference import common


@torch.no_grad()
def _make_convs_only(net, seed, reference, config):
    """``weights.make`` as it was before the second draw: the convs and the
    batch norms alone (frozen copy)."""
    mods = {n: m for n, m in net.named_modules() if isinstance(m, nn.Conv2d)}
    convs = [mods[n] for n in sorted(mods)]
    device = convs[0].weight.device
    sizes = [m.weight.numel() for m in convs]
    flat = torch.randn(sum(sizes), generator=traffic.generator(
        seed, "weights", device), device=device, dtype=torch.float32)
    at = 0
    for m, n in zip(convs, sizes):
        w = m.weight
        fan_in = w[0].numel()
        w.copy_(flat[at:at + n].view(w.shape).mul_(fan_in ** -0.5))
        at += n
        if m.bias is not None:
            m.bias.zero_()
    for m in net.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    reference.tame(net.state_dict(), config)


@pytest.mark.parametrize("name", ["mc", "midas2"])
def test_conv_networks_keep_their_weights(name):
    ref = spec.reference_module(name)
    config = spec.configs_of()[name]
    net = ref.build()
    for seed in (7, 2 ** 31 + 9):
        _make_convs_only(net, seed, ref, config)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        weights.make(net, seed, ref, config)
        for k, v in net.state_dict().items():
            assert torch.equal(v, before[k]), (seed, k)
        del before


class TinyViT:
    """A reference module of a small transformer: a patch conv, a cls token
    and a position embedding, a pre-norm block (LayerNorm, a qkv linear,
    SDPA over 4 heads, the projection, a GELU MLP), a transposed conv and a
    1x1 head, at 32 x 48 frames."""

    D, HEADS, PATCH, H, W = 32, 4, 8, 32, 48
    TOKENS = (H // PATCH) * (W // PATCH)

    class Net(nn.Module):
        def __init__(self, d, heads, patch, tokens):
            super().__init__()
            self.heads = heads
            self.patch = nn.Conv2d(3, d, patch, patch)
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
            self.pos_embed = nn.Parameter(torch.zeros(1, 1 + tokens, d))
            self.norm1 = nn.LayerNorm(d, eps=1e-6)
            self.qkv = common.Linear(d, 3 * d)
            self.proj = common.Linear(d, d)
            self.norm2 = nn.LayerNorm(d, eps=1e-6)
            self.mlp = nn.Sequential(common.Linear(d, 4 * d), nn.GELU(),
                                     common.Linear(4 * d, d))
            self.up = nn.ConvTranspose2d(d, 8, 4, stride=4)
            self.head = nn.Conv2d(8, 1, 1)

        def forward(self, x):
            t = self.patch(x)
            B, d, gh, gw = t.shape
            t = t.flatten(2).transpose(1, 2)
            t = torch.cat([self.cls_token.expand(B, -1, -1), t], 1)
            t = t + self.pos_embed
            q, k, v = self.qkv(self.norm1(t)).reshape(
                B, -1, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
            a = common.attention(q, k, v, self.qkv.rounding)
            t = t + self.proj(a.transpose(1, 2).reshape(B, -1, d))
            t = t + self.mlp(self.norm2(t))
            t = t[:, 1:].transpose(1, 2).reshape(B, d, gh, gw)
            return self.head(self.up(t))[:, 0]

    @classmethod
    def build(cls):
        return cls.Net(cls.D, cls.HEADS, cls.PATCH, cls.TOKENS)

    @staticmethod
    def tame(state, config):
        pass

    @staticmethod
    def depth(net, images):
        B, N, H, W, C = images.shape
        x = images.reshape(B * N, H, W, C).permute(0, 3, 1, 2)
        y = net(x)
        return torch.exp(y).reshape(B, N, *y.shape[1:])


def test_transformer_weights_alike_on_meta():
    built = TinyViT.build()
    weights.make(built, 5, TinyViT, {})
    with torch.device("meta"):
        empty = TinyViT.build()
    empty = empty.to_empty(device="cpu")
    weights.make(empty, 5, TinyViT, {})
    for k, v in built.state_dict().items():
        assert torch.equal(v, empty.state_dict()[k]), k
    assert torch.equal(built.norm1.weight, torch.ones(TinyViT.D))
    assert not built.qkv.bias.any() and not built.up.bias.any()
    assert 0.01 < float(built.pos_embed.std()) < 0.03
    # N(0, 1 / fan_in): a transposed conv's fan_in is Ci x kh x kw / (sh x sw)
    assert float(built.up.weight.std()) == pytest.approx(32 ** -0.5, rel=0.1)
    assert float(built.mlp[2].weight.std()) == pytest.approx(128 ** -0.5,
                                                             rel=0.1)
    other = TinyViT.build()
    weights.make(other, 6, TinyViT, {})
    assert not torch.equal(other.cls_token, built.cls_token)


def test_unfilled_buffer_raises():
    net = TinyViT.build()
    net.norm1.register_buffer("scale", torch.ones(TinyViT.D))
    with pytest.raises(ValueError, match="norm1.scale"):
        weights.make(net, 1, TinyViT, {})


def test_transformer_counted_without_a_harness_edit():
    """The tiny transformer's FLOP and per-class bounds, by hand."""
    D, P, L, h = TinyViT.D, TinyViT.PATCH, 1 + TinyViT.TOKENS, TinyViT.HEADS
    gh, gw = TinyViT.H // P, TinyViT.W // P
    linears = [(D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)]
    flop = (2 * gh * gw * D * 3 * P * P                    # patch conv
            + sum(2 * L * i * o for i, o in linears)
            + 4 * h * L * L * (D // h)                     # attention
            + 2 * D * gh * gw * 8 * 4 * 4                  # transposed conv
            + 2 * (4 * gh) * (4 * gw) * 8)                 # 1x1 head
    assert roofline.forward_flop(TinyViT, TinyViT.H, TinyViT.W) == flop

    def t(flop, elems):
        return max(flop / 165e12, 4 * elems / 3.35e12)

    N = 2
    rows = N * L
    linear = sum(
        t(2 * rows * i * o, rows * (i + o) + i * o + o)           # forward
        + 2 * t(2 * rows * i * o, rows * (i + o) + i * o)         # backward
        for i, o in linears)
    BH, d = N * h, D // h
    attention = (t(4 * BH * L * L * d, 2 * BH * d * 2 * L)
                 + t(8 * BH * L * L * d, 4 * BH * d * 2 * L))
    got = roofline.bounds_s(TinyViT, N, TinyViT.H, TinyViT.W, "f32", True)
    assert got["kxk"] == 0.0
    assert got["linear"] == pytest.approx(linear, rel=1e-12)
    assert got["attention"] == pytest.approx(attention, rel=1e-12)
    fwd = roofline.bounds_s(TinyViT, N, TinyViT.H, TinyViT.W, "f32", False)
    assert fwd["attention"] == pytest.approx(
        t(4 * BH * L * L * d, 2 * BH * d * 2 * L), rel=1e-12)


def test_transformer_runs_seeded():
    net = TinyViT.build()
    weights.make(net, 3, TinyViT, {})
    images = torch.rand((1, 2, TinyViT.H, TinyViT.W, 3))
    depth = TinyViT.depth(net, images)
    assert depth.shape == (1, 2, 4 * (TinyViT.H // 8), 4 * (TinyViT.W // 8))
    assert torch.isfinite(depth).all()
