"""Plain reference of the ``dav2-large`` configuration: Depth Anything V2-Large
(Yang et al., NeurIPS 2024, https://arxiv.org/abs/2406.09414;
``depth_anything_v2/dpt.py`` with ``encoder='vitl'`` and its ``dinov2``
package), f32, every product through ``common``: convs through
:class:`common.Conv2d`, linears through :class:`common.Linear` and
:func:`common.linear`, attention through :func:`common.attention`, so that
the control's rounding reaches each one.

The network, written from the published code and not from the port:

- DINOv2 ViT-L/14 (``vit_large``, ``img_size=518``, ``init_values=1.0``,
  ``ffn_layer="mlp"``, no register tokens, ``interpolate_antialias=False``,
  ``interpolate_offset=0.1``): a 14x14 stride-14 patch conv into 1024
  channels, a cls token, a position embedding of 1 + 37 x 37 positions
  resized bicubically by the scale factors (h0 + 0.1) / 37, (w0 + 0.1) / 37
  (unchanged for a square 37 x 37 grid), a ``mask_token`` held and never
  used, 24 pre-norm blocks (LayerNorm eps 1e-6, 16 heads of 64 with a qkv
  bias, LayerScale, an exact-GELU MLP of 4096), the final norm on the
  outputs of blocks 4, 11, 17 and 23, the cls token dropped;
- the DPT head (``features=256``, ``out_channels=[256, 512, 1024, 1024]``,
  ``use_bn=False``, ``use_clstoken=False``): 1x1 projections,
  ConvTranspose 4x4/4 and 2x2/2, identity and a 3x3 stride-2 conv, 3x3
  ``layer{1..4}_rn`` to 256 without bias, four fusion blocks of two
  residual conv units, a bilinear resize (align_corners=True) to the next
  tap's size or by 2x and a 1x1 ``out_conv``, ``output_conv1``, a bilinear
  resize to 14 h0 x 14 w0 (align_corners=True), ``output_conv2`` and a
  final ReLU: disparity.

The state_dict keys are the released ones, the port's too; the network
keeps no buffer. The input is flipped from BGR to RGB and normalised by the
ImageNet mean and std, as the published transform does; depth = 1 /
disparity.

Departures from the published code, none of which changes a value:

- each transposed conv (kernel = stride, so its output patches do not
  overlap) is an ``nn.ConvTranspose2d`` whose forward is
  :func:`common.linear` over the input pixels and a pixel shuffle, so that
  the control rounds it;
- attention is ``F.scaled_dot_product_attention`` (``common.attention``)
  where the published code may take xformers' memory-efficient kernel;
- with a gradient taken, each block runs under ``torch.utils.checkpoint``
  (its activations recomputed in the backward), so that the check, and the
  control's materialised attention scores, fit beside the program's data.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
PATCH = 14


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    rounding: Optional[str] = None

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = common.Linear(dim, 3 * dim)
        self.proj = common.Linear(dim, dim)

    def forward(self, x):
        B, L, C = x.shape
        qkv = self.qkv(x).reshape(B, L, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = common.attention(q, k, v, self.rounding)
        return self.proj(o.transpose(1, 2).reshape(B, L, C))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = common.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = common.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj = common.Conv2d(3, dim, PATCH, PATCH)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    def __init__(self, img_size, dim, depth, heads, mlp_ratio=4):
        super().__init__()
        self.patch_embed = PatchEmbed(dim)
        side = img_size // PATCH
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + side * side, dim))
        self.mask_token = nn.Parameter(torch.empty(1, dim))
        self.blocks = nn.ModuleList(
            [Block(dim, heads, mlp_ratio) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def interpolate_pos_encoding(self, x, h, w):
        npatch = x.shape[1] - 1
        N = self.pos_embed.shape[1] - 1
        if npatch == N and h == w:
            return self.pos_embed
        side = int(N ** 0.5)
        dim = x.shape[-1]
        h0 = h // PATCH + 0.1
        w0 = w // PATCH + 0.1
        grid = F.interpolate(
            self.pos_embed[:, 1:].reshape(1, side, side, dim)
            .permute(0, 3, 1, 2),
            scale_factor=(h0 / side, w0 / side), mode="bicubic",
            antialias=False)
        if grid.shape[-2:] != (int(h0), int(w0)):
            raise ValueError(f"position grid {tuple(grid.shape[-2:])}")
        grid = grid.permute(0, 2, 3, 1).reshape(1, -1, dim)
        return torch.cat((self.pos_embed[:, :1], grid), dim=1)

    def get_intermediate_layers(self, x, taps):
        B, _, h, w = x.shape
        t = self.patch_embed(x)
        t = torch.cat((self.cls_token.expand(B, -1, -1), t), dim=1)
        t = t + self.interpolate_pos_encoding(t, h, w)
        out = []
        for i, block in enumerate(self.blocks):
            if torch.is_grad_enabled() and t.requires_grad:
                t = checkpoint(block, t, use_reentrant=False)
            else:
                t = block(t)
            if i in taps:
                out.append(self.norm(t)[:, 1:])
        return out


class ConvTranspose2d(nn.ConvTranspose2d):
    """A transposed conv whose kernel equals its stride, as
    :func:`common.linear` over the input pixels and a pixel shuffle."""

    rounding: Optional[str] = None

    def forward(self, x):
        N, Ci, H, W = x.shape
        Co, k = self.weight.shape[1], self.weight.shape[2]
        w = self.weight.permute(2, 3, 1, 0).reshape(k * k * Co, Ci)
        y = common.linear(x.permute(0, 2, 3, 1), w, self.bias.repeat(k * k),
                          self.rounding)
        y = y.reshape(N, H, W, k, k, Co).permute(0, 5, 1, 3, 2, 4)
        return y.reshape(N, Co, H * k, W * k)


class ResidualConvUnit(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1 = common.Conv2d(f, f, 3, 1, 1)
        self.conv2 = common.Conv2d(f, f, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.out_conv = common.Conv2d(f, f, 1)
        self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        y = self.resConfUnit2(x)
        if size is None:
            y = F.interpolate(y, scale_factor=2, mode="bilinear",
                              align_corners=True)
        else:
            y = F.interpolate(y, size=size, mode="bilinear",
                              align_corners=True)
        return self.out_conv(y)


class DPTHead(nn.Module):
    def __init__(self, in_channels, features, out_channels):
        super().__init__()
        self.projects = nn.ModuleList(
            [common.Conv2d(in_channels, c, 1) for c in out_channels])
        c0, c1, _, c3 = out_channels
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(c0, c0, 4, stride=4),
            ConvTranspose2d(c1, c1, 2, stride=2),
            nn.Identity(),
            common.Conv2d(c3, c3, 3, 2, 1)])
        self.scratch = nn.Module()
        for i, c in enumerate(out_channels, 1):
            setattr(self.scratch, f"layer{i}_rn",
                    common.Conv2d(c, features, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}",
                    FeatureFusionBlock(features))
        self.scratch.output_conv1 = common.Conv2d(features, features // 2, 3,
                                                  1, 1)
        self.scratch.output_conv2 = nn.Sequential(
            common.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(True),
            common.Conv2d(32, 1, 1), nn.ReLU(True), nn.Identity())

    def forward(self, features, h0, w0):
        out = []
        for i, x in enumerate(features):
            x = x.permute(0, 2, 1).reshape(x.shape[0], x.shape[-1], h0, w0)
            x = self.projects[i](x)
            x = self.resize_layers[i](x)
            out.append(x)
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i}_rn")(x)
                          for i, x in enumerate(out, 1))
        path = s.refinenet4(l4, size=l3.shape[2:])
        path = s.refinenet3(path, l3, size=l2.shape[2:])
        path = s.refinenet2(path, l2, size=l1.shape[2:])
        path = s.refinenet1(path, l1)
        y = s.output_conv1(path)
        y = F.interpolate(y, (PATCH * h0, PATCH * w0), mode="bilinear",
                          align_corners=True)
        return s.output_conv2(y)


class DepthAnythingV2(nn.Module):
    """(B, 3, H, W) normalised RGB -> disparity (B, H, W)."""

    def __init__(self, img_size=518, dim=1024, depth=24, heads=16,
                 taps: Sequence[int] = (4, 11, 17, 23), features=256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024)):
        super().__init__()
        self.taps = tuple(taps)
        self.pretrained = DinoVisionTransformer(img_size, dim, depth, heads)
        self.depth_head = DPTHead(dim, features, out_channels)

    def forward(self, x):
        h0, w0 = x.shape[-2] // PATCH, x.shape[-1] // PATCH
        features = self.pretrained.get_intermediate_layers(x, self.taps)
        return F.relu(self.depth_head(features, h0, w0))[:, 0]


def build(**sizes) -> nn.Module:
    """The published network; keyword ``sizes`` (``img_size``, ``dim``,
    ``depth``, ``heads``, ``taps``, ``features``, ``out_channels``) build a
    smaller one of the same design."""
    return DepthAnythingV2(**sizes)


def tame(state: dict, config: dict) -> None:
    """The configuration's ``assumed`` values, in place: every LayerScale
    gamma at DA2's ``init_values`` (a seeded draw would scale each block's
    branches by ~0.02), and the output conv's weight scaled and its bias
    raised (a seeded ReLU head emits ~zero disparity, and 1 / disparity then
    NaNs the loss)."""
    for k, v in state.items():
        if k.endswith((".ls1.gamma", ".ls2.gamma")):
            v.fill_(config["layer_scale"])
    state["depth_head.scratch.output_conv2.2.weight"].mul_(
        config["output_weight_scale"])
    state["depth_head.scratch.output_conv2.2.bias"].add_(
        config["output_bias_shift"])


def depth(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """images (B, N, H, W, 3) BGR -> depth (B, N, H, W), f32."""
    B, N, H, W, C = images.shape
    x = images.reshape(B * N, H, W, C).float().flip(-1)
    mean = x.new_tensor(_MEAN)
    std = x.new_tensor(_STD)
    x = ((x - mean) / std).permute(0, 3, 1, 2).contiguous()
    return (1.0 / net(x)).reshape(B, N, H, W)
