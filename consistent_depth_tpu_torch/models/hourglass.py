"""MannequinChallenge "Ours_Bilinear" hourglass depth network: the port of
``consistent_depth_tpu/models/hourglass.py``.

    seq = Conv7x7(3->128) -> BN -> ReLU -> Channels4
    pred_layer        = Conv3x3(64->1)          (log-depth)
    uncertainty_layer = Conv3x3(64->1) -> sigmoid

Module names and order are those of the published torch network, so its
state_dict (``seq.0``, ``seq.3.list.0.1.convs.1.3``, ``pred_layer``,
``uncertainty_layer.0``, ...) loads with ``strict=True``. Blocks run as plain
loops; the JAX package's scanned runs of identical blocks are a TPU
compile-size device and have no counterpart here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops import s2d_conv
from .layers import SameConv2d

# Inception configs: [[base_out], [k, mid, out], ...]
_A = ((16,), (3, 64, 16), (7, 64, 16), (11, 64, 16))
_BA = ((16,), (3, 32, 16), (7, 32, 16), (11, 32, 16))
_B = ((32,), (3, 32, 32), (5, 32, 32), (7, 32, 32))
_BC = ((32,), (3, 64, 32), (7, 64, 32), (11, 64, 32))
_BB = ((32,), (3, 64, 32), (5, 64, 32), (7, 64, 32))
_D = ((64,), (3, 32, 64), (5, 32, 64), (7, 32, 64))  # on 128-ch input
_E = ((64,), (3, 32, 64), (5, 32, 64), (7, 32, 64))  # on 256-ch input
_F = ((64,), (3, 64, 64), (7, 64, 64), (11, 64, 64))
_G = ((32,), (3, 32, 32), (5, 32, 32), (7, 32, 32))  # on 256-ch input


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1, affine=False)


class Inception(nn.Module):
    """Concatenation of a 1x1 branch and (1x1 -> k x k) branches, each conv
    followed by an affine-free BN and a ReLU. The base branch comes first."""

    def __init__(self, in_features: int, config):
        super().__init__()
        (base,), branches = config[0], config[1:]
        convs = [nn.Sequential(
            SameConv2d(in_features, base, 1), _bn(base), nn.ReLU(True))]
        for k, mid, out in branches:
            convs.append(nn.Sequential(
                SameConv2d(in_features, mid, 1), _bn(mid), nn.ReLU(True),
                SameConv2d(mid, out, k, padding=(k - 1) // 2), _bn(out),
                nn.ReLU(True)))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([branch(x) for branch in self.convs], dim=1)


def _blocks(in_features: int, configs: Sequence) -> list:
    return [Inception(in_features, cfg) for cfg in configs]


class _TwoBranch(nn.Module):
    """Sum of two branches held in ``self.list`` (the torch layout)."""

    def __init__(self, first: Sequence[nn.Module], second: Sequence[nn.Module]):
        super().__init__()
        self.list = nn.ModuleList(
            [nn.Sequential(*first), nn.Sequential(*second)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.list[0](x) + self.list[1](x)


def _down() -> nn.Module:
    return nn.AvgPool2d(2)


def _up() -> nn.Module:
    return nn.UpsamplingBilinear2d(scale_factor=2)


class Channels1(_TwoBranch):
    def __init__(self):
        super().__init__(
            _blocks(256, (_E, _E)),
            [_down(), *_blocks(256, (_E, _E, _E)), _up()])


class Channels2(_TwoBranch):
    def __init__(self):
        super().__init__(
            _blocks(256, (_E, _F)),
            [_down(), *_blocks(256, (_E, _E)), Channels1(),
             *_blocks(256, (_E, _F)), _up()])


class Channels3(_TwoBranch):
    def __init__(self):
        super().__init__(
            [_down(), *_blocks(128, (_B, _D)), Channels2(),
             *_blocks(256, (_E, _G)), _up()],
            _blocks(128, (_B, _BC)))


class Channels4(_TwoBranch):
    def __init__(self):
        super().__init__(
            [_down(), *_blocks(128, (_B, _B)), Channels3(),
             *_blocks(128, (_BB, _BA)), _up()],
            _blocks(128, (_A,)))


class HourglassModel(nn.Module):
    """netG. Input: (B, 3, H, W) BGR images in [0, 1], channels_last in
    memory. Returns (log-depth (B, 1, H, W), confidence (B, 1, H, W))."""

    def __init__(self, num_input: int = 3):
        super().__init__()
        self.seq = nn.Sequential(
            SameConv2d(num_input, 128, 7, padding=3),
            nn.BatchNorm2d(128, eps=1e-5, momentum=0.1),
            nn.ReLU(True),
            Channels4(),
        )
        self.uncertainty_layer = nn.Sequential(
            SameConv2d(64, 1, 3, padding=1), nn.Sigmoid())
        self.pred_layer = SameConv2d(64, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.seq(x)
        # both heads in one conv of two output channels, as the JAX package
        # computes them (one kernel launch instead of two)
        unc = self.uncertainty_layer[0]
        w = torch.cat([self.pred_layer.weight, unc.weight]).to(feats.dtype)
        b = torch.cat([self.pred_layer.bias, unc.bias]).to(feats.dtype)
        heads = s2d_conv.same_conv(
            feats.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0), b)
        heads = heads.permute(0, 3, 1, 2)
        return heads[:, 0:1], torch.sigmoid(heads[:, 1:2])
