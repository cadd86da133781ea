"""Plain reference of the ``mc`` configuration: the MannequinChallenge
"Ours_Bilinear" hourglass (Li et al., CVPR 2019), f32, every conv through
``F.conv2d``.

A frozen copy of the port's ``models/hourglass.py`` and
``models/mannequin_challenge.py`` with the hand-written kernels replaced by
:func:`common.conv2d`; the state_dict keys are the published network's, the
same as the port's. Depth is exp of the predicted log-depth.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import common

_A = ((16,), (3, 64, 16), (7, 64, 16), (11, 64, 16))
_BA = ((16,), (3, 32, 16), (7, 32, 16), (11, 32, 16))
_B = ((32,), (3, 32, 32), (5, 32, 32), (7, 32, 32))
_BC = ((32,), (3, 64, 32), (7, 64, 32), (11, 64, 32))
_BB = ((32,), (3, 64, 32), (5, 64, 32), (7, 64, 32))
_D = ((64,), (3, 32, 64), (5, 32, 64), (7, 32, 64))
_E = ((64,), (3, 32, 64), (5, 32, 64), (7, 32, 64))
_F = ((64,), (3, 64, 64), (7, 64, 64), (11, 64, 64))
_G = ((32,), (3, 32, 32), (5, 32, 32), (7, 32, 32))


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1, affine=False)


class Inception(nn.Module):
    def __init__(self, cin: int, config):
        super().__init__()
        (base,), branches = config[0], config[1:]
        convs = [nn.Sequential(common.Conv2d(cin, base, 1), _bn(base),
                               nn.ReLU(True))]
        for k, mid, out in branches:
            convs.append(nn.Sequential(
                common.Conv2d(cin, mid, 1), _bn(mid), nn.ReLU(True),
                common.Conv2d(mid, out, k, padding=(k - 1) // 2), _bn(out),
                nn.ReLU(True)))
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        return torch.cat([branch(x) for branch in self.convs], dim=1)


def _blocks(cin, configs):
    return [Inception(cin, c) for c in configs]


class _TwoBranch(nn.Module):
    def __init__(self, first, second):
        super().__init__()
        self.list = nn.ModuleList([nn.Sequential(*first),
                                   nn.Sequential(*second)])

    def forward(self, x):
        return self.list[0](x) + self.list[1](x)


def _down():
    return nn.AvgPool2d(2)


def _up():
    return nn.UpsamplingBilinear2d(scale_factor=2)


class Channels1(_TwoBranch):
    def __init__(self):
        super().__init__(_blocks(256, (_E, _E)),
                         [_down(), *_blocks(256, (_E, _E, _E)), _up()])


class Channels2(_TwoBranch):
    def __init__(self):
        super().__init__(_blocks(256, (_E, _F)),
                         [_down(), *_blocks(256, (_E, _E)), Channels1(),
                          *_blocks(256, (_E, _F)), _up()])


class Channels3(_TwoBranch):
    def __init__(self):
        super().__init__([_down(), *_blocks(128, (_B, _D)), Channels2(),
                          *_blocks(256, (_E, _G)), _up()],
                         _blocks(128, (_B, _BC)))


class Channels4(_TwoBranch):
    def __init__(self):
        super().__init__([_down(), *_blocks(128, (_B, _B)), Channels3(),
                          *_blocks(128, (_BB, _BA)), _up()],
                         _blocks(128, (_A,)))


class Hourglass(nn.Module):
    """(B, 3, H, W) BGR in [0, 1] -> log-depth (B, H, W). The two heads
    (log-depth and confidence) are one conv of two output channels, as the
    port computes them."""

    rounding = None

    def __init__(self):
        super().__init__()
        self.seq = nn.Sequential(
            common.Conv2d(3, 128, 7, padding=3),
            nn.BatchNorm2d(128, eps=1e-5, momentum=0.1), nn.ReLU(True),
            Channels4())
        self.uncertainty_layer = nn.Sequential(
            common.Conv2d(64, 1, 3, padding=1), nn.Sigmoid())
        self.pred_layer = common.Conv2d(64, 1, 3, padding=1)

    def forward(self, x):
        feats = self.seq(x)
        unc = self.uncertainty_layer[0]
        w = torch.cat([self.pred_layer.weight, unc.weight])
        b = torch.cat([self.pred_layer.bias, unc.bias])
        heads = common.conv2d(feats, w, b, 1, 1, 1, self.rounding)
        return heads[:, 0]


def build() -> nn.Module:
    return Hourglass()


def tame(state: dict, config: dict) -> None:
    """The configuration's ``assumed`` head scale on the prediction conv
    (weight and bias), in place."""
    s = config["head_scale"]
    state["pred_layer.weight"].mul_(s)
    state["pred_layer.bias"].mul_(s)


def depth(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """images (B, N, H, W, 3) -> depth (B, N, H, W), f32."""
    B, N, H, W, C = images.shape
    x = images.reshape(B * N, H, W, C).permute(0, 3, 1, 2).contiguous()
    return torch.exp(net(x)).reshape(B, N, H, W)
