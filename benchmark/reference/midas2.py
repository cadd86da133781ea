"""Plain reference of the ``midas2`` configuration: MiDaS v2 (Ranftl et al.,
TPAMI 2020), a ResNeXt-101 32x8d encoder with a 256-feature RefineNet
decoder, f32, every conv through ``F.conv2d``.

A frozen copy of the port's ``models/midas_v2.py`` and
``models/resnet.py`` with the hand-written kernels replaced by
:func:`common.conv2d`; the state_dict keys are the released network's, the
same as the port's. The ImageNet normalisation is applied to the BGR input
as the reference adapter does, and depth is 1 / disparity.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
FEATURES = 256


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, cout, stride, groups, downsample):
        super().__init__()
        self.conv1 = common.Conv2d(cin, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = common.Conv2d(width, width, 3, stride, 1, groups=groups,
                                   bias=False)
        self.bn2 = _bn(width)
        self.conv3 = common.Conv2d(width, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.downsample = (nn.Sequential(
            common.Conv2d(cin, cout, 1, stride, bias=False), _bn(cout))
            if downsample else None)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


def _layer(cin, width, cout, blocks, stride, groups):
    return nn.Sequential(*[
        Bottleneck(cin if b == 0 else cout, width, cout,
                   stride if b == 0 else 1, groups,
                   downsample=b == 0 and (stride != 1 or cin != cout))
        for b in range(blocks)])


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
        self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        y = self.resConfUnit2(x)
        H, W = y.shape[2:]
        return F.interpolate(y, size=(2 * H, 2 * W), mode="bilinear",
                             align_corners=True)


class _Upsample2x(nn.Module):
    def forward(self, x):
        H, W = x.shape[2:]
        return F.interpolate(x, size=(2 * H, 2 * W), mode="bilinear",
                             align_corners=False)


class MidasNet(nn.Module):
    """(B, 3, H, W) normalised -> disparity (B, H, W)."""

    def __init__(self, blocks=(3, 4, 23, 3), groups=32, width_per_group=8):
        super().__init__()
        width = groups * width_per_group
        self.pretrained = nn.Module()
        self.pretrained.layer1 = nn.Sequential(
            common.Conv2d(3, 64, 7, 2, 3, bias=False), _bn(64),
            nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1),
            _layer(64, width, 256, blocks[0], 1, groups))
        self.pretrained.layer2 = _layer(256, 2 * width, 512, blocks[1], 2,
                                        groups)
        self.pretrained.layer3 = _layer(512, 4 * width, 1024, blocks[2], 2,
                                        groups)
        self.pretrained.layer4 = _layer(1024, 8 * width, 2048, blocks[3], 2,
                                        groups)
        self.scratch = nn.Module()
        for i, c in enumerate((256, 512, 1024, 2048), 1):
            setattr(self.scratch, f"layer{i}_rn",
                    common.Conv2d(c, FEATURES, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}",
                    FeatureFusionBlock(FEATURES))
        self.scratch.output_conv = nn.Sequential(
            common.Conv2d(FEATURES, 128, 3, 1, 1), _Upsample2x(),
            common.Conv2d(128, 32, 3, 1, 1), nn.ReLU(),
            common.Conv2d(32, 1, 1), nn.ReLU())

    def forward(self, x):
        p, s = self.pretrained, self.scratch
        f1 = p.layer1(x)
        f2 = p.layer2(f1)
        f3 = p.layer3(f2)
        f4 = p.layer4(f3)
        path = s.refinenet4(s.layer4_rn(f4))
        path = s.refinenet3(path, s.layer3_rn(f3))
        path = s.refinenet2(path, s.layer2_rn(f2))
        path = s.refinenet1(path, s.layer1_rn(f1))
        return s.output_conv(path)[:, 0]


def build() -> nn.Module:
    return MidasNet()


def tame(state: dict, config: dict) -> None:
    """The configuration's ``assumed`` output conv: its weight scaled and
    its bias raised, in place (a seeded MiDaS emits ~zero disparity)."""
    state["scratch.output_conv.4.weight"].mul_(config["output_weight_scale"])
    state["scratch.output_conv.4.bias"].add_(config["output_bias_shift"])


def depth(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """images (B, N, H, W, 3) -> depth (B, N, H, W), f32."""
    B, N, H, W, C = images.shape
    x = images.reshape(B * N, H, W, C).float()
    mean = x.new_tensor(_MEAN)
    std = x.new_tensor(_STD)
    x = ((x - mean) / std).permute(0, 3, 1, 2).contiguous()
    return (1.0 / net(x)).reshape(B, N, H, W)
