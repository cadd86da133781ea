"""torchvision-style ResNet and ResNeXt building blocks: the port of
``consistent_depth_tpu/models/resnet.py``.

Module names are torchvision's, so a released state_dict loads as it is:

    conv1 / bn1 / layer{L}.{b}.(conv1, bn1, conv2, bn2[, conv3, bn3],
    downsample.0, downsample.1)

Every conv is a :class:`SameConv2d`: the stride-1 3x3 convs of the
ResNet-18 blocks go through the hand-written k x k conv kernel, as the JAX
package sends them through ``conv_compute``; the ResNeXt's grouped 3x3 (a
flax ``nn.Conv`` in the JAX package) keeps cuDNN's forward and grad-input
but takes its grad-weight from a hand-written kernel
(``ops/grouped_conv.py``); the stride-2 convs, the 1x1 convs and the 7x7
stem stay on cuDNN. Used by the monodepth2 encoder (ResNet-18) and the
MiDaS v2 encoder (ResNeXt-101 32x8d).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .layers import SameConv2d


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _downsample(in_features: int, features: int, stride: int
                ) -> nn.Sequential:
    return nn.Sequential(
        SameConv2d(in_features, features, 1, stride, bias=False),
        _bn(features))


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = SameConv2d(in_features, features, 3, stride, 1,
                                bias=False)
        self.bn1 = _bn(features)
        self.conv2 = SameConv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = _bn(features)
        self.downsample = (_downsample(in_features, features, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu_(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu_(y + identity)


class Bottleneck(nn.Module):
    """1x1 -> grouped 3x3 (stride) -> 1x1; ``width`` is conv2's width,
    ``features`` the block's output channels."""

    def __init__(self, in_features: int, width: int, features: int,
                 stride: int = 1, groups: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = SameConv2d(in_features, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = SameConv2d(width, width, 3, stride, 1, groups=groups,
                                bias=False)
        self.bn2 = _bn(width)
        self.conv3 = SameConv2d(width, features, 1, bias=False)
        self.bn3 = _bn(features)
        self.downsample = (_downsample(in_features, features, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu_(self.bn1(self.conv1(x)))
        y = torch.relu_(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu_(y + identity)


def resnet_stem() -> Tuple[nn.Module, nn.Module]:
    """conv1 7x7/2 into 64 channels and bn1 (relu and the 3x3/2 max pool
    follow)."""
    return SameConv2d(3, 64, 7, 2, 3, bias=False), _bn(64)


def basic_layer(in_features: int, features: int, blocks: int,
                stride: int) -> nn.Sequential:
    return nn.Sequential(*[
        BasicBlock(in_features if b == 0 else features, features,
                   stride if b == 0 else 1,
                   downsample=b == 0 and (stride != 1
                                          or in_features != features))
        for b in range(blocks)])


def bottleneck_layer(in_features: int, width: int, features: int,
                     blocks: int, stride: int, groups: int) -> nn.Sequential:
    return nn.Sequential(*[
        Bottleneck(in_features if b == 0 else features, width, features,
                   stride if b == 0 else 1, groups,
                   downsample=b == 0 and (stride != 1
                                          or in_features != features))
        for b in range(blocks)])


class ResNet18Features(nn.Module):
    """ResNet-18 returning the five feature maps monodepth2's encoder uses:
    relu(bn1(conv1)), layer1 .. layer4 (64, 64, 128, 256, 512 channels)."""

    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = resnet_stem()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = basic_layer(64, 64, 2, 1)
        self.layer2 = basic_layer(64, 128, 2, 2)
        self.layer3 = basic_layer(128, 256, 2, 2)
        self.layer4 = basic_layer(256, 512, 2, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        f0 = torch.relu_(self.bn1(self.conv1(x)))
        f1 = self.layer1(self.maxpool(f0))
        f2 = self.layer2(f1)
        f3 = self.layer3(f2)
        return f0, f1, f2, f3, self.layer4(f3)


class ResNeXt101_32x8dFeatures(nn.Module):
    """ResNeXt-101 32x8d returning layer1 .. layer4 (256, 512, 1024, 2048
    channels): the MiDaS v2 encoder under torchvision's names. ``blocks``
    are the bottlenecks per stage, ``groups`` and ``width_per_group`` the
    grouped conv's; the defaults are the published 3-4-23-3, 32 and 8."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 23, 3),
                 groups: int = 32, width_per_group: int = 8):
        super().__init__()
        self.conv1, self.bn1 = resnet_stem()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        width = groups * width_per_group
        self.layer1 = bottleneck_layer(64, width, 256, blocks[0], 1, groups)
        self.layer2 = bottleneck_layer(256, 2 * width, 512, blocks[1], 2,
                                       groups)
        self.layer3 = bottleneck_layer(512, 4 * width, 1024, blocks[2], 2,
                                       groups)
        self.layer4 = bottleneck_layer(1024, 8 * width, 2048, blocks[3], 2,
                                       groups)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = self.maxpool(torch.relu_(self.bn1(self.conv1(x))))
        f1 = self.layer1(y)
        f2 = self.layer2(f1)
        f3 = self.layer3(f2)
        return f1, f2, f3, self.layer4(f3)
