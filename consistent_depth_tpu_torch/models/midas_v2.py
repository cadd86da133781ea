"""MiDaS v2 backbone: the port of ``consistent_depth_tpu/models/midas_v2.py``
(reference adapter: monodepth/midas_v2_model.py; architecture: the midas_v2
submodule's MidasNet, a ResNeXt-101 32x8d WSL encoder with a RefineNet-style
feature-fusion decoder, Ranftl et al.).

Keys are the released ones:

    pretrained.layer1.{0,1}        stem conv and bn
    pretrained.layer1.4.{b}.*      ResNeXt layer1 blocks
    pretrained.layer{2,3,4}.{b}.*  ResNeXt layers
    scratch.layer{1..4}_rn         3x3 transition convs (no bias)
    scratch.refinenet{1..4}.resConfUnit{1,2}.conv{1,2}
    scratch.output_conv.{0,2,4}

The JAX package names the decoder's modules flat (``scratch_layer1_rn``,
``scratch_output_conv_0``); :meth:`MidasV2Model._read_checkpoint` takes a
``.pth`` in either spelling (``torch_import.released_midas_keys``).

The transition convs, the residual conv units and the two 3x3 output convs
go through the hand-written k x k conv kernel, as they go through
``conv_compute`` in the JAX package; the encoder's grouped 3x3 convs (flax
``nn.Conv`` there) stay on cuDNN.

``refinenet4.resConfUnit1`` is in the state_dict but never called: only
refinenets 1-3 receive a skip input. It gets no gradient from autograd; the
training engine gives it an exact zero one, as JAX does.

The adapter applies the ImageNet mean and std to the BGR input exactly as
the reference does (midas_v2_model.py:47-59); the network emits
non-negative disparity and depth = 1/disparity, unprotected, as in the
reference and the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import DepthModel
from .layers import SameConv2d, resize_bilinear
from .resnet import ResNeXt101_32x8dFeatures
from .torch_import import released_midas_keys

_NORM_MEAN = (0.485, 0.456, 0.406)
_NORM_STD = (0.229, 0.224, 0.225)
# the decoder's width
FEATURES = 256


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = SameConv2d(features, features, 3, 1, 1)
        self.conv2 = SameConv2d(features, features, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(x))
        return self.conv2(F.relu(y)) + x


class FeatureFusionBlock(nn.Module):
    """``x`` (+ resConfUnit1(``skip``)) -> resConfUnit2 -> bilinear resize
    with align_corners=True, to ``size`` or by 2x -> with ``out_conv``, a
    1x1 conv (Depth Anything V2's blocks; MiDaS v2's have none)."""

    def __init__(self, features: int, out_conv: bool = False):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = (SameConv2d(features, features, 1) if out_conv
                         else None)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                size: Optional[Sequence[int]] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        y = self.resConfUnit2(x)
        H, W = y.shape[2:]
        y = resize_bilinear(y, size or (2 * H, 2 * W), align_corners=True)
        return y if self.out_conv is None else self.out_conv(y)


class _Upsample2x(nn.Module):
    """output_conv.1: bilinear 2x upsample, align_corners=False."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2:]
        return resize_bilinear(x, (2 * H, 2 * W), align_corners=False)


class MidasNet(nn.Module):
    """MidasNet(features=256, non_negative=True); input (B, 3, H, W) with
    H and W multiples of 32, output disparity (B, H, W). ``blocks`` are the
    ResNeXt 32x8d encoder's bottlenecks per stage; the default is the
    published 3-4-23-3."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        # MiDaS's _make_resnet_backbone: the ResNeXt's modules regrouped
        # under its pretrained.layer{1..4}
        r = ResNeXt101_32x8dFeatures(blocks)
        self.pretrained = nn.Module()
        self.pretrained.layer1 = nn.Sequential(
            r.conv1, r.bn1, nn.ReLU(inplace=True), r.maxpool, r.layer1)
        (self.pretrained.layer2, self.pretrained.layer3,
         self.pretrained.layer4) = r.layer2, r.layer3, r.layer4
        self.scratch = nn.Module()
        for i, c in enumerate((256, 512, 1024, 2048), 1):
            setattr(self.scratch, f"layer{i}_rn",
                    SameConv2d(c, FEATURES, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}",
                    FeatureFusionBlock(FEATURES))
        self.scratch.output_conv = nn.Sequential(
            SameConv2d(FEATURES, 128, 3, 1, 1), _Upsample2x(),
            SameConv2d(128, 32, 3, 1, 1), nn.ReLU(),
            SameConv2d(32, 1, 1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class MidasV2Model(DepthModel):
    align = 32
    learning_rate = 0.0001
    lambda_view_baseline = 0.0001
    default_checkpoint = "checkpoints/midas2.pth"

    def _make_module(self) -> nn.Module:
        return MidasNet()

    def _read_checkpoint(self, path: str) -> Dict[str, torch.Tensor]:
        return released_midas_keys(super()._read_checkpoint(path))

    def to(self, device, dtype: torch.dtype) -> "MidasV2Model":
        super().to(device, dtype)
        # the normalisation's constants, made once on the device: no
        # host-to-device copy in a forward
        self._mean, self._std = (
            torch.tensor(v, dtype=torch.float32, device=self.device)
            for v in (_NORM_MEAN, _NORM_STD))
        return self

    def estimate_depth(self, images: torch.Tensor) -> torch.Tensor:
        B, N, H, W, C = images.shape
        x = images.reshape(B * N, H, W, C)
        x = (x - self._mean.to(x.dtype)) / self._std.to(x.dtype)
        disp = self.net(x.permute(0, 3, 1, 2))
        return (1.0 / disp).reshape(B, N, H, W)
