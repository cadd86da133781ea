"""Depth Anything V2 (Yang et al., NeurIPS 2024, https://arxiv.org/abs/2406.09414;
``depth_anything_v2/dpt.py`` of the public Depth-Anything-V2 code): a DINOv2
ViT encoder (``models/vit.py``) tapped after four blocks, and its DPT head.
``dav2-large`` is ``encoder='vitl'``: ViT-L/14 at 518, taps after blocks 4,
11, 17 and 23, ``features=256``, ``out_channels=[256, 512, 1024, 1024]``,
``use_bn=False``, ``use_clstoken=False``; 335,315,649 parameters. The JAX
package has no such backbone; this module is the port's own.

The head (``DPTHead``), on the taps' patch tokens reshaped to (dim, h0, w0)
(the cls token dropped):

    projects.{0..3}          1x1 convs to out_channels
    resize_layers.{0,1,3}    ConvTranspose 4x4/4, ConvTranspose 2x2/2, a 3x3
                             stride-2 conv (2 is the identity)
    scratch.layer{1..4}_rn   3x3 convs to ``features``, no bias
    scratch.refinenet{1..4}  MiDaS's fusion blocks (``midas_v2.py``), each
                             with a 1x1 ``out_conv`` after its resize: 4, 3
                             and 2 resize to the next tap's size, 1 by 2x
                             (align_corners=True)
    scratch.output_conv1     3x3, features -> features / 2
    (bilinear resize to 14 h0 x 14 w0, align_corners=True)
    scratch.output_conv2     3x3 -> 32, ReLU, 1x1 -> 1, ReLU

and a final ReLU: the network's output is disparity. The keys are the
released ones under ``pretrained.`` and ``depth_head.``, so a released
``depth_anything_v2_vitl.pth`` loads as it is (none is in the repository).

The stride-1 3x3 convs run on the hand-written k x k conv kernel
(``layers.SameConv2d``), the patch conv, the stride-2 conv and the 1x1 convs
on the library's convs. The transposed convs, whose kernel equals their
stride, are one GEMM and a pixel shuffle each
(``ops/transformer.py::conv_transpose_patches``), in the linears' span.

``refinenet4.resConfUnit1`` and the encoder's ``mask_token`` are in the
state_dict but never used; the training engine gives them an exact zero
gradient. The adapter flips the BGR input to RGB and applies the ImageNet
mean and std, as the published transform does, and feeds a frame whose
sides are not multiples of 14 at the multiples below them, resizing the
disparity back, as the published ``infer_image`` does; depth = 1 /
disparity, unprotected, as ``midas_v2.py``'s.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import transformer
from .base import DepthModel
from .layers import SameConv2d, resize_bicubic, resize_bilinear
from .midas_v2 import FeatureFusionBlock
from .vit import PATCH, DinoVisionTransformer

_NORM_MEAN = (0.485, 0.456, 0.406)
_NORM_STD = (0.229, 0.224, 0.225)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose kernel equals its stride, computed as
    one linear over the input pixels (:func:`..ops.transformer.
    conv_transpose_patches`), in the input's dtype."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if (self.kernel_size != self.stride or self.padding != (0, 0)
                or self.output_padding != (0, 0) or self.groups != 1
                or self.dilation != (1, 1)):
            raise ValueError("ConvTranspose2d: the patches must not overlap "
                             "(kernel = stride, no padding, one group)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return transformer.conv_transpose_patches(
            x, self.weight.to(x.dtype), b)


class DPTHead(nn.Module):
    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024)):
        super().__init__()
        self.projects = nn.ModuleList(
            [SameConv2d(in_channels, c, 1) for c in out_channels])
        c0, c1, _, c3 = out_channels
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(c0, c0, 4, stride=4),
            ConvTranspose2d(c1, c1, 2, stride=2),
            nn.Identity(),
            SameConv2d(c3, c3, 3, 2, 1)])
        self.scratch = nn.Module()
        for i, c in enumerate(out_channels, 1):
            setattr(self.scratch, f"layer{i}_rn",
                    SameConv2d(c, features, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}",
                    FeatureFusionBlock(features, out_conv=True))
        self.scratch.output_conv1 = SameConv2d(features, features // 2, 3,
                                               1, 1)
        self.scratch.output_conv2 = nn.Sequential(
            SameConv2d(features // 2, 32, 3, 1, 1), nn.ReLU(),
            SameConv2d(32, 1, 1), nn.ReLU())

    def forward(self, tokens: List[torch.Tensor], h0: int,
                w0: int) -> torch.Tensor:
        """The taps' patch tokens (B, h0 w0, dim) -> (B, 1, 14 h0, 14 w0)."""
        layers = []
        for x, project, resize in zip(tokens, self.projects,
                                      self.resize_layers):
            # (B, dim, h0, w0), channels_last in memory: a view
            x = x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h0, w0)
            layers.append(resize(project(x)))
        s = self.scratch
        rn = [getattr(s, f"layer{i}_rn")(x) for i, x in enumerate(layers, 1)]
        path = s.refinenet4(rn[3], size=rn[2].shape[2:])
        path = s.refinenet3(path, rn[2], size=rn[1].shape[2:])
        path = s.refinenet2(path, rn[1], size=rn[0].shape[2:])
        path = s.refinenet1(path, rn[0])
        out = s.output_conv1(path)
        out = resize_bilinear(out, (PATCH * h0, PATCH * w0),
                              align_corners=True)
        return s.output_conv2(out)


class DepthAnythingV2(nn.Module):
    """(B, 3, H, W) normalised RGB, H and W multiples of 14 -> disparity
    (B, H, W). The defaults are ``encoder='vitl'``; smaller widths and
    depths build the same network for tests."""

    def __init__(self, img_size: int = 518, dim: int = 1024, depth: int = 24,
                 heads: int = 16, taps: Sequence[int] = (4, 11, 17, 23),
                 features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024)):
        super().__init__()
        self.taps = tuple(taps)
        self.pretrained = DinoVisionTransformer(img_size, dim, depth, heads)
        self.depth_head = DPTHead(dim, features, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0, w0 = x.shape[2] // PATCH, x.shape[3] // PATCH
        tokens = self.pretrained.get_intermediate_layers(x, self.taps)
        return F.relu(self.depth_head(tokens, h0, w0))[:, 0]


class DepthAnythingV2Model(DepthModel):
    align = PATCH
    # DA2's published encoder rate (the engine takes one rate) and MiDaS
    # v2's disparity weight, for a disparity network
    learning_rate = 5e-6
    lambda_view_baseline = 1e-4
    default_checkpoint = "checkpoints/depth_anything_v2_vitl.pth"

    def _make_module(self) -> nn.Module:
        return DepthAnythingV2()

    def to(self, device, dtype: torch.dtype) -> "DepthAnythingV2Model":
        super().to(device, dtype)
        # the normalisation's constants, made once on the device: no
        # host-to-device copy in a forward
        self._mean, self._std = (
            torch.tensor(v, dtype=torch.float32, device=self.device)
            for v in (_NORM_MEAN, _NORM_STD))
        return self

    def estimate_depth(self, images: torch.Tensor) -> torch.Tensor:
        B, N, H, W, C = images.shape
        x = images.reshape(B * N, H, W, C).flip(-1)
        x = (x - self._mean.to(x.dtype)) / self._std.to(x.dtype)
        x = x.permute(0, 3, 1, 2)
        # a frame whose sides are not multiples of 14 (the CLI's depth
        # size is aligned to 16) is fed as the published transform feeds
        # it: resized bicubically to the multiples of 14 below its sides,
        # the disparity resized back bilinearly (align_corners=True)
        h, w = (max(n // PATCH, 1) * PATCH for n in (H, W))
        if (h, w) == (H, W):
            disp = self.net(x)
        else:
            disp = resize_bilinear(self.net(resize_bicubic(x, (h, w)))[:, None],
                                   (H, W), align_corners=True)[:, 0]
        return (1.0 / disp).reshape(B, N, H, W)
