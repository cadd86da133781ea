"""Monodepth2 backbone: the port of
``consistent_depth_tpu/models/monodepth2.py`` (reference adapter:
monodepth/monodepth2_model.py; architecture: ResNet-18 encoder +
DepthDecoder with sigmoid disparity heads at 4 scales, Godard et al., ICCV
2019).

The decoder is a nearest-2x U-Net over the encoder's five feature maps with
reflection-padded 3x3 convs and ELU. Keys are the released ones:
``encoder.*`` (torchvision names) and ``decoder.{0..13}.conv[.conv]`` in the
order of the reference's OrderedDict (upconv 4..0 x {0, 1}, then dispconv
0..3). The decoder's reflect-padded convs are flax ``nn.Conv``s in the JAX
package, outside ``conv_compute``, so they stay on cuDNN here; the encoder's
stride-1 3x3 convs take the hand-written kernel.

The adapter resizes the input bicubic to the feed size (1024x320 for the
released checkpoint), resizes the disparity back bicubic and returns
depth = 1/disparity (monodepth2_model.py:63-89). The KITTI preset selects
this backbone.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .base import DepthModel
from .layers import SameConv2d, resize_bicubic, upsample_nearest_2x
from .resnet import ResNet18Features

NUM_CH_ENC = (64, 64, 128, 256, 512)
NUM_CH_DEC = (16, 32, 64, 128, 256)
SCALES = (0, 1, 2, 3)


class ReflectConv3x3(nn.Module):
    """monodepth2's Conv3x3: reflection pad 1, then a 3x3 conv (the
    ``conv`` child)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = SameConv2d(in_features, features, 3, padding=1,
                               padding_mode="reflect")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (``conv.conv`` in the keys)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = ReflectConv3x3(in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.elu(self.conv(x))


def decoder_convs() -> nn.ModuleList:
    """The decoder's 14 convs in the released order, ``decoder.0`` ..
    ``decoder.13``: upconv (i, 0) and (i, 1) for i = 4 .. 0, then the
    dispconvs of scales 0 .. 3."""
    convs = []
    for i in range(4, -1, -1):
        c_in = NUM_CH_ENC[-1] if i == 4 else NUM_CH_DEC[i + 1]
        convs.append(ConvBlock(c_in, NUM_CH_DEC[i]))
        c_in = NUM_CH_DEC[i] + (NUM_CH_ENC[i - 1] if i > 0 else 0)
        convs.append(ConvBlock(c_in, NUM_CH_DEC[i]))
    convs += [ReflectConv3x3(NUM_CH_DEC[s], 1) for s in SCALES]
    return nn.ModuleList(convs)


def depth_decoder(convs: nn.ModuleList, features: Sequence[torch.Tensor]
                  ) -> Dict[int, torch.Tensor]:
    """The decoder over the encoder's features (f0 .. f4): the sigmoid
    disparity (B, 1, H / 2^s, W / 2^s) of each scale s."""
    outputs = {}
    x = features[-1]
    for n, i in enumerate(range(4, -1, -1)):
        x = [upsample_nearest_2x(convs[2 * n](x))]
        if i > 0:
            x.append(features[i - 1])
        x = convs[2 * n + 1](torch.cat(x, 1))
        if i in SCALES:
            outputs[i] = torch.sigmoid(convs[10 + i](x))
    return outputs


class Monodepth2Net(nn.Module):
    """Encoder and decoder; input (B, 3, H, W) in [0, 1], in whatever
    channel order the pipeline feeds (BGR, as the reference's usage).
    Returns the disparity (B, 1, H / 2^s, W / 2^s) per scale s."""

    def __init__(self):
        super().__init__()
        self.encoder = ResNet18Features()
        self.decoder = decoder_convs()

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        # the ResnetEncoder's normalisation
        return depth_decoder(self.decoder,
                             self.encoder((x - 0.45) / 0.225))


class Monodepth2Model(DepthModel):
    align = 1
    learning_rate = 0.00004
    lambda_view_baseline = 1
    default_checkpoint = "checkpoints/monodepth2_mono+stereo_1024x320"
    feed_height = 320
    feed_width = 1024

    def __init__(self, checkpoint: Optional[str] = None, seed: int = 0,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 feed_size: Optional[Tuple[int, int]] = None):
        """``feed_size`` (height, width) replaces the released 320x1024
        feed; a checkpoint directory's ``encoder.pth`` sets it in turn."""
        if feed_size is not None:
            self.feed_height, self.feed_width = feed_size
        super().__init__(checkpoint=checkpoint, seed=seed, device=device,
                         dtype=dtype)

    def _make_module(self) -> nn.Module:
        return Monodepth2Net()

    def _read_checkpoint(self, path: str) -> Dict[str, torch.Tensor]:
        """The released checkpoint is a directory: ``encoder.pth``, which
        also carries the feed size (and ``use_stereo``, dropped), and
        ``depth.pth`` (monodepth2_model.py:26-50). The released encoder is
        a whole torchvision ResNet-18, whose classifier ``encoder.fc`` the
        depth network does not have: its two keys are dropped, every other
        key loads strictly. A single ``.pth``, as the fine-tune writes,
        loads as any other."""
        if not os.path.isdir(path):
            return super()._read_checkpoint(path)
        from .torch_import import load_checkpoint

        enc = load_checkpoint(os.path.join(path, "encoder.pth"))
        self.feed_height = int(enc.pop("height", self.feed_height))
        self.feed_width = int(enc.pop("width", self.feed_width))
        enc.pop("use_stereo", None)
        enc.pop("encoder.fc.weight", None)
        enc.pop("encoder.fc.bias", None)
        # the two state_dicts carry their "encoder." / "decoder." prefixes
        return {**enc, **load_checkpoint(os.path.join(path, "depth.pth"))}

    def estimate_depth(self, images: torch.Tensor) -> torch.Tensor:
        B, N, H, W, C = images.shape
        x = images.reshape(B * N, H, W, C).permute(0, 3, 1, 2)
        x = resize_bicubic(x, (self.feed_height, self.feed_width))
        disp = resize_bicubic(self.net(x)[0], (H, W))
        return (1.0 / disp[:, 0]).reshape(B, N, H, W)
