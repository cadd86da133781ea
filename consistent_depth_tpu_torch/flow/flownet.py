"""FlowNet-family optical-flow networks: the port of
``consistent_depth_tpu/flow/flownet.py`` (forward only).

The sub-networks (:class:`FlowNetS`, :class:`FlowNetC`,
:class:`FlowNetSD`, :class:`FlowNetFusion`) take and return NCHW tensors,
channels_last in memory, like the flownet2 submodule's modules; their
attribute names reproduce the released checkpoint's state_dict keys
(``conv3_1.0.weight``, ``upsampled_flow6_to_5.weight``, ...). The cascades
(:class:`FlowNet2CSS`, :class:`FlowNet2`) keep the JAX contract: two
images (B, H, W, 3) in [0, 1] in, flow (B, H, W, 2) in pixels out, with H
and W multiples of 64.

The reference's custom CUDA ops map to:

    correlation_package  -> flow.correlation (hand-written CUDA kernel)
    resample2d_package   -> flow_warp (bilinear, border-clamped reads,
                            zero outside the image)
    channelnorm_package  -> channel_norm

Every conv and transposed conv runs through cuDNN (``nn.Conv2d``,
``nn.ConvTranspose2d``), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..models.layers import resize_bilinear
from ..ops.resample import bilinear_sample_pixels
from . import correlation as corr

RGB_MEAN = (0.411, 0.432, 0.45)
DIV_FLOW = 20.0


def conv_block(cin: int, cout: int, kernel: int = 3,
               stride: int = 1) -> nn.Sequential:
    """Conv2d (same padding, bias) + LeakyReLU(0.1)."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2),
        nn.LeakyReLU(0.1, inplace=True))


def deconv_block(cin: int, cout: int) -> nn.Sequential:
    """ConvTranspose2d(4, 2, 1) + LeakyReLU(0.1): doubles H and W."""
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1),
                         nn.LeakyReLU(0.1, inplace=True))


def predict_flow(cin: int) -> nn.Conv2d:
    return nn.Conv2d(cin, 2, 3, 1, 1)


def upsample_flow() -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=False)


def inter_conv(cin: int, cout: int) -> nn.Sequential:
    """Conv2d(3, 1, 1) with bias and no activation."""
    return nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1))


def flow_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Resample2d: warp ``image`` (B, C, H, W) by ``flow`` (B, 2, H, W) in
    pixels, bilinear with border-clamped reads, zero where the target
    lies outside ``0 <= x <= W-1, 0 <= y <= H-1``."""
    H, W = image.shape[2:]
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device).view(H, 1)
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    x = xs + flow[:, 0]
    y = ys + flow[:, 1]
    out = bilinear_sample_pixels(image.permute(0, 2, 3, 1), x, y)
    in_img = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return (out * in_img.unsqueeze(-1).to(out.dtype)).permute(0, 3, 1, 2)


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """ChannelNorm: L2 norm over channels (dim 1), kept."""
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


class _Refinement(nn.Module):
    """The decoder shared by FlowNetS and FlowNetC: coarse-to-fine flow
    prediction with deconv skip concatenation."""

    def __init__(self):
        super().__init__()
        self.deconv5 = deconv_block(1024, 512)
        self.deconv4 = deconv_block(1026, 256)
        self.deconv3 = deconv_block(770, 128)
        self.deconv2 = deconv_block(386, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(1026)
        self.predict_flow4 = predict_flow(770)
        self.predict_flow3 = predict_flow(386)
        self.predict_flow2 = predict_flow(194)
        self.upsampled_flow6_to_5 = upsample_flow()
        self.upsampled_flow5_to_4 = upsample_flow()
        self.upsampled_flow4_to_3 = upsample_flow()
        self.upsampled_flow3_to_2 = upsample_flow()

    def refine(self, out_conv2, out_conv3, out_conv4, out_conv5, out_conv6):
        """flow2..flow6 (NCHW, 2 channels)."""
        flow6 = self.predict_flow6(out_conv6)
        concat5 = torch.cat((out_conv5, self.deconv5(out_conv6),
                             self.upsampled_flow6_to_5(flow6)), 1)
        flow5 = self.predict_flow5(concat5)
        concat4 = torch.cat((out_conv4, self.deconv4(concat5),
                             self.upsampled_flow5_to_4(flow5)), 1)
        flow4 = self.predict_flow4(concat4)
        concat3 = torch.cat((out_conv3, self.deconv3(concat4),
                             self.upsampled_flow4_to_3(flow4)), 1)
        flow3 = self.predict_flow3(concat3)
        concat2 = torch.cat((out_conv2, self.deconv2(concat3),
                             self.upsampled_flow3_to_2(flow3)), 1)
        flow2 = self.predict_flow2(concat2)
        return flow2, flow3, flow4, flow5, flow6


class FlowNetS(_Refinement):
    """FlowNetS: plain encoder over channel-concatenated inputs."""

    def __init__(self, input_channels: int = 12):
        super().__init__()
        self.conv1 = conv_block(input_channels, 64, 7, 2)
        self.conv2 = conv_block(64, 128, 5, 2)
        self.conv3 = conv_block(128, 256, 5, 2)
        self.conv3_1 = conv_block(256, 256)
        self.conv4 = conv_block(256, 512, 3, 2)
        self.conv4_1 = conv_block(512, 512)
        self.conv5 = conv_block(512, 512, 3, 2)
        self.conv5_1 = conv_block(512, 512)
        self.conv6 = conv_block(512, 1024, 3, 2)
        self.conv6_1 = conv_block(1024, 1024)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        out_conv2 = self.conv2(self.conv1(x))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        return self.refine(out_conv2, out_conv3, out_conv4, out_conv5,
                           out_conv6)


class FlowNetC(_Refinement):
    """FlowNetC: siamese encoder + correlation cost volume."""

    def __init__(self, max_displacement: int = 20, corr_stride: int = 2):
        super().__init__()
        self.max_displacement = max_displacement
        self.corr_stride = corr_stride
        d = 2 * (max_displacement // corr_stride) + 1
        self.conv1 = conv_block(3, 64, 7, 2)
        self.conv2 = conv_block(64, 128, 5, 2)
        self.conv3 = conv_block(128, 256, 5, 2)
        self.conv_redir = conv_block(256, 32, 1, 1)
        self.conv3_1 = conv_block(32 + d * d, 256)
        self.conv4 = conv_block(256, 512, 3, 2)
        self.conv4_1 = conv_block(512, 512)
        self.conv5 = conv_block(512, 512, 3, 2)
        self.conv5_1 = conv_block(512, 512)
        self.conv6 = conv_block(512, 1024, 3, 2)
        self.conv6_1 = conv_block(1024, 1024)

    def forward(self, x1, x2) -> Tuple[torch.Tensor, ...]:
        # siamese encoder: the same modules applied to both images
        out_conv2a = self.conv2(self.conv1(x1))
        out_conv3a = self.conv3(out_conv2a)
        out_conv3b = self.conv3(self.conv2(self.conv1(x2)))

        out_corr = corr.correlation(
            out_conv3a.permute(0, 2, 3, 1), out_conv3b.permute(0, 2, 3, 1),
            self.max_displacement, self.corr_stride).permute(0, 3, 1, 2)
        out_corr = nn.functional.leaky_relu(out_corr, 0.1, inplace=True)
        merged = torch.cat((self.conv_redir(out_conv3a), out_corr), 1)

        out_conv3 = self.conv3_1(merged)
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        return self.refine(out_conv2a, out_conv3, out_conv4, out_conv5,
                           out_conv6)


class FlowNetSD(nn.Module):
    """FlowNetSD: the small-displacement branch of FlowNet2 (3x3 convs
    only, an extra stride-1 conv0, inter_conv refinement)."""

    def __init__(self):
        super().__init__()
        self.conv0 = conv_block(6, 64)
        self.conv1 = conv_block(64, 64, 3, 2)
        self.conv1_1 = conv_block(64, 128)
        self.conv2 = conv_block(128, 128, 3, 2)
        self.conv2_1 = conv_block(128, 128)
        self.conv3 = conv_block(128, 256, 3, 2)
        self.conv3_1 = conv_block(256, 256)
        self.conv4 = conv_block(256, 512, 3, 2)
        self.conv4_1 = conv_block(512, 512)
        self.conv5 = conv_block(512, 512, 3, 2)
        self.conv5_1 = conv_block(512, 512)
        self.conv6 = conv_block(512, 1024, 3, 2)
        self.conv6_1 = conv_block(1024, 1024)
        self.deconv5 = deconv_block(1024, 512)
        self.deconv4 = deconv_block(1026, 256)
        self.deconv3 = deconv_block(770, 128)
        self.deconv2 = deconv_block(386, 64)
        self.inter_conv5 = inter_conv(1026, 512)
        self.inter_conv4 = inter_conv(770, 256)
        self.inter_conv3 = inter_conv(386, 128)
        self.inter_conv2 = inter_conv(194, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(512)
        self.predict_flow4 = predict_flow(256)
        self.predict_flow3 = predict_flow(128)
        self.predict_flow2 = predict_flow(64)
        self.upsampled_flow6_to_5 = upsample_flow()
        self.upsampled_flow5_to_4 = upsample_flow()
        self.upsampled_flow4_to_3 = upsample_flow()
        self.upsampled_flow3_to_2 = upsample_flow()

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))

        flow6 = self.predict_flow6(out_conv6)
        concat5 = torch.cat((out_conv5, self.deconv5(out_conv6),
                             self.upsampled_flow6_to_5(flow6)), 1)
        flow5 = self.predict_flow5(self.inter_conv5(concat5))
        concat4 = torch.cat((out_conv4, self.deconv4(concat5),
                             self.upsampled_flow5_to_4(flow5)), 1)
        flow4 = self.predict_flow4(self.inter_conv4(concat4))
        concat3 = torch.cat((out_conv3, self.deconv3(concat4),
                             self.upsampled_flow4_to_3(flow4)), 1)
        flow3 = self.predict_flow3(self.inter_conv3(concat3))
        concat2 = torch.cat((out_conv2, self.deconv2(concat3),
                             self.upsampled_flow3_to_2(flow3)), 1)
        flow2 = self.predict_flow2(self.inter_conv2(concat2))
        return flow2, flow3, flow4, flow5, flow6


class FlowNetFusion(nn.Module):
    """FlowNetFusion: fuses the CSS and SD flows at full resolution from
    an 11-channel input (img0, both flows, their norms, both warp-error
    norms)."""

    def __init__(self):
        super().__init__()
        self.conv0 = conv_block(11, 64)
        self.conv1 = conv_block(64, 64, 3, 2)
        self.conv1_1 = conv_block(64, 128)
        self.conv2 = conv_block(128, 128, 3, 2)
        self.conv2_1 = conv_block(128, 128)
        self.deconv1 = deconv_block(128, 32)
        self.deconv0 = deconv_block(162, 16)
        self.inter_conv1 = inter_conv(162, 32)
        self.inter_conv0 = inter_conv(82, 16)
        self.predict_flow2 = predict_flow(128)
        self.predict_flow1 = predict_flow(32)
        self.predict_flow0 = predict_flow(16)
        self.upsampled_flow2_to_1 = upsample_flow()
        self.upsampled_flow1_to_0 = upsample_flow()

    def forward(self, x) -> torch.Tensor:
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))

        flow2 = self.predict_flow2(out_conv2)
        concat1 = torch.cat((out_conv1, self.deconv1(out_conv2),
                             self.upsampled_flow2_to_1(flow2)), 1)
        flow1 = self.predict_flow1(self.inter_conv1(concat1))
        concat0 = torch.cat((out_conv0, self.deconv0(concat1),
                             self.upsampled_flow1_to_0(flow1)), 1)
        return self.predict_flow0(self.inter_conv0(concat0))


def _up4(flow: torch.Tensor, scale: float) -> torch.Tensor:
    """x4 bilinear upsample of a 1/4-resolution flow map, scaled by the
    training-time flow normalisation (FlowNet2's Upsample(4) glue)."""
    h, w = flow.shape[2:]
    return scale * resize_bilinear(flow, (4 * h, 4 * w), align_corners=False)


def _images_in(im1: torch.Tensor, im2: torch.Tensor):
    """(B, H, W, 3) images -> mean-subtracted NCHW, channels_last."""
    mean = torch.tensor(RGB_MEAN, dtype=im1.dtype, device=im1.device)
    return ((im1 - mean).permute(0, 3, 1, 2),
            (im2 - mean).permute(0, 3, 1, 2))


class FlowNet2CSS(nn.Module):
    """The FlowNet2 cascade C -> S -> S (the released checkpoint's stack
    without the SD/fusion branch). Images (B, H, W, 3) in [0, 1] ->
    flow (B, H, W, 2) in pixels."""

    def __init__(self, div_flow: float = DIV_FLOW):
        super().__init__()
        self.div_flow = div_flow
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()

    def css(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """The C -> S -> S stack on mean-subtracted NCHW inputs; returns
        full-resolution NCHW flow in pixels."""
        flow = _up4(self.flownetc(x1, x2)[0], self.div_flow)
        for net in (self.flownets_1, self.flownets_2):
            warped = flow_warp(x2, flow)
            diff = channel_norm(x1 - warped)
            inp = torch.cat((x1, x2, warped, flow / self.div_flow, diff), 1)
            flow = _up4(net(inp)[0], self.div_flow)
        return flow

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        return self.css(*_images_in(im1, im2)).permute(0, 2, 3, 1)


class FlowNet2(FlowNet2CSS):
    """The complete FlowNet2: CSS (large displacement) + SD (small
    displacement) + fusion, with the released ``flownet2.pth``'s
    structure. Images (B, H, W, 3) in [0, 1], H and W multiples of 64 ->
    flow (B, H, W, 2) in pixels."""

    def __init__(self, div_flow: float = DIV_FLOW):
        super().__init__(div_flow)
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        x1, x2 = _images_in(im1, im2)

        # large-displacement branch
        css_flow = self.css(x1, x2)
        css_norm = channel_norm(css_flow)
        css_err = channel_norm(x1 - flow_warp(x2, css_flow))

        # small-displacement branch (the / div_flow is the released
        # checkpoint's: SD was trained with the inverse normalisation)
        sd_flow = _up4(self.flownets_d(torch.cat((x1, x2), 1))[0],
                       1.0 / self.div_flow)
        sd_norm = channel_norm(sd_flow)
        sd_err = channel_norm(x1 - flow_warp(x2, sd_flow))

        fused_in = torch.cat(
            (x1, sd_flow, css_flow, sd_norm, css_norm, sd_err, css_err), 1)
        return self.flownetfusion(fused_in).permute(0, 2, 3, 1)
