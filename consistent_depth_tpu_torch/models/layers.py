"""Layers: the port of the subset of ``consistent_depth_tpu/models/layers.py``
that the MannequinChallenge network and the FlowNet family use.

- :class:`SameConv2d`: ``nn.Conv2d`` whose stride-1, dilation-1,
  same-padding, odd k >= 3 convs run through the hand-written CUDA kernel
  (:func:`..ops.s2d_conv.same_conv`). Every such conv is routed, whatever its
  resolution: the JAX package's space-to-depth threshold is an MXU trade
  that has no meaning on Hopper. The 1x1 convs stay on ``F.conv2d``. Convs
  compute in the dtype of their input, so f32 parameters serve a bf16
  forward (the JAX package's compute dtype, ``layers.py::conv_compute``).
- Batch norm, 2x average pooling and the 2x bilinear upsample
  (align_corners=True) are PyTorch's own modules, whose semantics the JAX
  package reproduces (``TorchBatchNorm``, ``avg_pool_2x``,
  ``upsample_bilinear_2x``). Batch norm takes a bf16 input beside f32
  running stats: it computes the statistics in f32 and returns bf16.
- :func:`resize_bilinear`: ``F.interpolate(mode="bilinear")``, which the
  JAX package reproduces with interpolation matmuls.
- :func:`init_parameters`: flax's ``lecun_normal`` initialisation (a
  normal truncated at two standard deviations, scaled by the fan-in) from an
  explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import s2d_conv

# flax's truncated_normal divides by the std of a unit normal truncated
# to [-2, 2] so that the kept samples have the requested variance
_TRUNC_STD = 0.87962566103423978


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and state_dict) whose stride-1,
    dilation-1, odd k >= 3 convs with same zero padding run through
    :func:`same_conv`. Activations are NCHW tensors, channels_last in
    memory, so the NHWC view the kernel takes is free."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        k = self.kernel_size[0]
        self.routed = (
            self.kernel_size == (k, k) and k % 2 == 1 and k >= 3
            and self.stride == (1, 1) and self.dilation == (1, 1)
            and self.padding == ((k - 1) // 2,) * 2 and self.groups == 1
            and self.padding_mode == "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the conv computes in the activations' dtype: f32 parameters meet
        # bf16 activations as a bf16 copy, as the JAX package's compute
        # dtype casts its kernels (no copy when the dtypes agree)
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        if not self.routed:
            return self._conv_forward(x, w, b)
        y = s2d_conv.same_conv(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0), b)
        return y.permute(0, 3, 1, 2)


def resize_bilinear(x: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw`` (no antialiasing)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` for a conv weight (O, I, kh, kw). Applied to a
    transposed-conv weight (I, O, kh, kw) it scales by kh * kw * O, the
    fan-in flax's ``ConvTranspose(transpose_kernel=True)`` uses."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    # inverse-CDF sampling of the normal truncated to [-2, 2] std: one
    # uniform draw per element, the same values on every torch version
    # (nn.init.trunc_normal_ rejection-samples, ~10x slower on FlowNet2's
    # 162 M parameters)
    edge = math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        w.uniform_(-edge, edge, generator=generator)
        w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


def init_parameters(net: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter and buffer of ``net`` as the JAX package
    does (``ConvParams``/``TorchBatchNorm``, flax ``ConvTranspose``): conv
    and transposed-conv kernels lecun-normal, their biases 0, BN scale 1
    and bias 0, running mean 0 and variance 1. Modules are visited in
    registration order, so a seed fixes the result."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
