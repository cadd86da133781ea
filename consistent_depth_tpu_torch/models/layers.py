"""Layers: the port of the subset of ``consistent_depth_tpu/models/layers.py``
that the backbones (MannequinChallenge, monodepth2, MiDaS v2) and the FlowNet
family use.

- :class:`SameConv2d`: ``nn.Conv2d`` whose stride-1, dilation-1,
  same-padding, odd k >= 3 convs run through the hand-written CUDA kernel
  (:func:`..ops.s2d_conv.same_conv`). Every such conv is routed, whatever its
  resolution: the JAX package's space-to-depth threshold is an MXU trade
  that has no meaning on Hopper. Its grouped 3x3 convs (ResNeXt's) go
  through :func:`..ops.grouped_conv.grouped_conv`, whose grad-weight is a
  hand-written CUDA kernel. The 1x1 convs stay on ``F.conv2d``. Convs
  compute in the dtype of their input, so f32 parameters serve a bf16
  forward (the JAX package's compute dtype, ``layers.py::conv_compute``).
- Batch norm, 2x average pooling and the 2x bilinear upsample
  (align_corners=True) are PyTorch's own modules, whose semantics the JAX
  package reproduces (``TorchBatchNorm``, ``avg_pool_2x``,
  ``upsample_bilinear_2x``). Batch norm takes a bf16 input beside f32
  running stats: it computes the statistics in f32 and returns bf16.
- :func:`resize_bilinear`, :func:`resize_bicubic`: ``F.interpolate``,
  which the JAX package reproduces with interpolation matmuls whose border
  taps are folded onto the clamped edge samples as torch's are (so the
  bicubic downsample back from monodepth2's feed matches too), and
  :func:`upsample_nearest_2x`. The JAX package's ``max_pool`` is
  ``nn.MaxPool2d`` (its padding enters as -inf, as torch's does).
- :func:`init_parameters`: flax's ``lecun_normal`` initialisation (a
  normal truncated at two standard deviations, scaled by the fan-in) of the
  convs, and a ViT's (DINOv2's: linears N(0, 0.02^2) truncated at two
  standard deviations, LayerNorms 1 and 0, the rest by its module's
  ``reset_free_parameters``), from an explicit generator.
- :class:`GlobalBatchNorm2d` and :func:`convert_global_batch_norm`: batch
  norm whose train-mode statistics are those of the global batch of a data
  mesh (``..parallel.mesh``), as the JAX package's one program over the
  mesh computes them (``fused_batch_norm_pure``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import grouped_conv, s2d_conv
from ..parallel.mesh import Mesh, all_reduce_sum

# flax's truncated_normal divides by the std of a unit normal truncated
# to [-2, 2] so that the kept samples have the requested variance
_TRUNC_STD = 0.87962566103423978


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and state_dict) whose stride-1,
    dilation-1, odd k >= 3 convs with same zero padding run through
    :func:`same_conv` (``routed``), and whose grouped 3x3 convs that
    :func:`grouped_conv.takes` through :func:`grouped_conv.grouped_conv`
    (``grouped``). Activations are NCHW tensors, channels_last in memory,
    so the NHWC views the kernels take are free."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        k = self.kernel_size[0]
        self.routed = (
            self.kernel_size == (k, k) and k % 2 == 1 and k >= 3
            and self.stride == (1, 1) and self.dilation == (1, 1)
            and self.padding == ((k - 1) // 2,) * 2 and self.groups == 1
            and self.padding_mode == "zeros")
        self.grouped = grouped_conv.takes(
            self.in_channels, self.out_channels, self.kernel_size,
            self.stride, self.padding, self.dilation, self.groups,
            self.padding_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the conv computes in the activations' dtype: f32 parameters meet
        # bf16 activations as a bf16 copy, as the JAX package's compute
        # dtype casts its kernels (no copy when the dtypes agree)
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        if self.grouped:
            return grouped_conv.grouped_conv(x, w, b, self.stride[0],
                                             self.groups)
        if not self.routed:
            return self._conv_forward(x, w, b)
        y = s2d_conv.same_conv(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0), b)
        return y.permute(0, 3, 1, 2)


def resize_bilinear(x: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw`` (no antialiasing)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def resize_bicubic(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bicubic resize (A = -0.75, align_corners=False, no antialiasing) of
    an NCHW tensor to ``out_hw``."""
    return F.interpolate(x, size=tuple(out_hw), mode="bicubic",
                         align_corners=False)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(scale_factor=2, mode="nearest")`` of an NCHW
    tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def trunc_normal_(w: torch.Tensor, std: float,
                  generator: torch.Generator) -> None:
    """N(0, std^2) truncated to [-2 std, 2 std], in place."""
    # inverse-CDF sampling: one uniform draw per element, the same values on
    # every torch version (nn.init.trunc_normal_ rejection-samples, ~10x
    # slower on FlowNet2's 162 M parameters)
    edge = math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        w.uniform_(-edge, edge, generator=generator)
        w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` for a conv weight (O, I, kh, kw). Applied to a
    transposed-conv weight (I, O, kh, kw) it scales by kh * kw * O, the
    fan-in flax's ``ConvTranspose(transpose_kernel=True)`` uses."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    trunc_normal_(w, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


# a linear's weight std in a ViT (DINOv2's ``init_weights_vit_timm``)
LINEAR_STD = 0.02


def init_parameters(net: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter and buffer of ``net`` as the JAX package
    does (``ConvParams``/``TorchBatchNorm``, flax ``ConvTranspose``): conv
    and transposed-conv kernels lecun-normal, their biases 0, BN scale 1
    and bias 0, running mean 0 and variance 1; and a ViT's layers as DINOv2
    does: linear weights N(0, LINEAR_STD^2) truncated at two standard
    deviations, their biases 0, LayerNorm scale 1 and shift 0. A module
    with parameters outside these layers (a LayerScale, a cls token)
    fills them in its ``reset_free_parameters(generator)``. Modules are
    visited in registration order, so a seed fixes the result."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, nn.Linear):
            trunc_normal_(m.weight, LINEAR_STD, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        if hasattr(m, "reset_free_parameters"):
            m.reset_free_parameters(generator)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and state_dict keys)
    whose train-mode statistics are taken over the global batch of
    ``mesh``: one ``all_reduce_sum`` of ``[sum x, sum x^2, n]`` per call,
    in f32 whatever the input dtype, then mean = E[x] and var =
    max(E[x^2] - E[x]^2, 0), the JAX package's formula
    (``models/layers.py::fused_batch_norm_pure``). The running variance is
    unbiased by n / (n - 1) with the global n. The normalisation computes
    in f32 and rounds once to the input dtype, as torch's batch norm does
    for a bf16 input. In eval mode it is ``nn.BatchNorm2d``'s, on the
    running stats, with no collective."""

    def __init__(self, num_features: int, mesh: Mesh, **kwargs):
        super().__init__(num_features, **kwargs)
        if self.momentum is None or not self.track_running_stats:
            raise ValueError("GlobalBatchNorm2d keeps running stats with a "
                             "fixed momentum")
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        C = self.num_features
        x32 = x.float()
        n_local = x32.numel() // C
        stats = all_reduce_sum(self.mesh, torch.cat([
            x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3)),
            x32.new_full((1,), float(n_local))]))
        n = stats[2 * C]
        mean = stats[:C] / n
        var = torch.clamp(stats[C:2 * C] / n - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(
                m * var.detach() * (n / torch.clamp(n - 1, min=1)))
            self.num_batches_tracked.add_(1)
        y = ((x32 - mean[None, :, None, None])
             * torch.rsqrt(var + self.eps)[None, :, None, None])
        if self.affine:
            y = (y * self.weight[None, :, None, None]
                 + self.bias[None, :, None, None])
        return y.to(x.dtype)


def convert_global_batch_norm(net: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap every ``nn.BatchNorm2d`` of ``net``, in place, for a
    :class:`GlobalBatchNorm2d` over ``mesh`` holding the same parameter and
    buffer tensors (the optimizer and the engine's parameter map stay
    valid); returns ``net``."""
    for name, child in net.named_children():
        if type(child) is nn.BatchNorm2d:
            bn = GlobalBatchNorm2d(
                child.num_features, mesh, eps=child.eps,
                momentum=child.momentum, affine=child.affine,
                device="meta")
            if child.affine:
                bn.weight, bn.bias = child.weight, child.bias
            bn.running_mean = child.running_mean
            bn.running_var = child.running_var
            bn.num_batches_tracked = child.num_batches_tracked
            bn.train(child.training)
            setattr(net, name, bn)
        else:
            convert_global_batch_norm(child, mesh)
    return net
