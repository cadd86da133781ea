"""Stride-1, same-padding, odd-k 2-D convolution: the port of
``consistent_depth_tpu/ops/s2d_conv.py``.

The JAX package computes this conv on the TPU with a Pallas kernel that
relays the input into space-to-depth form inside VMEM, because the
hourglass's narrow convs (C_out 16/32) would otherwise fill a fraction of
the MXU's 128 lanes (``consistent_depth_tpu/models/layers.py``, the
space-to-depth section). Hopper has no 128-lane constraint, so the CUDA
kernel here (``csrc/same_conv.cu``) is a direct convolution with no
space-to-depth relayout: it stages the input tile and its halo in shared
memory and accumulates in f32 registers.

Layouts are the JAX package's: x NHWC ``(N, H, W, Ci)``, w HWIO
``(k, k, Ci, Co)``, out NHWC ``(N, H, W, Co)`` in x's dtype. Any strides are
accepted for x and w, so channels_last activations and OIHW weights pass in
as permuted views without a copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

# kernel sizes the CUDA kernel is instantiated for: those of the hourglass
KERNEL_SIZES = (3, 5, 7, 11)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# number of CUDA kernel launches made by :func:`same_conv` and by
# :func:`same_conv_grad_input`
launches = 0
grad_input_launches = 0


def same_conv_reference(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` on permuted views."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias,
                 padding=(k - 1) // 2)
    return y.permute(0, 2, 3, 1)


def same_conv_grad_input_reference(ct: torch.Tensor,
                                   w: torch.Tensor) -> torch.Tensor:
    """Plain version of the conv's grad-input, the JAX package's formula
    (``layers.py::_conv_pallas_bwd``): the same-padding conv of the
    cotangent ct (N, H, W, Co) with the flipped, channel-swapped weight
    ``w[::-1, ::-1].transpose(0, 1, 3, 2)``. Returns (N, H, W, Ci)."""
    return same_conv_reference(ct, w.flip(0, 1).permute(0, 1, 3, 2))


def _check(name: str, x: torch.Tensor, w: torch.Tensor, x_ch: int,
           others=()) -> None:
    """Raise unless x (N, H, W, x_ch) and w (k, k, ., .) can go to the
    kernel: a square k in KERNEL_SIZES, a supported dtype shared with w
    and ``others``, all on x's CUDA device."""
    k, k2 = w.shape[:2]
    if k != k2 or k not in KERNEL_SIZES:
        raise ValueError(f"{name}: kernel {tuple(w.shape[:2])} not in "
                         f"{KERNEL_SIZES} (square)")
    if x.dim() != 4 or x.shape[3] != x_ch:
        raise ValueError(f"{name}: input {tuple(x.shape)} does not match "
                         f"weight {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    for t in (w, *others):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: tensors must share device and dtype "
                             f"(got {t.device}/{t.dtype}, input "
                             f"{x.device}/{x.dtype})")


def _forward(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The conv with no autograd record: the kernel on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return same_conv_reference(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"same_conv: unsupported device {x.device}")
    N, H, W, Ci = x.shape
    k, Co = w.shape[0], w.shape[3]
    _check("same_conv", x, w, w.shape[2],
           [bias] if bias is not None else [])
    if bias is not None:
        if bias.shape != (Co,):
            raise ValueError(f"same_conv: bias shape {tuple(bias.shape)}")
        bias = bias.contiguous()

    out = torch.empty((N, H, W, Co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.same_conv_forward(
            x.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), _DTYPE_CODES[x.dtype], N, H, W, Ci, Co, k,
            *x.stride(), *w.stride(), ctypes.c_void_p(stream))
    _cuda.check(lib, err, "same_conv")
    global launches
    launches += 1
    return out


def same_conv_grad_input(ct: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grad-input of :func:`same_conv` for the cotangent ct (N, H, W, Co)
    and the forward's weight w (k, k, Ci, Co): (N, H, W, Ci). A CPU tensor
    takes :func:`same_conv_grad_input_reference`; a CUDA tensor launches
    the kernel on the flipped, channel-swapped weight (a strided view, no
    copy), or raises if the kernel does not take the arguments."""
    if ct.device.type == "cpu":
        return same_conv_grad_input_reference(ct, w)
    if ct.device.type != "cuda":
        raise ValueError(f"same_conv_grad_input: unsupported device "
                         f"{ct.device}")
    N, H, W, Co = ct.shape
    k, Ci = w.shape[0], w.shape[2]
    _check("same_conv_grad_input", ct, w, w.shape[3])

    dx = torch.empty((N, H, W, Ci), dtype=ct.dtype, device=ct.device)
    if dx.numel() == 0:
        return dx
    lib = _cuda.library()
    with torch.cuda.device(ct.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.same_conv_grad_input(
            ct.data_ptr(), w.data_ptr(), dx.data_ptr(),
            _DTYPE_CODES[ct.dtype], N, H, W, Ci, Co, k, *ct.stride(),
            *w.stride(), ctypes.c_void_p(stream))
    _cuda.check(lib, err, "same_conv_grad_input")
    global grad_input_launches
    grad_input_launches += 1
    return dx


class _SameConv(torch.autograd.Function):
    """The conv with its gradients: forward and grad-input through the
    kernels (:func:`_forward`, :func:`same_conv_grad_input`), grad-weight
    through the library's wgrad (``aten.convolution_backward``; the JAX
    package also leaves grad-weight outside its kernel), grad-bias the
    cotangent's sum in f32."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return _forward(x, w, bias)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = same_conv_grad_input(ct, w)
        if ctx.needs_input_grad[1]:
            p = (w.shape[0] - 1) // 2
            _, gw, _ = torch.ops.aten.convolution_backward(
                ct.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                w.permute(3, 2, 0, 1), None, [1, 1], [p, p], [1, 1], False,
                [0, 0], 1, [False, True, False])
            gw = gw.permute(2, 3, 1, 0)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = ct.sum((0, 1, 2), dtype=torch.float32).to(ct.dtype)
        return gx, gw, gb


def same_conv(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same-padding conv of x (N, H, W, Ci) with w (k, k, Ci, Co) plus an
    optional bias (Co,). A CPU tensor takes :func:`same_conv_reference`; a
    CUDA tensor launches the kernel, or raises if the kernel does not take
    the arguments. When an input needs a gradient the call goes through
    one ``torch.autograd.Function`` on every device, whose grad-input is
    :func:`same_conv_grad_input`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _SameConv.apply(x, w, bias)
    return _forward(x, w, bias)
