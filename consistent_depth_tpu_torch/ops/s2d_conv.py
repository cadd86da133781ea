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

# number of CUDA kernel launches made by :func:`same_conv`
launches = 0


def same_conv_reference(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` on permuted views."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias,
                 padding=(k - 1) // 2)
    return y.permute(0, 2, 3, 1)


def same_conv(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same-padding conv of x (N, H, W, Ci) with w (k, k, Ci, Co) plus an
    optional bias (Co,). A CPU tensor takes :func:`same_conv_reference`; a
    CUDA tensor launches the kernel, or raises if the kernel does not take
    the arguments."""
    if x.device.type == "cpu":
        return same_conv_reference(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"same_conv: unsupported device {x.device}")

    N, H, W, Ci = x.shape
    k, k2, wci, Co = w.shape
    if k != k2 or k not in KERNEL_SIZES:
        raise ValueError(f"same_conv: kernel {tuple(w.shape[:2])} not in "
                         f"{KERNEL_SIZES} (square)")
    if wci != Ci:
        raise ValueError(f"same_conv: x has {Ci} channels, w expects {wci}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"same_conv: dtype {x.dtype} not supported")
    tensors = [x, w] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("same_conv: x, w and bias must share device "
                             f"and dtype (got {t.device}/{t.dtype})")
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
