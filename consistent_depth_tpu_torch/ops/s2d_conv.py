"""Stride-1, same-padding, odd-k 2-D convolution: the port of
``consistent_depth_tpu/ops/s2d_conv.py``.

The JAX package computes this conv on the TPU with a Pallas kernel that
relays the input into space-to-depth form inside VMEM, because the
hourglass's narrow convs (C_out 16/32) would otherwise fill a fraction of
the MXU's 128 lanes (``consistent_depth_tpu/models/layers.py``, the
space-to-depth section). Hopper has no 128-lane constraint, so the port's
CUDA kernels compute the conv directly, with no relayout. Its routes:

- ``"tc"``, ``csrc/same_conv_tc.cu``: bf16 on the tensor cores, an implicit
  GEMM (``mma.sync`` fed by ``ldmatrix`` from a halo tile that
  ``cp.async`` stages in shared memory; the machinery is
  ``csrc/same_conv_tc.cuh``);
- ``"tf32"``, ``csrc/same_conv_tf32.cu``: f32 (the fine-tune's default
  precision) on the tensor cores, the same implicit GEMM with every
  product split into three TF32 products (3xTF32), which keeps f32's
  accuracy;
- ``"fma"``, ``csrc/same_conv.cu``: a direct conv on the FMA pipes, for
  the shapes the tensor-core kernels do not take.

:func:`_plan` picks the route, the tile and the split of the reduction for
one call. Layouts are the JAX package's: x NHWC ``(N, H, W, Ci)``, w HWIO
``(k, k, Ci, Co)``, out NHWC ``(N, H, W, Co)`` in x's dtype. Any strides are
accepted, so channels_last activations and OIHW weights pass in as permuted
views without a copy; the tensor-core routes copy a tensor whose channels
are not contiguous or 16-byte aligned, and count the copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

# kernel sizes the CUDA kernels are instantiated for: those of the hourglass
KERNEL_SIZES = (3, 5, 7, 11)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the tensor-core kernels' tiles: 16 output columns by 4, 8 or 16 rows,
# output-channel blocks of 16, 32 or (bf16) 64; a step of the reduction is
# 32 bytes of each pixel's channels (two 16-byte units), by dtype
TILE_W = 16
TILE_HEIGHTS = (16, 8, 4)
MAX_CO_BLOCK = {torch.bfloat16: 64, torch.float32: 32}
CHUNK = {torch.bfloat16: 16, torch.float32: 8}
# the routes (module docstring), and the tensor-core route of each dtype
ROUTES = ("tc", "tf32", "fma")
_TC_ROUTE = {torch.bfloat16: "tc", torch.float32: "tf32"}
# an H100 SXM's streaming multiprocessors; a grid below two blocks per SM
# leaves the card under-filled
SMS = 132
MIN_BLOCKS = 2 * SMS

# number of CUDA kernel launches made by :func:`same_conv` and by
# :func:`same_conv_grad_input` (one per call, whatever the route)
launches = 0
grad_input_launches = 0
# the same calls by route (ROUTES), the split-K reduction passes, and the
# tensors the tensor-core routes copied to make their channels contiguous
# and aligned
route_counts = dict.fromkeys(
    [f"{d}_{r}" for d in ("forward", "grad_input") for r in ROUTES]
    + ["split_reduce", "layout_copies"], 0)


def reset_counts() -> None:
    """Zero :data:`launches`, :data:`grad_input_launches` and
    :data:`route_counts`."""
    global launches, grad_input_launches
    launches = grad_input_launches = 0
    for key in route_counts:
        route_counts[key] = 0


def co_block(channels: int, dtype: torch.dtype) -> int:
    """The tensor-core kernels' output-channel block for ``channels`` of
    ``dtype``."""
    return 16 if channels <= 16 else min(32 if channels <= 32 else 64,
                                         MAX_CO_BLOCK[dtype])


def _unit(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in one 16-byte unit of the tensor-core
    kernels' copies."""
    return 16 // dtype.itemsize


def _plan(dtype: torch.dtype, N: int, H: int, W: int, Ci: int, Co: int,
          k: int, grad_input: bool = False) -> Tuple[str, int, int]:
    """``(route, tile_h, split)`` for one conv on the card: the forward of
    x (N, H, W, Ci) with w (k, k, Ci, Co), or with ``grad_input`` its
    grad-input, a conv reducing over Co into Ci channels.

    Each dtype takes its tensor-core route (bf16 "tc", f32 "tf32"), except
    a grad-input into a number of channels that is not a whole number of
    16-byte units, 8 bf16 or 4 f32 (the kernels copy its weight in units
    along them): that takes the FMA template ("fma", tile and split
    unused). The tile is the tallest of 16, 8, 4 rows that gives at least
    MIN_BLOCKS blocks (16 only from twice that, so that the taller tile,
    which re-reads less halo and weight per output, still leaves each SM a
    few blocks); where even 4 rows give fewer, the reduction's steps
    (CHUNK[dtype] channels by one tap row) are split over blocks, up to
    MIN_BLOCKS blocks."""
    red, out = (Co, Ci) if grad_input else (Ci, Co)
    if grad_input and out % _unit(dtype):
        return "fma", 0, 1
    route = _TC_ROUTE[dtype]
    per_row = math.ceil(W / TILE_W) * N * math.ceil(
        out / co_block(out, dtype))

    def blocks(th):
        return math.ceil(H / th) * per_row

    if blocks(16) >= 2 * MIN_BLOCKS:
        return route, 16, 1
    for th in TILE_HEIGHTS[1:]:
        if blocks(th) >= MIN_BLOCKS:
            return route, th, 1
    steps = math.ceil(red / CHUNK[dtype]) * k
    return route, 4, min(steps, math.ceil(MIN_BLOCKS / blocks(4)))


def _tc_ready(t: torch.Tensor, contiguous_dim: int, by_element: bool
              ) -> bool:
    """Whether the tensor-core kernels take ``t`` as it is:
    ``contiguous_dim`` of stride 1 and, unless the kernel loads ``t`` by
    element (a narrow reduction), the other strides whole 16-byte units (8
    bf16 or 4 f32 elements) and a 16-byte aligned base for its 16-byte
    copies."""
    unit = _unit(t.dtype)
    return t.stride(contiguous_dim) == 1 and (by_element or (
        t.data_ptr() % 16 == 0 and all(
            s % unit == 0 for d, s in enumerate(t.stride())
            if d != contiguous_dim)))


def _tc_operands(a: torch.Tensor, w: torch.Tensor, grad_input: bool):
    """The activations or cotangent a (N, H, W, C) and w (k, k, Ci, Co) as
    the tensor-core kernels take them: a with contiguous channels, w an
    HWIO view of an OIHW channels_last tensor; each copy made is counted.
    A reduction over a number of channels that is not a whole number of
    16-byte units is loaded by element (a, and the forward's w)."""
    narrow = a.shape[3] % _unit(a.dtype) != 0
    if not _tc_ready(a, 3, narrow):
        a = a.contiguous()
        route_counts["layout_copies"] += 1
    if not _tc_ready(w, 2, narrow and not grad_input):
        w = w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
        route_counts["layout_copies"] += 1
    return a, w


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
    """The conv with no autograd record: on CUDA the kernel of
    :func:`_plan`'s route, on the CPU the plain version."""
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
    route, tile_h, split = _plan(x.dtype, N, H, W, Ci, Co, k)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if route != "fma":
            x, w = _tc_operands(x, w, grad_input=False)
            ws = (torch.empty((split, N, H, W, Co), dtype=torch.float32,
                              device=x.device) if split > 1 else None)
            err = getattr(lib, f"same_conv_{route}_forward")(
                x.data_ptr(), w.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), _DTYPE_CODES[x.dtype], N, H, W, Ci, Co, k,
                *x.stride(), *w.stride(), tile_h, split,
                ws.data_ptr() if ws is not None else None, stream)
        else:
            err = lib.same_conv_forward(
                x.data_ptr(), w.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), _DTYPE_CODES[x.dtype], N, H, W, Ci, Co, k,
                *x.stride(), *w.stride(), stream)
    _cuda.check(lib, err, "same_conv")
    global launches
    launches += 1
    route_counts["forward_" + route] += 1
    route_counts["split_reduce"] += split > 1
    return out


def same_conv_grad_input(ct: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grad-input of :func:`same_conv` for the cotangent ct (N, H, W, Co)
    and the forward's weight w (k, k, Ci, Co): (N, H, W, Ci). A CPU tensor
    takes :func:`same_conv_grad_input_reference`; a CUDA tensor launches
    the kernel of :func:`_plan`'s route on the flipped, channel-swapped
    weight (a strided view, no copy), or raises if the kernel does not
    take the arguments."""
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
    route, tile_h, split = _plan(ct.dtype, N, H, W, Ci, Co, k,
                                 grad_input=True)
    lib = _cuda.library()
    with torch.cuda.device(ct.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if route != "fma":
            ct, w = _tc_operands(ct, w, grad_input=True)
            ws = (torch.empty((split, N, H, W, Ci), dtype=torch.float32,
                              device=ct.device) if split > 1 else None)
            err = getattr(lib, f"same_conv_{route}_grad_input")(
                ct.data_ptr(), w.data_ptr(), dx.data_ptr(),
                _DTYPE_CODES[ct.dtype], N, H, W, Ci, Co, k, *ct.stride(),
                *w.stride(), tile_h, split,
                ws.data_ptr() if ws is not None else None, stream)
        else:
            err = lib.same_conv_grad_input(
                ct.data_ptr(), w.data_ptr(), dx.data_ptr(),
                _DTYPE_CODES[ct.dtype], N, H, W, Ci, Co, k, *ct.stride(),
                *w.stride(), stream)
    _cuda.check(lib, err, "same_conv_grad_input")
    global grad_input_launches
    grad_input_launches += 1
    route_counts["grad_input_" + route] += 1
    route_counts["split_reduce"] += split > 1
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
