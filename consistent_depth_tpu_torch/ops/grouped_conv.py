"""Grouped 3x3 conv (padding 1, stride 1 or 2) whose grad-weight runs on
a hand-written CUDA kernel: ResNeXt-101 32x8d's ``Bottleneck.conv2``
(``models/resnet.py``), MiDaS v2's encoder.

The JAX package leaves this conv to XLA, so no TPU kernel is ported here.
The forward and the grad-input stay on the library's conv
(``aten.convolution``, ``aten.convolution_backward``), as before; the
f32 grad-weight, where the library's grouped kernel took most of a midas2
train step, is ``csrc/grouped_wgrad.cu``: FMA-pipe f32 sums of 8 x 8
(output, input channel) tiles per tap over a split of the output pixels,
each split's partial into a workspace, then a second pass that adds them
in a fixed order (no atomics: two calls give bitwise the same gradient).
On the card a bf16 grouped conv stays on the library, grad-weight too: its
bf16 kernel ran faster than a bf16 build of this one at every midas2 class
(0.033-0.048 against 0.079-0.163 ms a call, NVIDIA H100 80GB HBM3;
PERF.md section 6).

Layouts are the port's: x, its cotangent and the weight NCHW / OIHW tensors,
channels_last in memory, so the kernel's NHWC views are free; an input
whose channels are not contiguous and 16-byte aligned is copied to
channels_last, and the copy counted. :func:`_plan` fixes the split from
the shapes alone. The grad-weight runs in the span
``tracing.GROUPED_GRAD_WEIGHT`` on every device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _cuda

# channels per group the kernel is instantiated for, and its strides
GROUP_WIDTHS = (8, 16, 32, 64)
STRIDES = (1, 2)
# the kernel's block: 9 warps, one per tap, of 32 lanes, each lane an 8 x 8
# tile of sums; a stage holds TILE_X output pixels of one row
LANES = 32
TAPS = 9
TILE_X = 8
# an H100 SXM's streaming multiprocessors, the shared memory of one (less
# the 1 KB each block reserves) and the blocks its registers hold (the
# kernel's launch bounds); the split fills the SMs WAVES times over. One
# wave ran fastest on the card: midas2's 33 f32 grad-weights a step took
# 2.97 ms at one wave, 3.52 at two, 4.59 at four (chip_smoke.py phase 16,
# device time alone, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6)
SMS = 132
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024
MAX_BLOCKS_PER_SM = 2
WAVES = 1

# the grad-weight's calls through :class:`_GroupedConv`: the kernel's
# launches on a CUDA tensor ("kernel", each with its reduce pass) and the
# plain version's calls that stand in for them on a CPU tensor ("plain");
# and the inputs the kernel's wrapper copied to channels_last
route_counts = {"kernel": 0, "plain": 0, "layout_copies": 0}


def launch_count() -> int:
    """The grad-weight's launches, both routes: one per backward of a
    routed grouped conv."""
    return route_counts["kernel"] + route_counts["plain"]


def reset_counts() -> None:
    """Zero :data:`route_counts`."""
    for key in route_counts:
        route_counts[key] = 0


def slab(cg: int):
    """(groups, i-blocks of 8 channels per group) one kernel block takes
    for ``cg`` channels per group: its 32 lanes are (group, o-block,
    i-block) triples (``csrc/grouped_wgrad.cu``, ``Slab``)."""
    nb = cg // 8
    ibw = min(nb, 4)
    return LANES // (nb * ibw), ibw


def takes(in_channels: int, out_channels: int, kernel_size, stride,
          padding, dilation, groups: int, padding_mode: str) -> bool:
    """Whether an ``nn.Conv2d`` of these arguments is a grouped 3x3 conv
    the kernel takes: groups > 1, as many inputs as outputs, 8, 16, 32 or
    64 channels per group in a whole number of the kernel's blocks, a 3x3
    kernel, stride 1 or 2, padding 1, dilation 1, zero padding."""
    if groups <= 1 or in_channels != out_channels or in_channels % groups:
        return False
    cg = in_channels // groups
    return (cg in GROUP_WIDTHS and groups % slab(cg)[0] == 0
            and tuple(kernel_size) == (3, 3)
            and tuple(stride) in ((s, s) for s in STRIDES)
            and tuple(padding) == (1, 1) and tuple(dilation) == (1, 1)
            and padding_mode == "zeros")


class Plan(NamedTuple):
    """How one grad-weight call runs: the output's rows and columns, the
    segments of TILE_X output pixels of a row, the splits of the segments
    over blocks (grid x), the channel blocks (grid y), the dynamic shared
    bytes per block and the f32 workspace's elements."""
    ho: int
    wo: int
    segments: int
    splits: int
    channel_blocks: int
    smem: int
    workspace: int


@functools.lru_cache(maxsize=1024)
def _plan(N: int, H: int, W: int, C: int, groups: int, stride: int) -> Plan:
    """The split of one grad-weight call for x (N, C, H, W), f32: as many
    splits of the segments as make the grid fill the card's SMs WAVES
    times over at the blocks per SM that its shared memory and registers
    allow, at least one segment each. Block b sums segments
    [segments * b // splits, segments * (b + 1) // splits)."""
    cg = C // groups
    gw, ibw = slab(cg)
    channel_blocks = groups // gw * (cg // 8 // ibw)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    segments = N * ho * math.ceil(wo / TILE_X)
    halo = (TILE_X - 1) * stride + 3
    smem = 2 * 4 * (TILE_X * gw * cg + 3 * halo * gw * ibw * 8)
    per_sm = min(MAX_BLOCKS_PER_SM,
                 SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED))
    splits = max(1, min(segments,
                        round(WAVES * SMS * per_sm / channel_blocks)))
    return Plan(ho, wo, segments, splits, channel_blocks, smem,
                splits * C * cg * TAPS)


def grouped_conv_grad_weight_reference(x: torch.Tensor, dy: torch.Tensor,
                                       stride: int,
                                       groups: int) -> torch.Tensor:
    """Plain version of the grad-weight: per group, the cotangent dy (N, C,
    Ho, Wo) against the unfolded 3x3 patches of x (N, C, H, W) with padding
    1, summed over the batch and the pixels with f32 (or wider) sums.
    Returns (C, C / groups, 3, 3) in x's dtype."""
    N, C = x.shape[:2]
    cg = C // groups
    acc = torch.promote_types(x.dtype, torch.float32)
    cols = F.unfold(x.to(acc), 3, padding=1, stride=stride)
    cols = cols.view(N, groups, cg * TAPS, -1)
    d = dy.to(acc).reshape(N, groups, cg, -1)
    dw = torch.matmul(d, cols.transpose(-1, -2)).sum(0)
    return dw.reshape(C, cg, 3, 3).to(x.dtype)


def _nhwc_ready(t: torch.Tensor) -> bool:
    """Whether the kernel takes the f32 NCHW tensor t as it is: channels
    of stride 1, the other strides whole 16-byte units, a 16-byte aligned
    base."""
    return (t.stride(1) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(d) % 4 == 0 for d in (0, 2, 3)))


def _routed(x: torch.Tensor) -> bool:
    """Whether the grad-weight of a grouped conv of x goes through
    :func:`grouped_conv_grad_weight`: every dtype on the CPU (the plain
    version), f32 alone elsewhere (the kernel)."""
    return x.device.type == "cpu" or x.dtype == torch.float32


def grouped_conv_grad_weight(x: torch.Tensor, dy: torch.Tensor,
                             w: torch.Tensor, stride: int,
                             groups: int) -> torch.Tensor:
    """Grad-weight of the grouped conv of x (N, C, H, W) with w (C, C /
    groups, 3, 3) whose cotangent is dy (N, C, Ho, Wo): in w's shape, dtype
    and memory format. A CPU tensor takes
    :func:`grouped_conv_grad_weight_reference`; an f32 CUDA tensor
    launches the kernel at :func:`_plan`'s split; anything else raises."""
    if x.device.type == "cpu":
        route_counts["plain"] += 1
        return grouped_conv_grad_weight_reference(x, dy, stride, groups)
    N, C, H, W = x.shape
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"grouped_conv_grad_weight: {x.dtype} on "
                         f"{x.device} is not taken by the kernel")
    plan = _plan(N, H, W, C, groups, stride)
    if dy.shape != (N, C, plan.ho, plan.wo) or w.shape != (
            C, C // groups, 3, 3):
        raise ValueError(f"grouped_conv_grad_weight: x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}, w {tuple(w.shape)} at "
                         f"stride {stride}")
    for t in (dy, w):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"grouped_conv_grad_weight: tensors must "
                             f"share device and dtype (got {t.device}/"
                             f"{t.dtype}, x {x.device}/{x.dtype})")
    if not _nhwc_ready(x):
        x = x.contiguous(memory_format=torch.channels_last)
        route_counts["layout_copies"] += 1
    if not _nhwc_ready(dy):
        dy = dy.contiguous(memory_format=torch.channels_last)
        route_counts["layout_copies"] += 1
    dw = torch.empty_like(w)
    if x.numel() == 0:
        return dw.zero_()
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.grouped_wgrad(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), ws.data_ptr(),
            N, H, W, C, groups, stride, plan.splits,
            x.stride(0), x.stride(2), x.stride(3), dy.stride(0),
            dy.stride(2), dy.stride(3), *dw.stride(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _cuda.check(lib, err, "grouped_conv_grad_weight")
    route_counts["kernel"] += 1
    return dw


class _GroupedConv(torch.autograd.Function):
    """The grouped conv with its gradients: forward and grad-input on the
    library's conv, grad-weight through :func:`grouped_conv_grad_weight`,
    grad-bias the cotangent's sum in f32 (f64 for f64)."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, groups):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.groups = stride, groups
        ctx.has_bias = bias is not None
        return torch.ops.aten.convolution(
            x, w, bias, [stride, stride], [1, 1], [1, 1], False, [0, 0],
            groups)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        st, groups = ctx.stride, ctx.groups
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.ops.aten.convolution_backward(
                ct, x, w, None, [st, st], [1, 1], [1, 1], False, [0, 0],
                groups, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            with tracing.span(tracing.GROUPED_GRAD_WEIGHT):
                gw = grouped_conv_grad_weight(x, ct, w, st, groups)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = ct.sum((0, 2, 3), dtype=torch.promote_types(
                ct.dtype, torch.float32)).to(ct.dtype)
        return gx, gw, gb, None, None


def grouped_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor], stride: int,
                 groups: int) -> torch.Tensor:
    """The grouped 3x3 conv of x (N, C, H, W) with w (C, C / groups, 3, 3),
    padding 1, plus an optional bias. When an input needs a gradient and
    :func:`_routed` takes x the call goes through one
    ``torch.autograd.Function``; otherwise it is ``F.conv2d``."""
    if (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in (x, w, bias))
            and _routed(x)):
        return _GroupedConv.apply(x, w, bias, stride, groups)
    return F.conv2d(x, w, bias, stride, 1, 1, groups)
