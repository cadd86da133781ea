"""The card's peaks and the work of a configuration, counted from the
benchmark's own reference network, so that the count does not change when
the program does.

``conv_bound`` is ``chip_smoke.py::conv_bound`` with one peak per
precision in place of one per kernel route: the same conv has the same
bound whichever kernel runs it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# NVIDIA H100 SXM data sheet, dense rates. f32 is the TF32 tensor-core
# rate at three products per f32-accurate product: the fastest f32-accurate
# rate a route of the port reaches (the FMA pipes' 67 TFLOP/s would read
# over 100% on its 3xTF32 kernels).
PEAK_TFLOPS = {"bf16": 989.0, "f32": 495.0 / 3}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bf16": 2, "f32": 4}


def conv_bound(direction: str, N: int, H: int, W: int, k: int, Ci: int,
               Co: int, precision: str) -> Tuple[float, float, str]:
    """(FLOP, least seconds, "operations" or "bytes") of one same-padding
    stride-1 conv call: the larger of its operations over the precision's
    peak and its bytes (each input read once, each output written once)
    over the memory rate. ``direction`` is "forward" (x, w, bias in, out)
    or "grad_input" (ct, w in, dx out)."""
    flop = 2 * N * H * W * k * k * Ci * Co
    elems = N * H * W * (Ci + Co) + k * k * Ci * Co + (
        Co if direction == "forward" else 0)
    t_ops = flop / (PEAK_TFLOPS[precision] * 1e12)
    t_bytes = elems * ELEM_BYTES[precision] / HBM_BYTES_PER_S
    return flop, max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


@dataclass(frozen=True)
class Conv:
    """One conv call of a forward: input (N, Ci, H, W), Co outputs of
    (Ho, Wo), a k x k kernel; whether its input needs a gradient."""

    N: int
    Ci: int
    H: int
    W: int
    Co: int
    Ho: int
    Wo: int
    k: int
    stride: int
    groups: int
    needs_grad_input: bool

    @property
    def flop(self) -> int:
        return 2 * self.N * self.Ho * self.Wo * self.Co * (
            self.Ci // self.groups) * self.k * self.k

    @property
    def kxk(self) -> bool:
        """The class the k x k kernels take: groups 1, stride 1, k > 1."""
        return self.groups == 1 and self.stride == 1 and self.k > 1


class _ConvLog(TorchFunctionMode):
    """Records every ``F.conv2d`` call made inside it."""

    def __init__(self):
        super().__init__()
        self.convs: List[Conv] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (F.conv2d, torch.conv2d):
            x, w = args[0], args[1]
            stride = kwargs.get("stride", args[3] if len(args) > 3 else 1)
            groups = kwargs.get("groups", args[6] if len(args) > 6 else 1)
            stride = stride[0] if isinstance(stride, (tuple, list)) else stride
            N, Ci, H, W = x.shape
            self.convs.append(Conv(
                N, Ci, H, W, w.shape[0], out.shape[2], out.shape[3],
                w.shape[2], int(stride), int(groups), bool(x.requires_grad)))
        return out


@functools.lru_cache(maxsize=None)
def convs_of(reference, N: int, H: int, W: int) -> Tuple[Conv, ...]:
    """The conv calls of one training forward of ``reference``'s network
    on N frames of H x W, traced on the meta device."""
    with torch.device("meta"):
        net = reference.build()
    net.train()
    images = torch.empty((N, 1, H, W, 3), device="meta")
    with _ConvLog() as log:
        reference.depth(net, images)
    return tuple(log.convs)


def forward_flop(reference, H: int, W: int) -> int:
    """FLOP of the network's convs (and linears: none here) in one frame's
    forward at H x W."""
    return sum(c.flop for c in convs_of(reference, 1, H, W))


def kxk_bound_s(reference, N: int, H: int, W: int, precision: str,
                grad_input: bool) -> float:
    """Least seconds of the k x k kernels' work in one forward of N frames
    (and, with ``grad_input``, in its backward's grad-inputs, for the
    convs whose input needs one)."""
    total = 0.0
    for c in convs_of(reference, N, H, W):
        if not c.kxk:
            continue
        total += conv_bound("forward", c.N, c.H, c.W, c.k, c.Ci, c.Co,
                            precision)[1]
        if grad_input and c.needs_grad_input:
            total += conv_bound("grad_input", c.N, c.H, c.W, c.k, c.Ci,
                                c.Co, precision)[1]
    return total
