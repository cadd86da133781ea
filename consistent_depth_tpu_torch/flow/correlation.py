"""FlowNetC cost volume: the port of
``consistent_depth_tpu/flow/correlation.py``.

The JAX package computes it on the TPU with a Pallas kernel that stages a
row band of a zero-padded f2 with its displacement halo in VMEM
(``correlation_pallas``). On a CUDA tensor, :func:`correlation` launches
the hand-written banded kernel of ``csrc/correlation.cu`` instead: a block
of BANDED_GROUP warps, one per vertical displacement, shares each staged
f1 chunk; each lane keeps a 4-column x D-displacement tile of sums in
registers; chunks of 16 channels are staged by ``cp.async`` in a
two-stage ring. Out-of-image reads are masked, so it needs no padded copy
of f2 and no divisibility rule. It takes stride 2, r in BANDED_RADII and C
a multiple of 4 (:func:`_plan`; FlowNetC's only call), and reads inputs
with a unit channel stride, pixel strides of whole 16-byte units and
16-byte aligned bases (FlowNetC's NHWC views of channels_last
activations); an input laid out otherwise is copied first and the copy
counted. Other arguments raise on the card.

Layout is the JAX package's: f1 and f2 NHWC ``(B, H, W, C)``, output
``(B, H, W, D*D)`` with ``D = 2 * (max_displacement // stride) + 1``,
displacement planes dy-major, values averaged over channels. Any strides
are accepted for f1 and f2; channels_last activations pass in as permuted
views without a copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import _cuda

# the banded kernel: its displacement step, the radii it is instantiated
# for, its dy values per block (G, fixed in the .cu: the fastest of 1, 3 and
# 7 at FlowNet2's (1, 56, 128, 256), r = 10, on an H100, PERF.md section
# 6), its tile of output columns and channels per stage
BANDED_STRIDE = 2
BANDED_RADII = (2, 10)
BANDED_GROUP = 7
BANDED_TILE_W = 128
BANDED_CHUNK = 16

# the banded kernel's launches, one per call of :func:`correlation` on a
# CUDA tensor, and the inputs it copied first because their layout was not
# one the kernel reads (:func:`_aligned`)
route_counts = {"banded": 0, "layout_copies": 0}


def launch_count() -> int:
    """The banded kernel's launches."""
    return route_counts["banded"]


def reset_counts() -> None:
    """Zero :data:`route_counts`."""
    for key in route_counts:
        route_counts[key] = 0


class Plan(NamedTuple):
    """The banded kernel's grid for one call (x-tiles, H, B * dy-groups)
    and its dynamic shared bytes."""
    grid: Tuple[int, int, int]
    smem: int


def banded_smem(r: int) -> int:
    """The banded kernel's shared bytes per block: two stages of 16
    channels of the 128-column f1 tile and, per warp, of its f2 row's two
    column parities of 4 * ceil((64 + 2r) / 4) columns each."""
    qq = (64 + 2 * r + 3) // 4
    return 2 * BANDED_CHUNK * 4 * (BANDED_TILE_W
                                   + BANDED_GROUP * 2 * 4 * qq)


def _plan(shape: Sequence[int], r: int, stride: int) -> Plan:
    """The banded kernel's launch for f1, f2 of ``shape`` (B, H, W, C),
    radius r and step ``stride``; it takes stride 2, r in BANDED_RADII and
    C a multiple of 4, and anything else raises."""
    B, H, W, C = shape
    if stride != BANDED_STRIDE or r not in BANDED_RADII or C % 4:
        raise ValueError(
            f"correlation: the kernel takes stride {BANDED_STRIDE}, a "
            f"radius in {BANDED_RADII} and C a multiple of 4, not stride "
            f"{stride}, radius {r}, C {C}")
    D = 2 * r + 1
    grid = (math.ceil(W / BANDED_TILE_W), H,
            B * math.ceil(D / BANDED_GROUP))
    return Plan(grid, banded_smem(r))


def _aligned(t: torch.Tensor) -> bool:
    """Whether the banded kernel reads the NHWC ``t`` as it lies: a unit
    channel stride, pixel strides of whole 16-byte units, a 16-byte aligned
    base."""
    s = t.stride()
    return (s[3] == 1 and all(v % 4 == 0 for v in s[:3])
            and t.data_ptr() % 16 == 0)


def correlation_reference(f1: torch.Tensor, f2: torch.Tensor,
                          max_displacement: int = 20,
                          stride: int = 2) -> torch.Tensor:
    """Plain PyTorch version: pad f2 and, for each of the D*D
    displacements (dy-major), take the channel mean of f1 times the
    shifted f2."""
    B, H, W, C = f1.shape
    r = max_displacement // stride
    d = max_displacement
    f2p = F.pad(f2, (0, 0, d, d, d, d))
    planes = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = d + dy * stride, d + dx * stride
            shifted = f2p[:, oy:oy + H, ox:ox + W, :]
            planes.append(torch.mean(f1 * shifted, dim=-1))
    return torch.stack(planes, dim=-1)


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 20, stride: int = 2) -> torch.Tensor:
    """Cost volume of f1 and f2 (B, H, W, C) -> (B, H, W, D*D). A CPU
    tensor takes :func:`correlation_reference`; a CUDA float32 tensor
    launches the banded kernel on arguments :func:`_plan` takes, copying
    first an input that is not :func:`_aligned`; anything else raises."""
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"correlation: f1 {tuple(f1.shape)} and f2 "
                         f"{tuple(f2.shape)} must be one (B, H, W, C) shape")
    if stride < 1 or max_displacement < 0:
        raise ValueError(f"correlation: max_displacement {max_displacement} "
                         f"and stride {stride}")
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_reference(f1, f2, max_displacement, stride)
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"correlation: unsupported devices {f1.device}, "
                         f"{f2.device}")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise TypeError(f"correlation: the kernel takes float32, not "
                        f"{f1.dtype}/{f2.dtype}")
    B, H, W, C = f1.shape
    r = max_displacement // stride
    _plan(f1.shape, r, stride)
    D = 2 * r + 1
    out = torch.empty((B, H, W, D * D), dtype=torch.float32,
                      device=f1.device)
    if out.numel() == 0:
        return out
    if not _aligned(f1):
        f1 = f1.clone(memory_format=torch.contiguous_format)
        route_counts["layout_copies"] += 1
    if not _aligned(f2):
        f2 = f2.clone(memory_format=torch.contiguous_format)
        route_counts["layout_copies"] += 1
    lib = _cuda.library()
    with torch.cuda.device(f1.device):
        err = lib.correlation_banded_forward(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C, r,
            *f1.stride()[:3], *f2.stride()[:3],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _cuda.check(lib, err, "correlation")
    route_counts["banded"] += 1
    return out
