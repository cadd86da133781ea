"""FlowNetC cost volume: the port of
``consistent_depth_tpu/flow/correlation.py``.

The JAX package computes it on the TPU with a Pallas kernel that stages a
row band of a zero-padded f2 with its displacement halo in VMEM
(``correlation_pallas``). On a CUDA tensor, :func:`correlation` launches
one of two hand-written kernels of ``csrc/correlation.cu`` instead, by the
route :func:`_plan` fixes from the arguments before launch:

- ``"banded"`` (stride 2, r in {2, 10}, C a multiple of 4, unit channel
  stride, 16-byte aligned pixels; FlowNetC's NHWC views of channels_last
  activations): a block of G warps, one per vertical displacement, shares
  each staged f1 chunk; each lane keeps a 4-column x D-displacement tile of
  sums in registers; chunks of 16 channels are staged by ``cp.async`` in a
  two-stage ring;
- ``"generic"`` (every other argument): one block per (batch, row,
  32-column tile, vertical displacement) stages the f1 tile and the one f2
  row it needs in shared memory.

Both mask out-of-image reads, so neither needs a padded copy of f2 or a
divisibility rule. Layout is the JAX package's: f1 and f2 NHWC
``(B, H, W, C)``, output ``(B, H, W, D*D)`` with
``D = 2 * (max_displacement // stride) + 1``, displacement planes
dy-major, values averaged over channels. Any strides are accepted for f1
and f2, so channels_last activations pass in as permuted views without a
copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import _cuda

# the generic kernel stages a row of 32 + 2 * reach columns in shared memory
MAX_REACH = 148

# the banded kernel: its displacement step, the radii and dy-group sizes it
# is instantiated for, its tile of output columns and channels per stage
BANDED_STRIDE = 2
BANDED_RADII = (2, 10)
GROUPS = (1, 3, 7)
BANDED_TILE_W = 128
BANDED_CHUNK = 16
# dy values per block unless the caller names G: the fastest of GROUPS at
# FlowNet2's (1, 56, 128, 256), r = 10, on an H100 (PERF.md section 6)
DEFAULT_GROUP = 7

# the CUDA kernel launches of :func:`correlation` by route
route_counts = {"banded": 0, "generic": 0}


def launch_count() -> int:
    """The kernel launches of :func:`correlation`, all routes."""
    return sum(route_counts.values())


def reset_counts() -> None:
    """Zero :data:`route_counts`."""
    for key in route_counts:
        route_counts[key] = 0


class Plan(NamedTuple):
    """How one call runs: the route, and for ``"banded"`` its dy-group
    size G, grid (x-tiles, H, B * dy-groups) and dynamic shared bytes."""
    route: str
    group: int = 0
    grid: Optional[Tuple[int, int, int]] = None
    smem: int = 0


def banded_smem(r: int, group: int) -> int:
    """The banded kernel's shared bytes per block: two stages of 16
    channels of the 128-column f1 tile and, per warp, of its f2 row's two
    column parities of 4 * ceil((64 + 2r) / 4) columns each."""
    qq = (64 + 2 * r + 3) // 4
    return 2 * BANDED_CHUNK * 4 * (BANDED_TILE_W + group * 2 * 4 * qq)


def _plan(shape: Sequence[int], r: int, stride: int,
          f1_strides: Sequence[int], f2_strides: Sequence[int],
          data_ptrs: Sequence[int], group: Optional[int] = None) -> Plan:
    """The route of one call on the card with f1, f2 of ``shape``
    (B, H, W, C), radius r and step ``stride``, the inputs' element
    strides and base addresses. ``"banded"`` needs stride 2, r in
    BANDED_RADII, C a multiple of 4, unit channel strides, pixel strides of
    whole 16-byte units and 16-byte aligned bases; anything else takes
    ``"generic"``. ``group`` picks G from GROUPS (default DEFAULT_GROUP)."""
    B, H, W, C = shape
    G = DEFAULT_GROUP if group is None else group
    if G not in GROUPS:
        raise ValueError(f"correlation: dy group {G} not in {GROUPS}")
    aligned = all(s[3] == 1 and all(v % 4 == 0 for v in s[:3])
                  for s in (f1_strides, f2_strides)) and all(
                      p % 16 == 0 for p in data_ptrs)
    if (stride != BANDED_STRIDE or r not in BANDED_RADII or C % 4
            or not aligned):
        return Plan("generic")
    D = 2 * r + 1
    grid = (math.ceil(W / BANDED_TILE_W), H, B * math.ceil(D / G))
    return Plan("banded", G, grid, banded_smem(r, G))


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
    launches the kernel of the route :func:`_plan` gives; anything else
    raises."""
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
    r = max_displacement // stride
    if r * stride > MAX_REACH:
        raise ValueError(f"correlation: reach {r * stride} px exceeds the "
                         f"kernel's {MAX_REACH}")
    return _launch(f1, f2, r, stride, _plan(
        f1.shape, r, stride, f1.stride(), f2.stride(),
        (f1.data_ptr(), f2.data_ptr())))


def _launch(f1: torch.Tensor, f2: torch.Tensor, r: int, stride: int,
            plan: Plan) -> torch.Tensor:
    """Launch ``plan``'s kernel on checked CUDA float32 inputs; a launch
    error raises."""
    B, H, W, C = f1.shape
    D = 2 * r + 1
    out = torch.empty((B, H, W, D * D), dtype=torch.float32,
                      device=f1.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(f1.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = (f1.data_ptr(), f2.data_ptr(), out.data_ptr())
        if plan.route == "banded":
            err = lib.correlation_banded_forward(
                *ptrs, B, H, W, C, r, plan.group, *f1.stride()[:3],
                *f2.stride()[:3], stream)
        else:
            err = lib.correlation_generic_forward(
                *ptrs, B, H, W, C, r, stride, *f1.stride(), *f2.stride(),
                stream)
    _cuda.check(lib, err, f"correlation ({plan.route})")
    route_counts[plan.route] += 1
    return out
