"""FlowNetC cost volume: the port of
``consistent_depth_tpu/flow/correlation.py``.

The JAX package computes it on the TPU with a Pallas kernel that stages a
row band of a zero-padded f2 with its displacement halo in VMEM
(``correlation_pallas``). On a CUDA tensor, :func:`correlation` launches
the hand-written kernel ``csrc/correlation.cu`` instead: one block per
(batch, row, 32-column tile, vertical displacement) stages the f1 tile and
the one f2 row it needs in shared memory and masks out-of-image reads, so
it needs no padded copy of f2 and no divisibility rule.

Layout is the JAX package's: f1 and f2 NHWC ``(B, H, W, C)``, output
``(B, H, W, D*D)`` with ``D = 2 * (max_displacement // stride) + 1``,
displacement planes dy-major, values averaged over channels. Any strides
are accepted for f1 and f2, so channels_last activations pass in as
permuted views without a copy.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..ops import _cuda

# the kernel stages a row of 32 + 2 * reach columns in shared memory
MAX_REACH = 148

# number of CUDA kernel launches made by :func:`correlation`
launches = 0


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
    launches the kernel; anything else raises."""
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

    B, H, W, C = f1.shape
    D = 2 * r + 1
    out = torch.empty((B, H, W, D * D), dtype=torch.float32,
                      device=f1.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.correlation_forward(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C, r,
            stride, *f1.stride(), *f2.stride(), ctypes.c_void_p(stream))
    _cuda.check(lib, err, "correlation")
    global launches
    launches += 1
    return out
