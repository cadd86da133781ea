"""Camera geometry: the port of ``consistent_depth_tpu/ops/geometry.py``
(the pixel grid only in this slice; the projections come with the loss
chain)."""

from __future__ import annotations

import torch


def pixel_grid(shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """(H, W, 2) grid of (x, y) pixel positions."""
    H, W = shape
    y, x = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack((x, y), dim=-1)
