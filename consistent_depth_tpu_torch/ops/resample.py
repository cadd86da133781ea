"""Border-clamped bilinear resampling: the port of
``consistent_depth_tpu/ops/resample.py``.

Semantics are torch ``grid_sample``'s with ``align_corners=False`` and
``padding_mode='border'``, which the JAX package reproduces: source
coordinates are clipped to ``[0, size - 1]`` and the four corners blended
in f32; NaN coordinates give NaN. The arithmetic is that of
``bilinear_sample_pixels_reference`` (equal in value to the JAX package's
fast path with its splat backward off), so the two packages agree to the
last bits.

The backward is PyTorch's autograd of that arithmetic: a scatter-add of
the cotangent into the four corners for the data, and the corner
differences for the positions, which are zero outside ``[0, size - 1]``
and at exactly ``size - 1`` (where both corners are the last pixel), as in
the JAX package's custom VJP. Its packed gather and matmul-splat backward
are TPU gather/scatter strategies and have no counterpart here.

Layout is the JAX package's NHWC, with the batch dimension written out in
place of ``jax.vmap``: data ``(B, H, W, C)``, coordinates ``(B, ...)``.
"""

from __future__ import annotations

import torch


def bilinear_sample_pixels(data: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """Sample ``data`` (B, H, W, C) at continuous source-pixel coordinates
    ``x``/``y`` (B, ...), border padding. Returns (B, ..., C)."""
    B, H, W, C = data.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f).unsqueeze(-1)
    wy = (y - y0f).unsqueeze(-1)
    # indices must be finite for the gather; NaN weights still poison the
    # result, as in torch's grid_sample
    x0 = torch.nan_to_num(x0f).clamp(0, W - 1).long()
    y0 = torch.nan_to_num(y0f).clamp(0, H - 1).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)

    flat = data.reshape(B, H * W, C)
    batch = torch.arange(B, device=data.device).view(
        (B,) + (1,) * (x.dim() - 1))

    def gather(ix, iy):
        return flat[batch, iy * W + ix]

    top = gather(x0, y0) * (1.0 - wx) + gather(x1, y0) * wx
    bot = gather(x0, y1) * (1.0 - wx) + gather(x1, y1) * wx
    return top * (1.0 - wy) + bot * wy


def _normalise(uv: torch.Tensor, size_x: float, size_y: float
               ) -> torch.Tensor:
    """``2 uv / (size_x, size_y) - 1``. The size tensor is filled on uv's
    device: one made from a list would be a blocking copy from the host on
    every call."""
    size = torch.stack((uv.new_full((), size_x), uv.new_full((), size_y)))
    return 2.0 * uv / size - 1.0


def grid_sample(data: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(data, grid, padding_mode='border',
    align_corners=False)`` in NHWC: data (B, H, W, C), grid (B, Ho, Wo, 2)
    normalised (x, y) in [-1, 1] -> (B, Ho, Wo, C)."""
    H, W = data.shape[1:3]
    x = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    return bilinear_sample_pixels(data, x, y)


def sample_uv(data: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The reference's ``geometry.sample``: uv (B, Ho, Wo, 2) in pixels,
    normalised by (W - 1, H - 1) before :func:`grid_sample`."""
    H, W = data.shape[1:3]
    return grid_sample(data, _normalise(uv, W - 1.0, H - 1.0))


def sample_uv_wh(data: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The reference's ``consistency.sample``: uv (B, Ho, Wo, 2) in
    pixels, normalised by (W, H). Net effect: x_src = u - 0.5."""
    H, W = data.shape[1:3]
    return grid_sample(data, _normalise(uv, float(W), float(H)))
