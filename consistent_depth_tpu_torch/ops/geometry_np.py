"""Pure-numpy geometry helpers: the port's copy of
``consistent_depth_tpu/ops/geometry_np.py`` (reference: utils/geometry_np.py),
host twins of :mod:`consistent_depth_tpu_torch.ops.geometry` for tooling
and sparse calibration, which touch no device. Same conventions: pixel
(x, y) grids, rays with y up and the camera looking along -z, world-from-
camera [R|t] extrinsics."""

from __future__ import annotations

import numpy as np


def pixel_grid(shape) -> np.ndarray:
    H, W = shape
    X, Y = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    return np.stack((X, Y), axis=-1)


def pixels_to_rays(pixels: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    fx, fy, cx, cy = intrinsics
    uv = (pixels - np.array([cx, cy], np.float32)) * np.array(
        [1.0, -1.0], np.float32)
    uv = uv / np.array([fx, fy], np.float32)
    ones = -np.ones(uv.shape[:-1] + (1,), np.float32)
    return np.concatenate((uv, ones), axis=-1)


def pixels_to_points(intrinsics, depths, pixels) -> np.ndarray:
    return pixels_to_rays(pixels, intrinsics) * depths[..., None]


def project(points: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    fx, fy, cx, cy = intrinsics
    rays = points / -points[..., -1:]
    uv = rays[..., :2] * np.array([fx, -fy], np.float32)
    return uv + np.array([cx, cy], np.float32)


def reproject_points(points, extrinsics_ref, extrinsics_tgt) -> np.ndarray:
    R_ref, t_ref = extrinsics_ref[:, :3], extrinsics_ref[:, 3]
    R_tgt, t_tgt = extrinsics_tgt[:, :3], extrinsics_tgt[:, 3]
    world = points @ R_ref.T + t_ref
    return (world - t_tgt) @ R_tgt


def sample_nearest(data: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Nearest-neighbor sampling of (H, W, C) at pixel coords
    (..., 2), border clamped."""
    H, W = data.shape[:2]
    x = np.clip(np.round(uv[..., 0]).astype(int), 0, W - 1)
    y = np.clip(np.round(uv[..., 1]).astype(int), 0, H - 1)
    return data[y, x]
