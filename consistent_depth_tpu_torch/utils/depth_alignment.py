"""Depth-map alignment for evaluation: the port's copy of
``consistent_depth_tpu/utils/depth_alignment.py`` (reference:
utils/calibrate.py): fit scale / scale+shift between a predicted and a
ground-truth depth map, with least-squares or RANSAC estimation. Host
numpy (no sklearn dependency)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fit_scale(pred: np.ndarray, gt: np.ndarray,
              mask: Optional[np.ndarray] = None) -> float:
    """Least-squares s minimizing ||s*pred - gt||^2."""
    pred, gt = _masked(pred, gt, mask)
    denom = float(np.dot(pred, pred))
    return float(np.dot(pred, gt) / denom) if denom > 0 else 1.0


def fit_scale_shift(pred: np.ndarray, gt: np.ndarray,
                    mask: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """Least-squares (s, b) minimizing ||s*pred + b - gt||^2."""
    pred, gt = _masked(pred, gt, mask)
    A = np.stack([pred, np.ones_like(pred)], axis=-1)
    sol, *_ = np.linalg.lstsq(A, gt, rcond=None)
    return float(sol[0]), float(sol[1])


def fit_scale_ransac(
    pred: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray] = None,
    iters: int = 100, inlier_thresh: float = 0.1, seed: int = 0,
) -> float:
    """RANSAC scale: random minimal samples, inliers by relative error."""
    pred, gt = _masked(pred, gt, mask)
    if pred.size == 0:
        return 1.0
    rng = np.random.default_rng(seed)
    best_s, best_inliers = 1.0, -1
    for _ in range(iters):
        i = rng.integers(0, pred.size)
        if pred[i] == 0:
            continue
        s = gt[i] / pred[i]
        rel_err = np.abs(s * pred - gt) / np.maximum(np.abs(gt), 1e-12)
        inliers = int((rel_err < inlier_thresh).sum())
        if inliers > best_inliers:
            best_inliers, best_s = inliers, float(s)
    # refine on inliers
    rel_err = np.abs(best_s * pred - gt) / np.maximum(np.abs(gt), 1e-12)
    keep = rel_err < inlier_thresh
    if keep.sum() > 0:
        best_s = fit_scale(pred[keep], gt[keep])
    return best_s


def align_depths(pred: np.ndarray, gt: np.ndarray, mode: str = "scale",
                 mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Return pred aligned to gt under the given model
    ('scale' | 'scale-shift' | 'ransac')."""
    if mode == "scale":
        return fit_scale(pred, gt, mask) * pred
    if mode == "scale-shift":
        s, b = fit_scale_shift(pred, gt, mask)
        return s * pred + b
    if mode == "ransac":
        return fit_scale_ransac(pred, gt, mask) * pred
    raise ValueError(f"unknown alignment mode '{mode}'")


def _masked(pred, gt, mask):
    pred = np.asarray(pred, np.float64).ravel()
    gt = np.asarray(gt, np.float64).ravel()
    valid = np.isfinite(pred) & np.isfinite(gt)
    if mask is not None:
        valid &= np.asarray(mask).ravel() > 0
    return pred[valid], gt[valid]
