"""Sparse-point scale calibration: the port's copy of
``consistent_depth_tpu/utils/calibration.py`` (reference:
utils/calibration.py), the alternative to dense COLMAP calibration:
per-frame scales from the *sparse* 3D points each image observes, instead
of patch-match depth. Host numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..io import colmap_io
from ..ops import geometry_np


def project_sparse_points(
    image: colmap_io.Image,
    points3D: Dict[int, colmap_io.Point3D],
    camera_extrinsics: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Observed 3D points of one image -> (pixel xy (N, 2), camera-space
    depth (N,)). Extrinsics are world-from-camera [R|t] in the framework
    basis."""
    ids = [pid for pid in image.point3D_ids if pid != -1 and pid in points3D]
    if not ids:
        return np.zeros((0, 2)), np.zeros((0,))
    xyz_world = np.stack([
        colmap_io.ROT_COLMAP_TO_NORMAL @ points3D[pid].xyz for pid in ids])
    R, t = camera_extrinsics[:, :3], camera_extrinsics[:, 3]
    xyz_cam = (xyz_world - t) @ R  # R^T (x - t)
    depth = -xyz_cam[:, 2]
    mask = np.array([pid != -1 and pid in points3D
                     for pid in image.point3D_ids])
    xy = image.xys[mask]
    return xy, depth


def calibrate_frame_w_sparse_colmap(
    xy: np.ndarray, sparse_depth: np.ndarray, dense_inv_depth: np.ndarray,
    size_old: Optional[Tuple[int, int]] = None,
) -> Optional[float]:
    """Median ratio between a frame's monocular inverse depth (sampled
    at sparse track locations) and the COLMAP sparse depths
    (reference: utils/calibration.py:73-118 semantics)."""
    valid = sparse_depth > 0
    xy, sparse_depth = xy[valid], sparse_depth[valid]
    if len(xy) == 0:
        return None
    H, W = dense_inv_depth.shape[:2]
    if size_old is not None:
        xy = xy * np.array([W / size_old[0], H / size_old[1]])
    inv_mono = geometry_np.sample_nearest(dense_inv_depth[..., None], xy)[..., 0]
    valid = np.isfinite(inv_mono) & (inv_mono > 0)
    if valid.sum() == 0:
        return None
    # mono_depth * scale == colmap_depth
    ratios = 1.0 / (inv_mono[valid] * sparse_depth[valid])
    return float(np.median(ratios))


def calibrate_w_sparse_colmap(
    sparse_dir: str,
    inv_depth_fmt: str,
    size_new: Tuple[int, int],
) -> Dict[int, float]:
    """Per-frame scales from a COLMAP sparse model + monocular inverse
    depth maps. Returns {frame_index: scale}."""
    from ..io import image_io

    cameras, images, points3D = colmap_io.read_model(sparse_dir, ext=".bin")
    extr = colmap_io.images_to_extrinsics(
        images, colmap_io.ordered_image_ids(images))
    scales: Dict[int, float] = {}
    for row, iid in enumerate(colmap_io.ordered_image_ids(images)):
        im = images[iid]
        frame = int(im.name.split("_")[-1].split(".")[0])
        cam = cameras[im.camera_id]
        xy, depth = project_sparse_points(im, points3D, extr[row])
        try:
            inv = image_io.load_raw_float32_image(inv_depth_fmt.format(frame))
        except FileNotFoundError:
            continue
        scale = calibrate_frame_w_sparse_colmap(
            xy, depth, inv, size_old=(cam.width, cam.height))
        if scale is not None:
            scales[frame] = scale
    return scales
