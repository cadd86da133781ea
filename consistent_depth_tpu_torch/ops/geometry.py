"""Differentiable camera geometry: the port of
``consistent_depth_tpu/ops/geometry.py``.

Conventions (the reference's, utils/geometry.py):

- pixels (x, y) in [0, W-1] x [0, H-1], top-left origin
- intrinsics rows are (fx, fy, cx, cy)
- camera looks along -z, y up: ray = ((u-cx)/fx, -(v-cy)/fy, -1)
- extrinsics (3, 4) = [R | t] is world-from-camera: x_world = R p + t

Layout is channels-last, as in the JAX package: points (..., H, W, 3).
The JAX package runs the pose products at ``precision="highest"``; here they
are broadcast multiplies and sums, which never take the TF32 path that a
matmul on the card may take.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from .resample import sample_uv


def pixel_grid(shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """(H, W, 2) grid of (x, y) pixel positions."""
    H, W = shape
    y, x = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack((x, y), dim=-1)


def focal_length(intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 2) = (fx, fy)."""
    return intrinsics[..., :2]


def principal_point(intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 2) = (cx, cy)."""
    return intrinsics[..., 2:]


def _flip_v(uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (u, -v). Built from the tensor itself: a ``(1, -1)``
    literal would be a blocking copy from the host on every call."""
    return torch.cat((uv[..., :1], -uv[..., 1:]), dim=-1)


def pixels_to_rays(pixels: torch.Tensor,
                   intrinsics: torch.Tensor) -> torch.Tensor:
    """Pixels (..., H, W, 2) + intrinsics (..., 4) -> rays (..., H, W, 3)
    with z = -1."""
    cs = principal_point(intrinsics)[..., None, None, :]
    fs = focal_length(intrinsics)[..., None, None, :]
    uv = _flip_v(pixels - cs) / fs
    ones = -torch.ones(uv.shape[:-1] + (1,), dtype=uv.dtype, device=uv.device)
    return torch.cat((uv, ones), dim=-1)


def project(points: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Camera-space points (..., H, W, 3) -> pixel coords (..., H, W, 2)."""
    rays = points / -points[..., -1:]
    fs = focal_length(intrinsics)[..., None, None, :]
    cs = principal_point(intrinsics)[..., None, None, :]
    uv = _flip_v(rays[..., :2] * fs)
    return uv + cs


def pixels_to_points(intrinsics: torch.Tensor, depths: torch.Tensor,
                     pixels: torch.Tensor) -> torch.Tensor:
    """Back-project: depths (..., H, W), pixels (..., H, W, 2) ->
    camera-space points (..., H, W, 3)."""
    return pixels_to_rays(pixels, intrinsics) * depths[..., None]


def _rotate(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) applied to points p (..., H, W, 3), in full f32."""
    return (R[..., None, None, :, :] * p[..., None, :]).sum(-1)


def reproject_points(points_cam_ref: torch.Tensor,
                     extrinsics_ref: torch.Tensor,
                     extrinsics_tgt: torch.Tensor) -> torch.Tensor:
    """Map points (..., H, W, 3) from the reference camera frame to the
    target camera frame via world space; extrinsics (..., 3, 4)
    world-from-camera [R | t]."""
    R_ref, t_ref = extrinsics_ref[..., :, :3], extrinsics_ref[..., :, 3]
    R_tgt, t_tgt = extrinsics_tgt[..., :, :3], extrinsics_tgt[..., :, 3]
    points_world = _rotate(R_ref, points_cam_ref) + t_ref[..., None, None, :]
    # p_tgt = R_tgt^T (x_world - t_tgt)
    return _rotate(R_tgt.transpose(-1, -2),
                   points_world - t_tgt[..., None, None, :])


def depth_to_points(depths: torch.Tensor,
                    intrinsics: torch.Tensor) -> torch.Tensor:
    """depths (..., H, W), intrinsics (..., 4) -> points (..., H, W, 3)."""
    H, W = depths.shape[-2:]
    pixels = pixel_grid((H, W), dtype=depths.dtype, device=depths.device)
    return pixels_to_points(intrinsics, depths, pixels)


def calibrate_scale(extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                    depths: torch.Tensor) -> torch.Tensor:
    """Scene-centre based global scale between a depth pair and its camera
    translation (reference: utils/geometry.py:143-174; auxiliary, not on
    the main pipeline path), on the inputs' device.

    Args:
        extrinsics (2, 3, 4), intrinsics (2, 4), depths (2, H, W)
    Returns:
        () scale
    """
    points_cam = depth_to_points(depths, intrinsics)
    Rs, ts = extrinsics[..., :, :3], extrinsics[..., :, 3]
    points_rot = _rotate(Rs, points_cam)
    mus = points_rot.reshape(points_rot.shape[0], -1, 3).mean(1)
    dmu, dt = mus[0] - mus[1], ts[0] - ts[1]
    return -(dt * dmu).sum() / (dt * dt).sum()


def _index_on(tgt_ids, device: torch.device) -> torch.Tensor:
    """``tgt_ids`` as one index tensor on ``device``: a Python list indexes
    a card tensor through a host-to-card copy of its own at every use."""
    return torch.as_tensor(tgt_ids, dtype=torch.long, device=device)


def warping_field(extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                  depths: torch.Tensor,
                  tgt_ids: Union[Sequence[int], torch.Tensor]
                  ) -> torch.Tensor:
    """Sampling field: uv[i] samples frame tgt_ids[i] to produce frame i
    (reference: utils/geometry.py:177-198).

    Args:
        extrinsics (N, 3, 4), intrinsics (N, 4), depths (N, H, W)
    """
    idx = _index_on(tgt_ids, depths.device)
    points_cam = depth_to_points(depths, intrinsics)
    points_tgt = reproject_points(points_cam, extrinsics, extrinsics[idx])
    return project(points_tgt, intrinsics[idx])


def warp_image(images: torch.Tensor, depths: torch.Tensor,
               extrinsics: torch.Tensor, intrinsics: torch.Tensor,
               tgt_ids: Union[Sequence[int], torch.Tensor]) -> torch.Tensor:
    """Warp images[tgt_ids[i]] into frame i's view using depths[i]
    (reference: utils/geometry.py:211-227).

    Args:
        images (N, H, W, C), depths (N, H, W)
    """
    idx = _index_on(tgt_ids, depths.device)
    uv_tgt = warping_field(extrinsics, intrinsics, depths, idx)
    return sample_uv(images[idx], uv_tgt)
