"""Geometric consistency losses: the port of
``consistent_depth_tpu/ops/losses.py`` (reference: loss/consistency_loss.py,
loss/joint_loss.py, loss/parameter_loss.py).

Per frame pair, in both directions:

- reprojection loss: mask-weighted mean of the screen-space L2 distance
  between the flow-matched pixel and the depth-reprojected pixel;
- disparity loss: mean-focal-scaled mask-weighted mean of the 1/z
  difference between reprojected points and the target frame's own
  points sampled at the matched pixel.

As in the JAX package, a padded fixed-size batch carries a ``valid`` mask,
and the scalar divides by the valid count.

With a data ``mesh`` (``..parallel.mesh``) each rank holds a block of the
global batch, and the quantities the JAX package's one program takes over
the global batch are reduced over the ranks: the focal mean of the
disparity loss and the valid count. Each rank's scalar is then its own sum
over the global count, so that the ranks' scalars (and their gradients) add
up to the one-program scalar, and the parameter loss enters each rank with
weight 1/N, once in the sum. The returned loss carries the global value
(all-reduced) and the gradient of the rank's own share.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..parallel.mesh import Mesh, all_reduce_sum
from . import geometry
from .resample import sample_uv


class LossWeights(NamedTuple):
    """Loss hyperparameters (reference: loss/loss_params.py)."""

    lambda_view_baseline: float = 0.1
    lambda_reprojection: float = 1.0
    lambda_parameter: float = 0.0


def weighted_mean_loss(x: torch.Tensor, weights: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Per-sample weighted mean with weights normalised to sum 1:
    x, weights (B, ...) -> (B,)."""
    B = x.shape[0]
    w = weights.reshape(B, -1)
    w_sum = torch.clamp(w.sum(-1, keepdim=True), min=eps)
    return ((w / w_sum) * x.reshape(B, -1)).sum(-1)


def weighted_mse_loss(x: torch.Tensor, target: torch.Tensor,
                      weights: torch.Tensor, eps: float = 1e-6
                      ) -> torch.Tensor:
    """(B, H, W, C) inputs, (B, H, W) weights -> (B,) of weighted mean
    squared error summed over channels."""
    return weighted_mean_loss(((x - target) ** 2).sum(-1), weights, eps)


def weighted_rmse_loss(x: torch.Tensor, target: torch.Tensor,
                       weights: torch.Tensor, eps: float = 1e-6
                       ) -> torch.Tensor:
    """(B, H, W, C) inputs, (B, H, W) weights -> (B,) of the weighted mean
    of the per-pixel Euclidean error over channels."""
    return weighted_mean_loss(torch.linalg.vector_norm(x - target, dim=-1),
                              weights, eps)


def geometry_consistency_loss(
        points_cam: torch.Tensor, intrinsics: torch.Tensor,
        extrinsics: torch.Tensor, pixels: torch.Tensor, flows: torch.Tensor,
        masks: torch.Tensor, weights: LossWeights,
        mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pairwise geometric consistency.

    Args:
        points_cam: (B, 2, H, W, 3) camera-space points per frame
        intrinsics: (B, 2, 4)
        extrinsics: (B, 2, 3, 4)
        pixels:     (H, W, 2)
        flows:      (B, 2, H, W, 2) flow from frame k to frame 1-k, pixels
        masks:      (B, 2, H, W) valid-correspondence masks in {0, 1}
        mesh:       with a mesh, the focal mean is the global batch's

    Returns:
        (mean loss over the batch, {"reprojection": (B,), "disparity": (B,)})
    """
    B = points_cam.shape[0]
    reproj_losses, disp_losses = [], []
    for k in (0, 1):
        j = 1 - k
        points_cam_tgt = geometry.reproject_points(
            points_cam[:, k], extrinsics[:, k], extrinsics[:, j])
        matched_pixels_tgt = pixels + flows[:, k]
        pixels_tgt = geometry.project(points_cam_tgt, intrinsics[:, j])

        if weights.lambda_reprojection > 0:
            reproj_dist = torch.linalg.vector_norm(
                pixels_tgt - matched_pixels_tgt, dim=-1)
            reproj_losses.append(
                weighted_mean_loss(reproj_dist.abs(), masks[:, k]))

        if weights.lambda_view_baseline > 0:
            # global scalar mean of (fx, fy) over the batch, as in the
            # reference (consistency_loss.py:178)
            f = geometry.focal_length(intrinsics[:, k])
            if mesh is None:
                f = f.mean()
            else:
                f_sum = all_reduce_sum(mesh, torch.stack(
                    [f.sum(), f.new_tensor(float(f.numel()))]))
                f = f_sum[0] / f_sum[1]
            warped_tgt_z = sample_uv(
                points_cam[:, j][..., -1:], matched_pixels_tgt)[..., 0]
            disp_diff = 1.0 / points_cam_tgt[..., -1] - 1.0 / warped_tgt_z
            disp_losses.append(
                f * weighted_mean_loss(disp_diff.abs(), masks[:, k]))

    zeros = torch.zeros((B,), dtype=points_cam.dtype,
                        device=points_cam.device)
    reproj_loss = (weights.lambda_reprojection
                   * torch.stack(reproj_losses, -1).mean(-1)
                   if reproj_losses else zeros)
    disp_loss = (weights.lambda_view_baseline
                 * torch.stack(disp_losses, -1).mean(-1)
                 if disp_losses else zeros)
    batch_losses = {"reprojection": reproj_loss, "disparity": disp_loss}
    return (reproj_loss + disp_loss).mean(), batch_losses


def consistency_loss(
        depths: torch.Tensor, intrinsics: torch.Tensor,
        extrinsics: torch.Tensor, flows: torch.Tensor, masks: torch.Tensor,
        weights: LossWeights, valid: Optional[torch.Tensor] = None,
        mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full consistency loss from predicted depths (B, 2, H, W). With
    ``valid`` (B,) in {0, 1}, padded samples contribute 0 and the scalar
    divides by the valid count. With a ``mesh`` the count and the focal
    mean are the global batch's, and the scalar is this rank's sum over the
    global count (its share of the global scalar)."""
    H, W = depths.shape[-2:]
    pixels = geometry.pixel_grid((H, W), dtype=depths.dtype,
                                 device=depths.device)
    points_cam = geometry.pixels_to_points(intrinsics, depths, pixels)
    scalar, batch_losses = geometry_consistency_loss(
        points_cam, intrinsics, extrinsics, pixels, flows, masks, weights,
        mesh=mesh)
    if mesh is not None:
        v = (valid.to(depths.dtype) if valid is not None else
             torch.ones((depths.shape[0],), dtype=depths.dtype,
                        device=depths.device))
        batch_losses = {k: x * v for k, x in batch_losses.items()}
        total = sum(batch_losses.values())
        count = all_reduce_sum(mesh, v.sum())
        scalar = total.sum() / torch.clamp(count, min=1.0)
    elif valid is not None:
        v = valid.to(depths.dtype)
        batch_losses = {k: x * v for k, x in batch_losses.items()}
        total = sum(batch_losses.values())
        scalar = total.sum() / torch.clamp(v.sum(), min=1.0)
    return scalar, batch_losses


def parameter_loss(params: Mapping[str, torch.Tensor],
                   params_init: Mapping[str, torch.Tensor],
                   lambda_parameter: float
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 pull toward the pretrained weights (reference:
    loss/parameter_loss.py). ``params`` and ``params_init`` map the same
    names to tensors."""
    diffs = [torch.sum(torch.abs(p - params_init[name]))
             for name, p in params.items()]
    total = lambda_parameter * torch.stack(diffs).sum()
    return total, {"parameter_loss": total.reshape(1, 1)}


def joint_loss(
        depths: torch.Tensor, intrinsics: torch.Tensor,
        extrinsics: torch.Tensor, flows: torch.Tensor, masks: torch.Tensor,
        weights: LossWeights,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        params_init: Optional[Mapping[str, torch.Tensor]] = None,
        valid: Optional[torch.Tensor] = None,
        mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of the parameter and consistency losses (reference:
    loss/joint_loss.py). With a ``mesh`` the returned scalar's value is the
    global loss, the same on every rank, and its gradient is this rank's
    share: the consistency sum over the global count plus 1/N of the
    parameter loss."""
    loss = torch.zeros((), dtype=depths.dtype, device=depths.device)
    batch_losses: Dict[str, torch.Tensor] = {}
    if weights.lambda_parameter > 0:
        if params is None or params_init is None:
            raise ValueError("lambda_parameter > 0 needs params and "
                             "params_init")
        p_loss, p_batch = parameter_loss(
            params, params_init, weights.lambda_parameter)
        loss = loss + (p_loss if mesh is None else p_loss / mesh.size)
        batch_losses.update(p_batch)
    if weights.lambda_view_baseline > 0 or weights.lambda_reprojection > 0:
        c_loss, c_batch = consistency_loss(
            depths, intrinsics, extrinsics, flows, masks, weights,
            valid=valid, mesh=mesh)
        loss = loss + c_loss
        batch_losses.update(c_batch)
    if mesh is not None:
        # the global value, exactly, carrying this rank's gradient
        total = all_reduce_sum(mesh, loss.detach())
        loss = total + (loss - loss.detach())
    return loss, batch_losses
