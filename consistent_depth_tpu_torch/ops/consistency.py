"""Flow-consistency masks: the port of
``consistent_depth_tpu/ops/consistency.py`` (reference:
utils/consistency.py).

mask = in-image(p + flow)
     and |flow_fwd + flow_bwd(p + flow_fwd)|^2 < flow_thresh^2
     and photometric SSE < C * color_thresh^2

batched over all frame pairs at once, NHWC as in the JAX package.
"""

from __future__ import annotations

import torch

from .geometry import pixel_grid
from .resample import sample_uv_wh


def consistency_mask(im_ref: torch.Tensor, im_tgt: torch.Tensor,
                     flow: torch.Tensor, threshold: float) -> torch.Tensor:
    """(B, H, W) bool: p + flow lies in the image and the SSE between
    ``im_ref`` (B, H, W, C) and ``im_tgt`` sampled at p + flow is below
    ``threshold``. ``flow`` (B, H, W, 2) in pixels."""
    H, W = im_ref.shape[1:3]
    idx = pixel_grid((H, W), dtype=flow.dtype, device=flow.device) + flow
    in_image = ((idx[..., 0] >= 0) & (idx[..., 0] <= W - 1)
                & (idx[..., 1] >= 0) & (idx[..., 1] <= H - 1))
    warped = sample_uv_wh(im_tgt, idx)
    sse = torch.sum((im_ref - warped) ** 2, dim=-1)
    return in_image & (sse < threshold)


def consistent_flow_masks(flows: torch.Tensor, colors: torch.Tensor,
                          flow_thresh: float = 1.0,
                          color_thresh: float = 1.0) -> torch.Tensor:
    """Both-direction masks for a batch of pairs (reference:
    utils/consistency.py:53-67).

    Args:
        flows:  (P, 2, H, W, 2); [:, k] is the flow frame_k -> frame_{1-k}
        colors: (P, 2, H, W, C)

    Returns:
        (P, 2, H, W) bool masks
    """
    C = colors.shape[-1]
    masks = []
    for k in (0, 1):
        j = 1 - k
        m_flow = consistency_mask(
            flows[:, k], -flows[:, j], flows[:, k], flow_thresh ** 2)
        m_photo = consistency_mask(
            colors[:, k], colors[:, j], flows[:, k], C * color_thresh ** 2)
        masks.append(m_flow & m_photo)
    return torch.stack(masks, dim=1)
