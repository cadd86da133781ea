"""Optical-flow colour-wheel visualisation on the device: the port of
``consistent_depth_tpu/ops/flow_viz.py::flow_to_image_jnp``.

The wheel and the host renderer are the JAX module's own numpy code
(``make_color_wheel``, ``flow_to_image``), which imports no JAX."""

from __future__ import annotations

import numpy as np
import torch

from consistent_depth_tpu.ops.flow_viz import (  # noqa: F401
    _UNKNOWN_FLOW_THRESH, flow_to_image, make_color_wheel)


def flow_to_image_torch(flows: torch.Tensor) -> torch.Tensor:
    """Batched Middlebury rendering: (B, H, W, 2) flow -> (B, H, W, 3)
    uint8-valued float32 RGB, normalised by each image's largest radius,
    on the flows' device."""
    wheel = torch.as_tensor(make_color_wheel(), dtype=torch.float32,
                            device=flows.device)                # (55, 3)
    ncols = wheel.shape[0]

    u = flows[..., 0].float()
    v = flows[..., 1].float()
    unknown = (u.abs() > _UNKNOWN_FLOW_THRESH) | (
        v.abs() > _UNKNOWN_FLOW_THRESH)
    u = torch.where(unknown, 0.0, u)
    v = torch.where(unknown, 0.0, v)

    rad = torch.sqrt(u * u + v * v)
    maxrad = torch.clamp(rad.amax(dim=(1, 2), keepdim=True), min=-1.0)
    eps = float(np.finfo(np.float64).eps)
    un = u / (maxrad + eps)
    vn = v / (maxrad + eps)

    nan_idx = torch.isnan(un) | torch.isnan(vn)
    un = torch.where(nan_idx, 0.0, un)
    vn = torch.where(nan_idx, 0.0, vn)
    radn = torch.sqrt(un * un + vn * vn)
    a = torch.atan2(-vn, -un) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = torch.floor(fk).long()
    k1 = (k0 + 1) % ncols
    f = fk - k0

    chans = []
    for i in range(3):
        wc = wheel[:, i] / 255.0
        col = (1 - f) * wc[k0] + f * wc[k1]
        col = torch.where(radn <= 1, 1 - radn * (1 - col), col * 0.75)
        chans.append(torch.floor(255 * col * (~nan_idx)))
    img = torch.stack(chans, dim=-1)
    return torch.where(unknown.unsqueeze(-1), 0.0, img)
