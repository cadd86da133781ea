"""Optical-flow colour-wheel visualisation: the port of
``consistent_depth_tpu/ops/flow_viz.py``. :func:`flow_to_image_torch`
renders a batch on the flows' device; the wheel and the host renderer
(:func:`make_color_wheel`, :func:`flow_to_image`) are the port's copies of
the JAX module's numpy code (the standard Middlebury colour wheel)."""

from __future__ import annotations

import numpy as np
import torch

_UNKNOWN_FLOW_THRESH = 1e7


def make_color_wheel() -> np.ndarray:
    """(55, 3) RGB color wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = None


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map normalized flow components to RGB (uint8 HxWx3)."""
    global _WHEEL
    if _WHEEL is None:
        _WHEEL = make_color_wheel()
    wheel = _WHEEL
    ncols = wheel.shape[0]

    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)

    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        inner = rad <= 1
        col = np.where(inner, 1 - rad * (1 - col), col * 0.75)
        img[..., i] = np.uint8(np.floor(255 * col * (1 - nan_idx)))
    return img


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


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 RGB visualization."""
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()

    unknown = (np.abs(u) > _UNKNOWN_FLOW_THRESH) | (
        np.abs(v) > _UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0

    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(-1.0, float(np.max(rad)) if rad.size else -1.0)
    eps = np.finfo(float).eps
    u = u / (maxrad + eps)
    v = v / (maxrad + eps)

    img = compute_color(u, v)
    img[unknown] = 0
    return img
