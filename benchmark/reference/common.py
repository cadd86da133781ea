"""Plain PyTorch pieces shared by the configurations' references: the conv,
the linear, the matmul and the attention with an optional lower-precision
rounding of their operands (the control), the geometric consistency loss
chain and Adam with the NaN-skip.

A frozen copy of the port's plain arithmetic (``ops/geometry.py``,
``ops/resample.py``, ``ops/losses.py`` without a mesh, and the engine's
step: ``training/engine.py``), written against ``torch`` alone. It imports
nothing of the program. Run it in f32 with TF32 off (:func:`f32_policy`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

def f32_policy() -> None:
    """No TF32 in cuDNN convs or in matmuls: the reference computes f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as a tensor core rounds its TF32 operands."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# the control's format of each precision a cell may state: TF32 for f32
ROUNDINGS = {"tf32": round_tf32}


class _Round(torch.autograd.Function):
    """The operand rounded on the way in; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, t, fn):
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """Identity on the way in; the cotangent rounded on the way back, so
    that the grad-input and grad-weight products take rounded operands
    too."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride=1, padding=0, groups: int = 1,
           rounding: Optional[str] = None) -> torch.Tensor:
    """``F.conv2d``; with ``rounding`` ("tf32") every product of the conv
    and of its backward takes operands rounded to that format and sums in
    f32, as a tensor core of that format does."""
    if rounding is None:
        return F.conv2d(x, w, b, stride, padding, 1, groups)
    fn = ROUNDINGS[rounding]
    y = F.conv2d(_Round.apply(x, fn), _Round.apply(w, fn), b, stride,
                 padding, 1, groups)
    return _RoundGrad.apply(y, fn)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose products follow ``self.rounding`` (None: f32)."""

    rounding: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.groups, self.rounding)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           rounding: Optional[str] = None) -> torch.Tensor:
    """``F.linear``; with ``rounding``, as :func:`conv2d`."""
    if rounding is None:
        return F.linear(x, w, b)
    fn = ROUNDINGS[rounding]
    y = F.linear(_Round.apply(x, fn), _Round.apply(w, fn), b)
    return _RoundGrad.apply(y, fn)


def matmul(a: torch.Tensor, b: torch.Tensor,
           rounding: Optional[str] = None) -> torch.Tensor:
    """``torch.matmul``; with ``rounding``, as :func:`conv2d`."""
    if rounding is None:
        return torch.matmul(a, b)
    fn = ROUNDINGS[rounding]
    y = torch.matmul(_Round.apply(a, fn), _Round.apply(b, fn))
    return _RoundGrad.apply(y, fn)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rounding: Optional[str] = None) -> torch.Tensor:
    """``F.scaled_dot_product_attention`` of q (..., Lq, d), k and v (...,
    Lk, d), no mask; with ``rounding``, Q K^T and P V as :func:`matmul`
    (the scores and the softmax in f32)."""
    if rounding is None:
        return F.scaled_dot_product_attention(q, k, v)
    s = matmul(q, k.transpose(-2, -1), rounding) * q.shape[-1] ** -0.5
    return matmul(torch.softmax(s, dim=-1), v, rounding)


class Linear(nn.Linear):
    """``nn.Linear`` whose products follow ``self.rounding`` (None: f32)."""

    rounding: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.rounding)


def set_rounding(net: nn.Module, rounding: Optional[str]) -> nn.Module:
    """Every :class:`Conv2d` and :class:`Linear` of ``net`` (and every
    module with a ``rounding`` of its own, for the products it calls
    directly) computes with ``rounding``; returns ``net``."""
    for m in net.modules():
        if hasattr(m, "rounding"):
            m.rounding = rounding
    return net


# -- camera geometry (ops/geometry.py) ---------------------------------------
def pixel_grid(H: int, W: int, device) -> torch.Tensor:
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack((x, y), dim=-1)


def _flip_v(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat((uv[..., :1], -uv[..., 1:]), dim=-1)


def pixels_to_points(intrinsics, depths, pixels):
    cs = intrinsics[..., None, None, 2:]
    fs = intrinsics[..., None, None, :2]
    uv = _flip_v(pixels - cs) / fs
    ones = -torch.ones(uv.shape[:-1] + (1,), dtype=uv.dtype, device=uv.device)
    return torch.cat((uv, ones), dim=-1) * depths[..., None]


def project(points, intrinsics):
    rays = points / -points[..., -1:]
    uv = _flip_v(rays[..., :2] * intrinsics[..., None, None, :2])
    return uv + intrinsics[..., None, None, 2:]


def _rotate(R, p):
    return (R[..., None, None, :, :] * p[..., None, :]).sum(-1)


def reproject_points(points, ext_ref, ext_tgt):
    R_ref, t_ref = ext_ref[..., :, :3], ext_ref[..., :, 3]
    R_tgt, t_tgt = ext_tgt[..., :, :3], ext_tgt[..., :, 3]
    world = _rotate(R_ref, points) + t_ref[..., None, None, :]
    return _rotate(R_tgt.transpose(-1, -2), world - t_tgt[..., None, None, :])


# -- border-clamped bilinear sampling (ops/resample.py) -----------------------
def sample_uv(data: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """``grid_sample(border, align_corners=False)`` of data (B, H, W, C) at
    pixels uv (B, Ho, Wo, 2) normalised by (W - 1, H - 1)."""
    B, H, W, C = data.shape
    gx = 2.0 * uv[..., 0] / (W - 1.0) - 1.0
    gy = 2.0 * uv[..., 1] / (H - 1.0) - 1.0
    x = torch.clamp(((gx + 1.0) * W - 1.0) * 0.5, 0.0, W - 1.0)
    y = torch.clamp(((gy + 1.0) * H - 1.0) * 0.5, 0.0, H - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0f).unsqueeze(-1), (y - y0f).unsqueeze(-1)
    x0 = torch.nan_to_num(x0f).clamp(0, W - 1).long()
    y0 = torch.nan_to_num(y0f).clamp(0, H - 1).long()
    x1, y1 = torch.clamp(x0 + 1, max=W - 1), torch.clamp(y0 + 1, max=H - 1)
    flat = data.reshape(B, H * W, C)
    batch = torch.arange(B, device=data.device).view((B,) + (1,) * (x.dim() - 1))

    def gather(ix, iy):
        return flat[batch, iy * W + ix]

    top = gather(x0, y0) * (1.0 - wx) + gather(x1, y0) * wx
    bot = gather(x0, y1) * (1.0 - wx) + gather(x1, y1) * wx
    return top * (1.0 - wy) + bot * wy


# -- the loss chain (ops/losses.py, without a mesh) ---------------------------
def _weighted_mean(x, weights, eps=1e-6):
    B = x.shape[0]
    w = weights.reshape(B, -1)
    w_sum = torch.clamp(w.sum(-1, keepdim=True), min=eps)
    return ((w / w_sum) * x.reshape(B, -1)).sum(-1)


def consistency_loss(depths, intrinsics, extrinsics, flows, masks, valid,
                     lambda_view_baseline: float,
                     lambda_reprojection: float = 1.0):
    """(scalar over the valid pairs, {"reprojection": (B,), "disparity":
    (B,)}) of depths (B, 2, H, W): the geometric consistency loss of
    reference loss/consistency_loss.py, both directions of each pair."""
    H, W = depths.shape[-2:]
    pixels = pixel_grid(H, W, depths.device)
    points = pixels_to_points(intrinsics, depths, pixels)
    reproj, disp = [], []
    for k in (0, 1):
        j = 1 - k
        pts_tgt = reproject_points(points[:, k], extrinsics[:, k],
                                   extrinsics[:, j])
        matched = pixels + flows[:, k]
        pix_tgt = project(pts_tgt, intrinsics[:, j])
        dist = torch.linalg.vector_norm(pix_tgt - matched, dim=-1)
        reproj.append(_weighted_mean(dist.abs(), masks[:, k]))
        f = intrinsics[:, k, :2].mean()
        warped_z = sample_uv(points[:, j][..., -1:], matched)[..., 0]
        diff = 1.0 / pts_tgt[..., -1] - 1.0 / warped_z
        disp.append(f * _weighted_mean(diff.abs(), masks[:, k]))
    v = valid.to(depths.dtype)
    losses = {
        "reprojection": lambda_reprojection * torch.stack(reproj, -1).mean(-1) * v,
        "disparity": lambda_view_baseline * torch.stack(disp, -1).mean(-1) * v,
    }
    total = losses["reprojection"] + losses["disparity"]
    return total.sum() / torch.clamp(v.sum(), min=1.0), losses


def gather_batch(data: Mapping[str, torch.Tensor], idx: torch.Tensor):
    """A pair batch of the resident dataset (training/engine.py)."""
    slots = data["pair_slots"][idx].long()
    return {"images": data["frames"][slots], "flows": data["flows"][idx],
            "masks": data["masks"][idx],
            "intrinsics": data["intrinsics"][idx],
            "extrinsics": data["extrinsics"][idx]}


# -- Adam with the NaN-skip (torch.optim.Adam's formula) ----------------------
class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) over named f32 tensors, leaf by
    leaf; a step with a non-finite loss or gradient leaves the parameters
    and the moments unchanged, as the engine's masked update does."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor]) -> bool:
        """Returns whether the update was applied."""
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        if not finite:
            return False
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
        return True


def train_steps(net_apply, net: nn.Module, data, steps: List[torch.Tensor],
                valid: List[torch.Tensor], lr: float,
                lambda_view_baseline: float):
    """The reference's run of the first train steps: train-mode forward,
    the loss, the backward and Adam, one step per (B,) index tensor.
    ``net_apply(images (B, 2, H, W, 3)) -> depth (B, 2, H, W)``.
    Returns (losses, {leaf: first gradient}, {leaf: parameters after the
    steps}), all f32 on the device."""
    params = dict(net.named_parameters())
    opt = Adam({k: p.data for k, p in params.items()}, lr)
    net.train()
    losses, first = [], None
    for idx, v in zip(steps, valid):
        batch = gather_batch(data, idx)
        for p in params.values():
            p.grad = None
        depth = net_apply(batch["images"])
        loss, _ = consistency_loss(
            depth, batch["intrinsics"], batch["extrinsics"], batch["flows"],
            batch["masks"], v, lambda_view_baseline)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(loss.detach(), grads)
        losses.append(loss.detach())
    after = {k: p.detach().clone() for k, p in params.items()}
    return torch.stack(losses), first, after
