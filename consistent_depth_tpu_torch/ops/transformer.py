"""The transformer's products with their gradients: the linear and the
attention of a ViT encoder (``models/vit.py``) as autograd Functions whose
forward and backward each run in a span of ``..utils.tracing``
(``linear.forward``, ``linear.backward``, ``attention.forward``,
``attention.backward``), on every device.

The JAX package has no transformer, so no TPU kernel is ported here. The
products run on the library's kernels: a linear is one GEMM forward and two
(grad-input, grad-weight) backward, cuBLAS on the card, in f32 with TF32 off
as the port's other f32 products (the engine and the server set the
policy). The attention is the library's memory-efficient kernel on the card
(``aten._scaled_dot_product_efficient_attention``, which takes f32 and
bf16) and its flash kernel on the CPU; the forward keeps the kernel's
logsumexp, so the backward (``..._backward`` of the same kernel) does not
compute the forward again. The spans put the backward's kernels, which run
on autograd's thread, under a name of their own.

A transposed conv whose kernel equals its stride (DPT's reassemble
upsamplers, ``models/depth_anything_v2.py``) is one GEMM over the input
pixels and a pixel shuffle: :func:`conv_transpose_patches` computes it
through :func:`linear`, so that the linear's span and count cover it too.

:data:`counts` counts the calls of each product (forward passes, with or
without a gradient), on every device; :func:`launch_counts` reads them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing

# calls of :func:`linear` and :func:`attention`
counts = {"linear": 0, "attention": 0}


def launch_counts() -> Tuple[int, int]:
    """(linears, attentions) run since the last :func:`reset_counts`."""
    return counts["linear"], counts["attention"]


def reset_counts() -> None:
    """Zero :data:`counts`."""
    for key in counts:
        counts[key] = 0


class _Linear(torch.autograd.Function):
    """y = x w^T + b over the last axis of x; grad-input g w, grad-weight
    g^T x over every row, grad-bias the rows' sum in f32."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        with tracing.span(tracing.LINEAR_FORWARD):
            return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        with tracing.span(tracing.LINEAR_BACKWARD):
            g2 = g.reshape(-1, g.shape[-1])
            if ctx.needs_input_grad[0]:
                gx = torch.mm(g2, w).view(x.shape)
            if ctx.needs_input_grad[1]:
                gw = torch.mm(g2.t(), x.reshape(-1, x.shape[-1]))
            if ctx.has_bias and ctx.needs_input_grad[2]:
                gb = g2.sum(0, dtype=torch.float32).to(g.dtype)
        return gx, gw, gb


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, w, b)`` through :class:`_Linear` (with or without a
    gradient: under ``no_grad`` it records no graph)."""
    counts["linear"] += 1
    return _Linear.apply(x, w, b)


class _Attention(torch.autograd.Function):
    """softmax(q k^T / sqrt(d)) v of q, k, v (B, heads, L, d), no mask; the
    forward keeps the kernel's output and logsumexp for its backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        with tracing.span(tracing.ATTENTION_FORWARD):
            if q.device.type == "cuda":
                out, lse, seed, offset = \
                    torch.ops.aten._scaled_dot_product_efficient_attention(
                        q, k, v, None, True)
                ctx.save_for_backward(q, k, v, out, lse, seed, offset)
            else:
                out, lse = \
                    torch.ops.aten._scaled_dot_product_flash_attention_for_cpu(
                        q, k, v)
                ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        with tracing.span(tracing.ATTENTION_BACKWARD):
            if g.stride(-1) != 1:
                g = g.contiguous()
            if g.device.type == "cuda":
                q, k, v, out, lse, seed, offset = ctx.saved_tensors
                dq, dk, dv, _ = \
                    torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                        g, q, k, v, None, out, lse, seed, offset, 0.0,
                        [True, True, True, False])
            else:
                q, k, v, out, lse = ctx.saved_tensors
                dq, dk, dv = torch.ops.aten.\
                    _scaled_dot_product_flash_attention_for_cpu_backward(
                        g, q, k, v, out, lse, 0.0, False)
        return dq, dk, dv


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention of q, k, v (B, heads, L, d), the last
    axis contiguous, through :class:`_Attention` (with or without a
    gradient)."""
    counts["attention"] += 1
    return _Attention.apply(q, k, v)


def conv_transpose_patches(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.conv_transpose2d(x, w, b, stride=k)`` of x (N, Ci, H, W) with w
    (Ci, Co, k, k), whose output patches do not overlap: each input pixel's
    Ci values times w, read as a (Ci, k k Co) matrix, give its k x k patch
    of Co channels (one :func:`linear`), and the patches are laid out in
    place (one copy). The output is (N, Co, k H, k W), channels_last in
    memory."""
    N, Ci, H, W = x.shape
    Co, k = w.shape[1], w.shape[2]
    # rows (kh, kw, Co) of the product, so that a patch row is contiguous
    wt = w.permute(2, 3, 1, 0).reshape(k * k * Co, Ci)
    bias = None if b is None else b.repeat(k * k)
    y = linear(x.permute(0, 2, 3, 1), wt, bias)          # (N, H, W, k k Co)
    y = y.view(N, H, W, k, k, Co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(N, H * k, W * k, Co).permute(0, 3, 1, 2)
