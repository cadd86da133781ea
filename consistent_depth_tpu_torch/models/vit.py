"""DINOv2's ViT encoder (Oquab et al., 2023; the ``dinov2`` package of the
public Depth-Anything-V2 code, ``DinoVisionTransformer`` with
``block_chunks=0``, ``num_register_tokens=0``, ``ffn_layer="mlp"``), the
encoder of Depth Anything V2 (``models/depth_anything_v2.py``). The JAX
package has no transformer; this module is the port's own.

- A stride-``PATCH`` patch conv into ``dim`` channels, a cls token, and a
  learned position embedding of 1 + (img_size / PATCH)^2 positions, whose
  grid is resized bicubically to the input's patch grid by the scale
  factors (h0 + INTERPOLATE_OFFSET) / side and (w0 + INTERPOLATE_OFFSET) /
  side (no antialiasing),
  and returned unchanged for a square input of the grid's own size. A
  ``mask_token`` is held for the released key layout and never used.
- ``depth`` pre-norm blocks: ``x + ls1 * proj(attn(norm1 x))``, then
  ``x + ls2 * fc2(GELU(fc1(norm2 x)))``; LayerNorm eps 1e-6, ``heads``
  heads with a qkv bias, an MLP ``MLP_RATIO`` times wide with exact GELU,
  LayerScale gammas of ``dim`` starting at ``LAYER_SCALE``.
- :meth:`DinoVisionTransformer.get_intermediate_layers`: the final
  ``norm`` applied to the outputs of the tapped blocks, the cls token
  dropped.

Every linear is a :class:`Linear` (an ``nn.Linear``), computed through
``..ops.transformer.linear``, and the attention through
``..ops.transformer.attention``: both run in spans of their own, forward and
backward. Parameters stay f32 and meet a bf16 forward as bf16 copies, as
``layers.SameConv2d``'s do. Keys are the released ones (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``mask_token``, ``blocks.{i}.{norm1, attn.qkv,
attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import transformer
from .layers import SameConv2d, trunc_normal_

# ViT-L/14 as Depth Anything V2 builds it (``vit_large``, ``patch_size=14``,
# ``init_values=1.0``, ``interpolate_offset=0.1``)
PATCH = 14
MLP_RATIO = 4
LAYER_SCALE = 1.0
INTERPOLATE_OFFSET = 0.1
LAYER_NORM_EPS = 1e-6
# DINOv2's init of the position embedding and of the cls token
POS_STD = 0.02
CLS_STD = 1e-6


class Linear(nn.Linear):
    """``nn.Linear`` computed through :func:`..ops.transformer.linear`, in
    the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return transformer.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class LayerScale(nn.Module):
    """x * gamma, gamma (dim,) starting at ``LAYER_SCALE``."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def reset_free_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(LAYER_SCALE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        # (B, L, 3, heads, d): q, k and v are (B, heads, L, d) views with
        # the head's channels contiguous
        qkv = self.qkv(x).reshape(B, L, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = transformer.attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(B, L, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = SameConv2d(3, dim, PATCH, PATCH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, H / PATCH x W / PATCH, dim)."""
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    """DINOv2's ViT; the defaults are ViT-L/14 at 518 (``vit_large``)."""

    def __init__(self, img_size: int = 518, dim: int = 1024, depth: int = 24,
                 heads: int = 16):
        super().__init__()
        self.patch_embed = PatchEmbed(dim)
        side = img_size // PATCH
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + side * side, dim))
        self.mask_token = nn.Parameter(torch.empty(1, dim))
        self.blocks = nn.ModuleList(
            [Block(dim, heads) for _ in range(depth)])
        self.norm = LayerNorm(dim, eps=LAYER_NORM_EPS)

    def reset_free_parameters(self, generator: torch.Generator) -> None:
        """DINOv2's ``init_weights``: the position embedding N(0, 0.02^2)
        truncated at two standard deviations, the cls token N(0, 1e-12),
        the mask token 0."""
        trunc_normal_(self.pos_embed, POS_STD, generator)
        with torch.no_grad():
            self.cls_token.normal_(0.0, CLS_STD, generator=generator)
            self.mask_token.zero_()

    def interpolate_pos_encoding(self, n_patches: int, h: int,
                                 w: int) -> torch.Tensor:
        """The position embedding (1, 1 + n_patches, dim) for an input of h
        x w pixels: the learned grid resized bicubically by scale factors
        (h0 + INTERPOLATE_OFFSET) / side, (w0 + INTERPOLATE_OFFSET) / side,
        in f32."""
        N = self.pos_embed.shape[1] - 1
        if n_patches == N and h == w:
            return self.pos_embed
        pos = self.pos_embed.float()
        side = int(math.sqrt(N))
        dim = pos.shape[-1]
        h0 = h // PATCH + INTERPOLATE_OFFSET
        w0 = w // PATCH + INTERPOLATE_OFFSET
        grid = F.interpolate(
            pos[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2),
            scale_factor=(h0 / side, w0 / side), mode="bicubic",
            antialias=False)
        if grid.shape[-2:] != (int(h0), int(w0)):
            raise ValueError(f"position grid {tuple(grid.shape[-2:])} for a "
                             f"{h}x{w} input")
        grid = grid.permute(0, 2, 3, 1).reshape(1, -1, dim)
        return torch.cat((pos[:, :1], grid), dim=1)

    def prepare_tokens(self, x: torch.Tensor) -> torch.Tensor:
        B, _, h, w = x.shape
        t = self.patch_embed(x)
        t = torch.cat((self.cls_token.to(t.dtype).expand(B, -1, -1), t),
                      dim=1)
        return t + self.interpolate_pos_encoding(
            t.shape[1] - 1, h, w).to(t.dtype)

    def get_intermediate_layers(self, x: torch.Tensor,
                                taps: Sequence[int]) -> List[torch.Tensor]:
        """The patch tokens (B, h0 w0, dim) after the blocks ``taps``, each
        through the final norm."""
        t = self.prepare_tokens(x)
        out = []
        for i, block in enumerate(self.blocks):
            t = block(t)
            if i in taps:
                out.append(self.norm(t)[:, 1:])
        return out
