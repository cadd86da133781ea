"""Depth-model abstraction: the port of ``consistent_depth_tpu/models/base.py``
(eval-mode forward only in this slice).

A backbone adapter owns an ``nn.Module`` on an explicit device, in an
explicit compute dtype, channels_last in memory, and exposes

    apply(images, scales=None) -> depth

with images (B, N, H, W, 3) BGR in [0, 1] and depth (B, N, H, W) f32
(depth, not disparity).

Weights come from a ``.pth`` checkpoint in the torch state_dict layout or,
for ``checkpoint=""``, from a seeded initialisation. Nothing is ever
downloaded: a checkpoint path that does not exist raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn

from .layers import init_parameters


class DepthModel:
    # per-backbone requirement: H and W must be multiples of ``align``
    align: int = 1
    default_checkpoint: Optional[str] = None

    def __init__(self, checkpoint: Optional[str] = None, seed: int = 0,
                 device="cpu", dtype: torch.dtype = torch.float32):
        """``checkpoint=None`` means the adapter's default checkpoint path;
        ``checkpoint=""`` means a seeded initialisation."""
        if checkpoint is None:
            checkpoint = self.default_checkpoint
        # built on the meta device so that construction draws nothing from
        # the global RNG; every value is then set explicitly below
        with torch.device("meta"):
            net = self._make_module()
        net = net.to_empty(device="cpu")
        init_parameters(net, torch.Generator().manual_seed(seed))
        if checkpoint:
            if not os.path.exists(checkpoint):
                raise FileNotFoundError(
                    f"checkpoint '{checkpoint}' not found (the port never "
                    "downloads weights; pass checkpoint='' for a seeded "
                    "initialisation)")
            from .torch_import import load_checkpoint

            net.load_state_dict(load_checkpoint(checkpoint), strict=True)
        self.net = net.eval()
        self.device = torch.device("cpu")
        self.dtype = torch.float32
        self.to(device, dtype)

    def to(self, device, dtype: torch.dtype) -> "DepthModel":
        """Move the network to ``device`` and cast it to the compute
        ``dtype`` (in place); returns self."""
        self.net.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last)
        self.device = torch.device(device)
        self.dtype = dtype
        return self

    # -- provided by subclasses -------------------------------------------
    def _make_module(self) -> nn.Module:
        raise NotImplementedError

    def estimate_depth(self, images: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) in the compute dtype -> (B, N, H, W) depth."""
        raise NotImplementedError

    # -- shared API -------------------------------------------------------
    def apply(self, images: torch.Tensor,
              scales: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Eval-mode forward incl. the optional per-frame scale transform.

        Args:
            images: (B, N, H, W, 3) BGR [0, 1], on the model's device
            scales: optional (B, N) or (B, N, 1) depth multipliers
        Returns:
            (B, N, H, W) f32 depth
        """
        depth = self.estimate_depth(images.to(self.dtype)).float()
        if scales is not None:
            depth = depth * scales.reshape(
                scales.shape[0], scales.shape[1], 1, 1)
        return depth
