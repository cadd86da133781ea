"""Depth-model abstraction: the port of ``consistent_depth_tpu/models/base.py``.

A backbone adapter owns an ``nn.Module`` on an explicit device, with
parameters in an explicit dtype, channels_last in memory, and exposes

    apply(images, scales=None, train=False) -> depth

with images (B, N, H, W, 3) BGR in [0, 1] and depth (B, N, H, W) f32
(depth, not disparity). The forward computes in ``compute_dtype``, which is
the parameter dtype unless set apart from it: serving casts the whole
network to bf16, while training keeps f32 parameters and BN running stats
and computes in bf16, as the JAX package's bf16 mode does
(``layers.py::set_compute_dtype``).

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
                 device="cuda", dtype: torch.dtype = torch.float32):
        """``checkpoint=None`` means the adapter's default checkpoint path;
        ``checkpoint=""`` means a seeded initialisation. The network is
        built on the host and moved to ``device``, the card unless the
        caller asks for the CPU."""
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
        self.compute_dtype = torch.float32
        self.to(device, dtype)

    def to(self, device, dtype: torch.dtype) -> "DepthModel":
        """Move the network to ``device`` and cast its parameters and
        buffers to ``dtype``, which becomes the compute dtype too (in
        place); returns self."""
        self.net.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last)
        self.device = torch.device(device)
        self.dtype = dtype
        self.compute_dtype = dtype
        return self

    # -- provided by subclasses -------------------------------------------
    def _make_module(self) -> nn.Module:
        raise NotImplementedError

    def estimate_depth(self, images: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) in the compute dtype -> (B, N, H, W) depth in
        the compute dtype."""
        raise NotImplementedError

    # -- shared API -------------------------------------------------------
    def apply(self, images: torch.Tensor,
              scales: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
        """Forward incl. the optional per-frame scale transform. With
        ``train`` the batch norms normalise by the batch statistics and
        update their running stats (torch semantics: biased variance to
        normalise, unbiased into the running stat, momentum 0.1), as the
        JAX package's ``apply(..., train=True)``; otherwise they use the
        running stats.

        Args:
            images: (B, N, H, W, 3) BGR [0, 1], on the model's device
            scales: optional (B, N) or (B, N, 1) depth multipliers
        Returns:
            (B, N, H, W) f32 depth
        """
        if self.net.training != train:
            self.net.train(train)
        depth = self.estimate_depth(images.to(self.compute_dtype)).float()
        if scales is not None:
            depth = depth * scales.reshape(
                scales.shape[0], scales.shape[1], 1, 1)
        return depth
