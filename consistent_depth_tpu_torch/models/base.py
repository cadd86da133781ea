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

Weights come from a ``.pth`` checkpoint in the torch state_dict layout (or
an adapter's own released layout, ``_read_checkpoint``) or, for
``checkpoint=""``, from a seeded initialisation. The default checkpoint
of an adapter lies under ``$CDTPU_CHECKPOINT_DIR`` when that is set, else
under ``./checkpoints``, as the flow backend's does. Nothing is ever
downloaded: a checkpoint path that does not exist raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn as nn

from .layers import init_parameters


class DepthModel:
    # per-backbone requirement (H and W must be multiples of ``align``) and
    # defaults, which the CLI reads for its <=0 / <0 sentinel flags
    align: int = 1
    learning_rate: float = 1e-4
    lambda_view_baseline: float = 1.0
    # relative to the stock ``checkpoints/`` cache directory
    default_checkpoint: Optional[str] = None

    def __init__(self, checkpoint: Optional[str] = None, seed: int = 0,
                 device="cuda", dtype: torch.dtype = torch.float32):
        """``checkpoint=None`` means the adapter's default checkpoint path;
        ``checkpoint=""`` means a seeded initialisation. The network is
        built on the host and moved to ``device``, the card unless the
        caller asks for the CPU."""
        if checkpoint is None:
            checkpoint = self.default_checkpoint_path()
        # before the network is built: a missing file fails at once
        if checkpoint and not os.path.exists(checkpoint):
            raise FileNotFoundError(
                f"checkpoint '{checkpoint}' not found (the port never "
                "downloads weights; pass checkpoint='' for a seeded "
                "initialisation)")
        # built on the meta device so that construction draws nothing from
        # the global RNG; every value is then set explicitly below
        with torch.device("meta"):
            net = self._make_module()
        net = net.to_empty(device="cpu")
        if checkpoint:
            # the strict load sets every parameter and buffer but the BN
            # batch counters a checkpoint may lack, which start at 0; no
            # seeded init first (seconds of host time for MiDaS's 105 M
            # parameters)
            for m in net.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
            net.load_state_dict(self._read_checkpoint(checkpoint),
                                strict=True)
        else:
            init_parameters(net, torch.Generator().manual_seed(seed))
        self.net = net.eval()
        self.device = torch.device("cpu")
        self.dtype = torch.float32
        self.compute_dtype = torch.float32
        self.to(device, dtype)

    @classmethod
    def default_checkpoint_path(cls) -> Optional[str]:
        """``default_checkpoint``, relocated under ``$CDTPU_CHECKPOINT_DIR``
        when that is set (the JAX package's rule, models/base.py:56-68)."""
        if cls.default_checkpoint is None:
            return None
        ckpt_dir = os.environ.get("CDTPU_CHECKPOINT_DIR")
        if ckpt_dir:
            return os.path.join(ckpt_dir,
                                os.path.basename(cls.default_checkpoint))
        return cls.default_checkpoint

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

    def _read_checkpoint(self, path: str) -> Dict[str, torch.Tensor]:
        """The state_dict of the checkpoint at ``path`` under the module's
        keys; an adapter whose released layout differs overrides it."""
        from .torch_import import load_checkpoint

        return load_checkpoint(path)

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

    def forward(self, images, metadata=None, train: bool = True
                ) -> torch.Tensor:
        """``apply`` on ``images`` (B, N, H, W, 3), an array or a tensor,
        moved to the model's device, with ``metadata["scales"]`` as the
        per-frame depth multipliers when given. In train mode the batch
        norms update their running stats in place (the JAX package's
        stateful ``forward``)."""
        images = torch.as_tensor(images, device=self.device)
        scales = None
        if metadata is not None and "scales" in metadata:
            scales = torch.as_tensor(metadata["scales"], device=self.device)
        return self.apply(images, scales=scales, train=train)

    def parameters(self) -> Dict[str, nn.Parameter]:
        """The network's parameters by their torch state_dict key."""
        return dict(self.net.named_parameters())

    def save(self, file_name: str) -> None:
        """Write the network's state_dict as a torch-layout ``.pth``, in
        f32 whatever the model's dtype, the layout both packages' readers
        take (reference writes raw state_dicts: depth_fine_tuning.py:302-304)."""
        from .torch_import import save_checkpoint

        save_checkpoint(file_name, {
            k: v.float() if v.is_floating_point() else v
            for k, v in self.net.state_dict().items()})
