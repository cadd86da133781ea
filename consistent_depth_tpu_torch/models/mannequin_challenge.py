"""MannequinChallenge backbone adapter: the port of
``consistent_depth_tpu/models/mannequin_challenge.py``. Default backbone
("mc")."""

from __future__ import annotations

import torch

from .base import DepthModel
from .hourglass import HourglassModel


class MannequinChallengeModel(DepthModel):
    align = 16
    learning_rate = 0.0004
    lambda_view_baseline = 0.1
    default_checkpoint = "checkpoints/mc.pth"

    def _make_module(self):
        return HourglassModel()

    def estimate_depth(self, images: torch.Tensor) -> torch.Tensor:
        B, N, H, W, C = images.shape
        # (B*N, H, W, 3) -> NCHW view, channels_last in memory
        x = images.reshape(B * N, H, W, C).permute(0, 3, 1, 2)
        pred, _conf = self.net(x)
        # netG predicts log-depth; exp -> depth
        return torch.exp(pred[:, 0]).reshape(B, N, H, W)
