"""The training engine: the port of ``consistent_depth_tpu/training/engine.py``
(the train and eval steps in this slice).

Reference equivalent: the body of DepthFineTuner.fine_tune's loop
(depth_fine_tuning.py:261-304). One step gathers a pair batch from the
dataset resident on the device, runs the backbone with train-mode BN,
the geometric consistency loss, the backward and the optimizer.

The engine holds the training state: the model's parameters and BN
running stats, the optimizer's state, and ``step``. The parameters stay
f32 whatever the precision; ``precision="bf16"`` makes the backbone
compute in bf16 (convs, activations), with BN statistics, depth and the
loss in f32, as the JAX package's bf16 mode; ``precision`` defaults to
f32, the fine-tune's default
(``consistent_depth_tpu/training/fine_tuning.py --precision``).

NaN-skip (reference: depth_fine_tuning.py:278-280, and the JAX engine's
masked update): a step whose loss or any gradient is not finite leaves
the parameters and the optimizer state (Adam's moments and step count
included) bitwise unchanged; the BN running stats keep the forward's
update and ``step`` advances. Whether to apply the update is decided on
the host, which reads one flag from the device per step: the step's one
sync. ``flag_wait_s`` sums the host seconds spent blocked in that read.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.base import DepthModel
from ..ops.losses import LossWeights, joint_loss
from .optimizer import OptimizerFactory


def gather_batch(data: Mapping[str, torch.Tensor],
                 idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Assembly of a pair batch from the resident dataset, on its device."""
    slots = data["pair_slots"][idx].long()       # (B, 2)
    batch = {
        "images": data["frames"][slots],         # (B, 2, H, W, 3)
        "flows": data["flows"][idx],
        "masks": data["masks"][idx],
        "intrinsics": data["intrinsics"][idx],
        "extrinsics": data["extrinsics"][idx],
        "pair_ids": data["pair_ids"][idx],
    }
    if "scales" in data:
        batch["scales"] = data["scales"][idx]
    return batch


class TrainingEngine:
    """Owns the train and eval steps for one backbone."""

    def __init__(self, model: DepthModel, optimizer: OptimizerFactory,
                 weights: LossWeights,
                 params_init: Optional[Mapping[str, torch.Tensor]] = None,
                 precision: str = "f32"):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', not "
                             f"{precision!r}")
        self.params = dict(model.net.named_parameters())
        bad = sorted({str(p.dtype) for p in self.params.values()
                      if p.dtype != torch.float32})
        if bad:
            raise ValueError(f"training keeps f32 parameters, the model has "
                             f"{bad}; build it with dtype=torch.float32")
        model.compute_dtype = (torch.bfloat16 if precision == "bf16"
                               else torch.float32)
        if precision == "f32" and model.device.type == "cuda":
            # f32 means f32: no TF32 in cuDNN convs (1x1 convs, wgrad) or
            # matmuls, as the serving and flow paths
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model
        self.optimizer = optimizer(self.params.values())
        self.weights = weights
        # copy of the pretrained parameters for the parameter loss
        # (reference: depth_fine_tuning.py:223-224), made only when needed
        self.params_init = params_init
        if weights.lambda_parameter > 0 and params_init is None:
            self.params_init = {k: p.detach().clone()
                                for k, p in self.params.items()}
        self.step = 0
        self.flag_wait_s = 0.0

    def put_data(self, data: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Copy the dataset (numpy arrays) to the model's device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.model.device)
                for k, v in data.items() if v is not None}

    def _indices(self, idx, valid):
        dev = self.model.device
        return (torch.as_tensor(np.asarray(idx), dtype=torch.long).to(dev),
                torch.as_tensor(np.asarray(valid),
                                dtype=torch.float32).to(dev))

    def _loss(self, batch: Mapping[str, torch.Tensor], valid: torch.Tensor,
              train: bool):
        """(loss, per-pair losses, depth) of one batch; ``train`` picks
        train-mode BN (batch statistics, running-stat update)."""
        depth = self.model.apply(batch["images"], scales=batch.get("scales"),
                                 train=train)
        loss, batch_losses = joint_loss(
            depth, batch["intrinsics"], batch["extrinsics"], batch["flows"],
            batch["masks"], self.weights, params=self.params,
            params_init=self.params_init, valid=valid)
        return loss, batch_losses, depth

    def train_step(self, data: Mapping[str, torch.Tensor], idx,
                   valid) -> Dict[str, torch.Tensor]:
        """One optimizer step on pairs ``idx`` (B,) of the resident
        ``data``, ``valid`` (B,) marking real (1) and padding (0) pairs.
        Returns device tensors: ``loss``, ``skipped_nan``, and the per-pair
        ``reprojection`` and ``disparity`` losses."""
        idx, valid = self._indices(idx, valid)
        batch = gather_batch(data, idx)
        self.optimizer.zero_grad(set_to_none=True)
        loss, batch_losses, _ = self._loss(batch, valid, train=True)
        loss.backward()
        # skip on a non-finite loss AND on non-finite gradients: a finite
        # loss can still carry 0*inf gradients through the 1/z backward
        # at degenerate depths. One multi-tensor pass over the gradients
        # (the check of torch.amp's GradScaler, at scale 1, which leaves
        # every finite value as it is) sets ``found`` to 1 on any NaN/inf.
        grads = [p.grad for p in self.params.values() if p.grad is not None]
        found = torch.zeros((), device=loss.device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found, torch.ones((), device=loss.device))
        ok = (found == 0) & torch.isfinite(loss)
        t0 = time.perf_counter()
        apply = bool(ok)
        self.flag_wait_s += time.perf_counter() - t0
        if apply:
            self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), "skipped_nan": ~ok,
                **{k: v.detach() for k, v in batch_losses.items()}}

    @torch.no_grad()
    def eval_step(self, data: Mapping[str, torch.Tensor], idx,
                  valid) -> Dict[str, torch.Tensor]:
        """Validation pass on one batch: train-mode BN with running-stat
        updates and no gradient step (torch no_grad in train() mode,
        reference depth_fine_tuning.py:246-257, 312-341)."""
        idx, valid = self._indices(idx, valid)
        batch = gather_batch(data, idx)
        loss, batch_losses, depth = self._loss(batch, valid, train=True)
        return {"loss": loss, "depth": depth, "pair_ids": batch["pair_ids"],
                **batch_losses}
