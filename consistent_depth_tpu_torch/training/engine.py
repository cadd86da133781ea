"""The training engine: the port of ``consistent_depth_tpu/training/engine.py``.

Reference equivalent: the body of DepthFineTuner.fine_tune's loop
(depth_fine_tuning.py:261-304), its validation pass (:312-406) and the
eval-mode inference of ``save_depth`` (:164-199). A step gathers a pair
batch from the dataset resident on the device, runs the backbone with
train-mode BN, the geometric consistency loss, the backward and the
optimizer. ``train_epoch`` queues an epoch of steps, ``eval_epoch`` the
validation pass, ``infer`` eval-mode depth.

The engine holds the training state: the model's parameters and BN
running stats, the optimizer's state, and ``step``. The parameters stay
f32 whatever the precision; ``precision="bf16"`` makes the backbone
compute in bf16 (convs, activations), with BN statistics, depth and the
loss in f32, as the JAX package's bf16 mode; ``precision`` defaults to
f32, the fine-tune's default
(``consistent_depth_tpu/training/fine_tuning.py --precision``).

NaN-skip (reference: depth_fine_tuning.py:278-280), as the JAX engine's
masked update: a step whose loss or any gradient is not finite leaves the
parameters and the optimizer state (Adam's moments and step count
included) bitwise unchanged; the BN running stats keep the forward's
update and ``step`` advances. The flag stays on the device: it goes to
the fused optimizer as ``found_inf``, so no step reads a value on the
host. Where the JAX engine compiles an epoch into one ``lax.scan``, the
port queues its steps on the card's stream: the index arrays go up once
per epoch and every metric stays on the device, so an epoch or an eval
pass issues no sync.

With a data ``mesh`` (``..parallel.mesh``), as the JAX engine's programs
over the mesh: every rank holds the replicated state (broadcast from rank 0
at construction) and the resident dataset, and computes its block of each
(S, B) index and valid array; the batch norms take the global batch's
statistics (``models.layers.GlobalBatchNorm2d``) and the loss its global
focal mean and valid count (``ops.losses``). After the backward one sum
all-reduce of all gradients, as one flat buffer, gives every rank the
global gradient, so that the NaN-skip (on the reduced gradients and the
global loss) and the update are the same on every rank. The per-pair
losses, the pair ids and the depths come back in the global (S, B) layout.
``infer`` runs no collective, as the JAX engine's unsharded ``infer``.

Spans (``..utils.tracing``, off by default) name each epoch call, each
step and its gather, forward, loss, backward and optimizer, and each eval
batch with its forward, loss and depth scatter.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.base import DepthModel
from ..models.layers import convert_global_batch_norm
from ..ops.losses import LossWeights, joint_loss
from ..parallel.mesh import (
    Mesh, all_gather_batch, put_replicated, shard_batch)
from ..utils import tracing
from .optimizer import OptimizerFactory

# the metrics that hold one value per pair of the batch
PER_PAIR = ("reprojection", "disparity")


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


def _stack(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """A list of per-step metric dicts -> one dict of tensors stacked over
    steps."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def map_tensors(fn, obj):
    """``obj`` (dicts, lists and tuples of tensors and plain values) with
    ``fn`` applied to every tensor in it."""
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


def _clone(obj):
    """A copy of ``obj`` with every tensor cloned on its device."""
    return map_tensors(lambda t: t.detach().clone(), obj)


class TrainingEngine:
    """Owns the train, eval and infer passes for one backbone."""

    # capacity of the per-epoch depth-capture buffer (one slot per
    # display-freq TensorBoard image-grid event)
    CAPTURE_SLOTS = 8

    def __init__(self, model: DepthModel, optimizer: OptimizerFactory,
                 weights: LossWeights,
                 params_init: Optional[Mapping[str, torch.Tensor]] = None,
                 precision: str = "f32", eval_dedup: Optional[bool] = None,
                 mesh: Optional[Mesh] = None):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', not "
                             f"{precision!r}")
        self.params = dict(model.net.named_parameters())
        bad = sorted({str(p.dtype) for p in self.params.values()
                      if p.dtype != torch.float32})
        if bad:
            raise ValueError(f"training keeps f32 parameters, the model has "
                             f"{bad}; build it with dtype=torch.float32")
        self.precision = precision
        model.compute_dtype = (torch.bfloat16 if precision == "bf16"
                               else torch.float32)
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            device = model.device
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            if device != mesh.device:
                raise ValueError(f"the model is on {model.device} and this "
                                 f"rank's mesh device is {mesh.device}")
            put_replicated(mesh, model.net.state_dict().values())
            if params_init is not None:
                put_replicated(mesh, params_init.values())
            convert_global_batch_norm(model.net, mesh)
            # the gradients live in one flat buffer, each with its
            # parameter's strides, so that one all-reduce sums them all
            numels = [p.numel() for p in self.params.values()]
            self._grad_flat = torch.zeros(sum(numels), device=model.device)
            offsets = np.cumsum([0] + numels[:-1]).tolist()
            self._grad_views = [
                self._grad_flat.as_strided(p.shape, p.stride(), off)
                for p, off in zip(self.params.values(), offsets)]
        self.optimizer = optimizer(self.params.values())
        if not self.optimizer.defaults.get("fused"):
            raise ValueError("the masked update needs a fused optimizer "
                             "(training/optimizer.py builds them so)")
        self.weights = weights
        # copy of the pretrained parameters for the parameter loss
        # (reference: depth_fine_tuning.py:223-224), made only when needed
        self.params_init = params_init
        if weights.lambda_parameter > 0 and params_init is None:
            self.params_init = {k: p.detach().clone()
                                for k, p in self.params.items()}
        # the deduplicated eval (eval_epoch) is the default under bf16 and
        # off (the reference's paired pass) in f32, as in the JAX engine
        self.eval_dedup = (precision == "bf16") if eval_dedup is None \
            else eval_dedup
        self.step = 0
        self._policy()

    def _policy(self) -> None:
        """The card's TF32 policy, set before every pass because it is
        process-global and another engine may have changed it: no TF32 in
        cuDNN convs (1x1 convs, wgrad) or matmuls in either precision, as
        the serving and flow paths (bf16 computes the backbone in bf16 by
        its dtype)."""
        if self.model.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    @property
    def _dump_dtype(self) -> torch.dtype:
        """Depths kept for the host (capture slots, eval buffers): f16
        under bf16, whose predictions carry ~4e-3 relative noise, f32
        otherwise (JAX engine :281-286, :302-309)."""
        return torch.float16 if self.precision == "bf16" else torch.float32

    def put_data(self, data: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Copy the dataset (numpy arrays) to the model's device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.model.device)
                for k, v in data.items() if v is not None}

    def _upload(self, array, dtype: torch.dtype) -> torch.Tensor:
        """A host array on the model's device: on the card through pinned
        memory and a non-blocking copy, which does not wait for the
        queued work."""
        t = torch.as_tensor(np.ascontiguousarray(array), dtype=dtype)
        if self.model.device.type == "cuda":
            return t.pin_memory().to(self.model.device, non_blocking=True)
        return t.to(self.model.device)

    def _indices(self, idx, valid):
        return (self._upload(idx, torch.long),
                self._upload(valid, torch.float32))

    def _shard(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's block of the batch axis ``axis`` of a device array;
        the whole array without a mesh."""
        if self.mesh is None:
            return x
        return shard_batch(self.mesh, x, axis)

    def _gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The global batch of a per-rank block along ``axis``; ``x``
        itself without a mesh."""
        if self.mesh is None:
            return x
        return all_gather_batch(self.mesh, x, axis)

    def _gather_pairs(self, metrics: Dict[str, torch.Tensor],
                      axis: int) -> Dict[str, torch.Tensor]:
        for k in PER_PAIR:
            if k in metrics:
                metrics[k] = self._gather(metrics[k], axis)
        return metrics

    def _loss(self, batch: Mapping[str, torch.Tensor], valid: torch.Tensor,
              train: bool, spans=(tracing.EVAL_FORWARD, tracing.EVAL_LOSS)):
        """(loss, per-pair losses, depth) of one batch; ``train`` picks
        train-mode BN (batch statistics, running-stat update), ``spans``
        names the forward's and the loss's spans."""
        with tracing.span(spans[0]):
            depth = self.model.apply(batch["images"],
                                     scales=batch.get("scales"), train=train)
        with tracing.span(spans[1]):
            loss, batch_losses = joint_loss(
                depth, batch["intrinsics"], batch["extrinsics"],
                batch["flows"], batch["masks"], self.weights,
                params=self.params, params_init=self.params_init,
                valid=valid, mesh=self.mesh)
        return loss, batch_losses, depth

    # -- training ---------------------------------------------------------
    def _step(self, data: Mapping[str, torch.Tensor], idx: torch.Tensor,
              valid: torch.Tensor):
        """One optimizer step on device index tensors; returns its metrics
        and the batch's depth (B, 2, H, W), all on the device."""
        with tracing.span(tracing.STEP, self.step):
            with tracing.span(tracing.STEP_GATHER):
                batch = gather_batch(data, idx)
            if self.mesh is None:
                self.optimizer.zero_grad(set_to_none=True)
            else:
                # the backward accumulates into the views of the flat buffer
                self._grad_flat.zero_()
                for p, g in zip(self.params.values(), self._grad_views):
                    p.grad = g
            loss, batch_losses, depth = self._loss(
                batch, valid, train=True,
                spans=(tracing.STEP_FORWARD, tracing.STEP_LOSS))
            with tracing.span(tracing.STEP_BACKWARD):
                loss.backward()
            if self.mesh is not None:
                dist.all_reduce(self._grad_flat, group=self.mesh.group)
            with tracing.span(tracing.STEP_OPTIMIZER):
                # a parameter outside the forward (MiDaS's
                # refinenet4.resConfUnit1) gets an exact zero gradient, as
                # JAX gives it: the optimizers then treat it as optax does
                # (Adam leaves it, AdamW still decays it) where a None
                # gradient would make them skip it (under a mesh the flat
                # buffer holds its zeros)
                for p in self.params.values():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                # skip on a non-finite loss AND on non-finite gradients: a
                # finite loss can still carry 0*inf gradients through the
                # 1/z backward at degenerate depths. One multi-tensor pass
                # over the gradients (the check of torch.amp's GradScaler,
                # at scale 1, which leaves every finite value as it is)
                # sets ``found`` to 1 on any NaN/inf; the fused optimizer
                # then skips its update where it is 1.
                grads = [p.grad for p in self.params.values()]
                found = torch.zeros((), device=loss.device)
                torch._amp_foreach_non_finite_check_and_unscale_(
                    grads, found, torch.ones((), device=loss.device))
                found = torch.maximum(
                    found, (~torch.isfinite(loss.detach())).float())
                self.optimizer.grad_scale = None
                self.optimizer.found_inf = found
                self.optimizer.step()
                # the flag's kernel, after the update's, closes the span's
                # device-side range past the update (whose kernels run in
                # torch's own Optimizer.step range)
                skipped = found > 0
            self.step += 1
            metrics = {"loss": loss.detach(), "skipped_nan": skipped,
                       **{k: v.detach() for k, v in batch_losses.items()}}
            return metrics, depth.detach()

    def train_step(self, data: Mapping[str, torch.Tensor], idx,
                   valid) -> Dict[str, torch.Tensor]:
        """One optimizer step on pairs ``idx`` (B,) of the resident
        ``data``, ``valid`` (B,) marking real (1) and padding (0) pairs.
        Returns device tensors: ``loss``, ``skipped_nan``, and the per-pair
        ``reprojection`` and ``disparity`` losses."""
        self._policy()
        idx, valid = self._indices(idx, valid)
        metrics, _ = self._step(data, self._shard(idx, 0),
                                self._shard(valid, 0))
        return self._gather_pairs(metrics, 0)

    def train_epoch(self, data: Mapping[str, torch.Tensor], idx, valid,
                    capture_slot=None) -> Dict[str, torch.Tensor]:
        """Queue all steps of an epoch (JAX engine :250-290, a
        ``lax.scan`` there).

        Args:
            idx, valid: (steps, batch) host arrays, uploaded once
            capture_slot: optional (steps,) host ints; where >= 0 the
                step's predicted depths are copied into slot
                ``capture_slot[s]`` of ``captured_depth``, so that the
                display-frequency image grids get the training forward's
                prediction without another forward (reference
                depth_fine_tuning.py:290-293). Slots >= CAPTURE_SLOTS are
                dropped.
        Returns:
            the metrics stacked over steps, on the device: ``loss`` (S,),
            ``skipped_nan`` (S,), ``reprojection`` / ``disparity`` (S, B),
            and ``captured_depth`` (CAPTURE_SLOTS, B, 2, H, W), f16 under
            bf16 and f32 otherwise.
        """
        with tracing.span(tracing.TRAIN_EPOCH):
            self._policy()
            idx_t, valid_t = self._indices(idx, valid)
            S, B = idx_t.shape
            H, W = data["frames"].shape[1:3]
            cap = torch.zeros((self.CAPTURE_SLOTS, B, 2, H, W),
                              dtype=self._dump_dtype,
                              device=self.model.device)
            idx_r, valid_r = self._shard(idx_t, 1), self._shard(valid_t, 1)
            per_step = []
            for s in range(S):
                metrics, depth = self._step(data, idx_r[s], valid_r[s])
                slot = -1 if capture_slot is None else int(capture_slot[s])
                if 0 <= slot < self.CAPTURE_SLOTS:
                    cap[slot].copy_(self._gather(depth.to(cap.dtype)))
                per_step.append(metrics)
            out = self._gather_pairs(_stack(per_step), 1)
            out["captured_depth"] = cap
            return out

    # -- validation -------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, data: Mapping[str, torch.Tensor], idx,
                  valid) -> Dict[str, torch.Tensor]:
        """Validation pass on one batch: train-mode BN with running-stat
        updates and no gradient step (torch no_grad in train() mode,
        reference depth_fine_tuning.py:246-257, 312-341)."""
        self._policy()
        idx, valid = self._indices(idx, valid)
        m = self._eval_batch(data, self._shard(idx, 0), self._shard(valid, 0))
        m["depth"] = self._gather(m["depth"])
        m["pair_ids"] = data["pair_ids"][idx]
        return self._gather_pairs(m, 0)

    def _eval_batch(self, data, idx, valid):
        batch = gather_batch(data, idx)
        loss, batch_losses, depth = self._loss(batch, valid, train=True)
        return {"loss": loss, "depth": depth, "pair_ids": batch["pair_ids"],
                **batch_losses}

    @torch.no_grad()
    def eval_epoch(self, data: Mapping[str, torch.Tensor], idx,
                   valid) -> Dict[str, torch.Tensor]:
        """Queue the whole eval pass: the paired pass (the default in f32)
        or, with ``eval_dedup``, the deduplicated one.

        Args:
            idx, valid: (steps, batch) host arrays
        Returns:
            device metrics: per-step ``loss`` (S,), ``pair_ids`` (S, B, 2),
            ``reprojection`` / ``disparity`` (S, B), plus ``depth_frames``
            (num_frames, H, W), f16 under bf16, and ``frames_seen``
            (num_frames,).
        """
        with tracing.span(tracing.EVAL_EPOCH):
            self._policy()
            idx_t, valid_t = self._indices(idx, valid)
            if self.eval_dedup:
                return self._eval_epoch_dedup(data, idx_t, valid_t)
            return self._eval_epoch_paired(data, idx_t, valid_t)

    def _eval_epoch_paired(self, data, idx, valid):
        """The reference's validation loop (JAX engine :292-338): a
        train-mode forward per pair batch, the BN running stats threading
        through (the padding duplicates of the last batch included), each
        frame's depth kept once, first seen wins.

        The JAX pass writes a batch's depths one by one; here one indexed
        copy writes them all, so each slot's first valid occurrence in the
        batch is found first (a (2B, 2B) comparison of the batch's slots):
        a frame that appears twice in one batch is written once, from its
        first side. Every other row goes to a dump row past the frames.
        Under a mesh each batch's depths are gathered first, so the rule
        sees the global batch order."""
        n_frames, H, W = data["frames"].shape[:3]
        dev = self.model.device
        buf = torch.zeros((n_frames + 1, H, W), dtype=self._dump_dtype,
                          device=dev)
        seen = torch.zeros((n_frames + 1,), dtype=torch.bool, device=dev)
        n = 2 * idx.shape[1]
        order = torch.arange(n, device=dev)
        earlier = order[None, :] < order[:, None]        # [i, j]: j before i
        idx_r, valid_r = self._shard(idx, 1), self._shard(valid, 1)
        per_step = []
        for s in range(idx.shape[0]):
            with tracing.span(tracing.EVAL_BATCH):
                m = self._eval_batch(data, idx_r[s], valid_r[s])
                m["pair_ids"] = data["pair_ids"][idx[s]]
                flat = self._gather(m.pop("depth").to(buf.dtype)).reshape(
                    n, H, W)
                with tracing.span(tracing.EVAL_DEPTH_SCATTER):
                    slots = data["pair_slots"][idx[s]].reshape(n).long()
                    ok = (valid[s] > 0)[:, None].expand(-1, 2).reshape(n)
                    repeated = ((slots[:, None] == slots[None, :]) & earlier
                                & ok[None, :]).any(1)
                    take = ok & ~repeated & ~seen[slots]
                    buf.index_copy_(0, torch.where(take, slots, n_frames),
                                    flat)
                    seen.index_fill_(0, torch.where(ok, slots, n_frames),
                                     True)
                per_step.append(m)
        out = self._gather_pairs(_stack(per_step), 1)
        out["depth_frames"] = buf[:n_frames]
        out["frames_seen"] = seen[:n_frames]
        return out

    def _eval_epoch_dedup(self, data, idx, valid):
        """Deduplicated eval pass (JAX engine :340-437): each resident
        frame forwarded once, then every pair's loss joined against the
        resulting depth buffer.

        phase 1: train-mode forwards of (fsteps, B, 2) frame chunks, shaped
            like the pair batches so that the backbone sees the train
            step's conv shapes (BN stats thread through); the padding
            entries point at the dump row ``n_frames``, and the image
            gather is clamped to the last frame;
        phase 2: the loss alone over the pair batches, depths gathered from
            the buffer.

        Contract deviations from the paired pass (both harmless for
        consumers that gate on ``frames_seen``, as ``process_eval`` does):
        (a) ``depth_frames`` rows of frames in no valid pair carry real
        depths here (the paired pass leaves them zero); (b) the BN running
        stats are updated from every resident frame, frames in no pair and
        the clamped padding duplicates included, not only pair frames.

        Under a mesh the frame chunks and the pair batches are sharded over
        their batch axis, as the JAX pass's ``P(None, "data", None)``; each
        rank writes its frames' rows, and one sum all-reduce of the buffer
        (each frame's row written by one rank, zeros elsewhere) gives every
        rank all of them."""
        n_frames, H, W = data["frames"].shape[:3]
        dev = self.model.device
        S, B = idx.shape
        per = 2 * B
        fsteps = max(1, -(-n_frames // per))
        fslots = np.full((fsteps * per,), n_frames, np.int64)
        fslots[:n_frames] = np.arange(n_frames)
        frame_idx = self._shard(
            self._upload(fslots.reshape(fsteps, B, 2), torch.long), 1)

        # per-frame scales recovered from the per-pair (P, 2) array: scales
        # are a per-frame quantity, the pair array only gathers them; frames
        # in no pair keep 1.0
        frame_scales = None
        if "scales" in data:
            frame_scales = torch.ones((n_frames + 1,), dtype=torch.float32,
                                      device=dev)
            frame_scales[data["pair_slots"].reshape(-1).long()] = \
                data["scales"].reshape(-1).float()

        buf = torch.zeros((n_frames + 1, H, W), dtype=torch.float32,
                          device=dev)
        for c in range(fsteps):
            slots = frame_idx[c]
            images = data["frames"][torch.clamp(slots, max=n_frames - 1)]
            scales = frame_scales[slots] if frame_scales is not None else None
            with tracing.span(tracing.EVAL_FORWARD):
                depth = self.model.apply(images, scales=scales, train=True)
            buf.index_copy_(0, slots.reshape(-1),
                            depth.float().reshape(slots.numel(), H, W))
        if self.mesh is not None:
            dist.all_reduce(buf, group=self.mesh.group)

        idx_r, valid_r = self._shard(idx, 1), self._shard(valid, 1)
        per_step = []
        for s in range(S):
            with tracing.span(tracing.EVAL_BATCH):
                i = idx_r[s]
                depth = buf[data["pair_slots"][i].long()]      # (B, 2, H, W)
                with tracing.span(tracing.EVAL_LOSS):
                    loss, batch_losses = joint_loss(
                        depth, data["intrinsics"][i], data["extrinsics"][i],
                        data["flows"][i], data["masks"][i], self.weights,
                        params=self.params, params_init=self.params_init,
                        valid=valid_r[s], mesh=self.mesh)
                per_step.append({"loss": loss,
                                 "pair_ids": data["pair_ids"][idx[s]],
                                 **batch_losses})
        out = self._gather_pairs(_stack(per_step), 1)
        # frames_seen: frames of any VALID pair, as the paired pass
        slots = data["pair_slots"][idx.reshape(-1)].reshape(-1).long()
        ok = (valid.reshape(-1) > 0)[:, None].expand(-1, 2).reshape(-1)
        seen = torch.zeros((n_frames + 1,), dtype=torch.bool, device=dev)
        seen.index_fill_(0, torch.where(ok, slots, n_frames), True)
        out["depth_frames"] = buf[:n_frames].to(self._dump_dtype)
        out["frames_seen"] = seen[:n_frames]
        return out

    # -- inference and state ----------------------------------------------
    @torch.no_grad()
    def infer(self, images) -> torch.Tensor:
        """Eval-mode inference (the save_depth path; BN uses the running
        stats, reference depth_fine_tuning.py:182-196): images (B, N, H, W,
        3), a host array or a tensor, -> depth (B, N, H, W) on the device."""
        self._policy()
        if not torch.is_tensor(images):
            images = self._upload(images, torch.float32)
        return self.model.apply(images, train=False)

    def variables_of(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` (parameters and BN running stats),
        cloned on the device: a snapshot that later steps, which update
        the live tensors in place, leave as it is."""
        return _clone(dict(self.model.net.state_dict()))

    def state_dict(self) -> Dict[str, Any]:
        """A device snapshot of the full training state: the model's and
        the optimizer's ``state_dict`` and ``step``."""
        return {"model": self.variables_of(),
                "optimizer": _clone(self.optimizer.state_dict()),
                "step": self.step}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Restore a state written by :meth:`state_dict` (on any device)."""
        self.model.net.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

