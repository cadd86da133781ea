"""Test-time fine-tuning driver: the port of
``consistent_depth_tpu/training/fine_tuning.py`` (reference:
depth_fine_tuning.py).

Same artifacts and directory contract as the reference and the JAX
package:

    {range_dir}/{tag}/checkpoints/{epoch:04d}.pth   torch-layout weights
    {range_dir}/{tag}/eval/loss_e{E}_iter{I}.json   per-pair losses
    {range_dir}/{tag}/eval/depth_{idx}_e..{I}.raw/.png
    {range_dir}/{tag}/depth/frame_{:06d}.raw (+ .png) via save_depth
    {range_dir}/{tag}/tensorboard/                  event files

plus, with ``--resume``, ``checkpoints/full_{epoch:04d}/state.pt``
(:mod:`.checkpoints`). The passes are
:class:`..training.engine.TrainingEngine`'s; this module is the host-side
orchestration. Everything that reads a device value (losses, skipped
steps, captured depths, eval buffers, checkpoints) runs in a deferred
``process()`` after the next epoch has been queued, so the host's writes
overlap the card's work, as in the JAX driver.

Data parallelism, as the JAX driver's: under a launcher that started more
than one rank (``torchrun --nproc_per_node N``) and with ``use_mesh`` (the
default), or with a mesh passed in, the engine runs over the mesh
(``..parallel.mesh``) and the batch size is multiplied by N after the tag
is made, so that the tag names the per-rank batch. Every rank runs the
same passes and collectives; rank 0 alone writes (checkpoints,
``state.pt``, the eval JSON and images, events, ``save_depth``), and the
others wait for it at a barrier before ``fine_tune`` returns. ``--resume``
loads rank 0's ``full_{epoch}/state.pt`` on every rank.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import time
from os.path import join as pjoin
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.video_dataset import (
    PairBatchIterator, VideoFrameDataset, VideoPairDataset)
from ..io import image_io
from ..models import torch_import
from ..models.registry import get_depth_model
from ..ops.losses import LossWeights
from ..parallel.mesh import Mesh, launched_mesh
from ..utils import visualization
from . import checkpoints as ckpt
from . import optimizer as optimizer_registry
from .engine import TrainingEngine, gather_batch
from .summaries import SummaryWriter, make_image_grid


class LossParams:
    """Loss flags (reference: loss/loss_params.py)."""

    @staticmethod
    def add_arguments(parser):
        parser.add_argument("--lambda_view_baseline", type=float, default=-1,
                            help="Disparity-difference weight; <0 resolves"
                                 " to the model default.")
        parser.add_argument("--lambda_reprojection", type=float, default=1.0)
        parser.add_argument("--lambda_parameter", type=float, default=0)
        return parser

    @staticmethod
    def make_str(opt) -> str:
        return (f"B{opt.lambda_view_baseline}"
                f"_R{opt.lambda_reprojection}"
                f"_PL1-{opt.lambda_parameter}")


class DepthFineTuningParams:
    """Fine-tuning flags (reference: depth_fine_tuning.py:28-63)."""

    @staticmethod
    def add_arguments(parser):
        parser = LossParams.add_arguments(parser)
        parser.add_argument("--optimizer", default="Adam",
                            choices=optimizer_registry.OPTIMIZER_NAMES)
        parser.add_argument("--val_epoch_freq", type=int, default=1)
        parser.add_argument("--learning_rate", type=float, default=0,
                            help="<=0 resolves to the model default")
        parser.add_argument("--batch_size", type=int, default=4)
        parser.add_argument("--num_epochs", type=int, default=20)
        parser.add_argument("--log_dir")
        parser.add_argument("--display_freq", type=int, default=100)
        parser.add_argument("--print_freq", type=int, default=1)
        parser.add_argument("--save_epoch_freq", type=int, default=1)
        # beyond-reference: full-state resume + profiling
        parser.add_argument(
            "--resume", action="store_true",
            help="Resume fine-tuning from the latest full-state "
                 "checkpoint (params + optimizer state + epoch); the "
                 "reference always restarts from epoch 0.")
        parser.add_argument(
            "--profile_dir", default=None,
            help="If set, write a torch.profiler trace of the first epoch "
                 "into this directory.")
        parser.add_argument(
            "--precision", choices=["f32", "bf16"], default="f32",
            help="Backbone conv compute dtype. f32 matches the "
                 "reference numerics; bf16 computes the backbone in bf16 "
                 "(params, BN statistics, and the loss stay f32 either "
                 "way).")
        return parser


def make_tag(params) -> str:
    return (LossParams.make_str(params)
            + f"_LR{params.learning_rate}"
            + f"_BS{params.batch_size}"
            + f"_O{params.optimizer.lower()}")


def log_loss_stats(writer, name_prefix: str,
                   loss_meta: Dict[str, np.ndarray], n: int,
                   log_histogram: bool = False):
    for sub_loss_name, loss_value in loss_meta.items():
        full = f"{name_prefix}/{sub_loss_name}"
        v = np.asarray(loss_value)
        writer.add_scalar(full + "/max", v.max(), n)
        writer.add_scalar(full + "/min", v.min(), n)
        writer.add_scalar(full + "/mean", v.mean(), n)
        if log_histogram:
            writer.add_histogram(full, v, n)


def capture_slots(valids, total_iters: int, display_freq: int,
                  n_slots: int) -> np.ndarray:
    """Which steps of an epoch keep their training depths for the image
    grids: the step after which the count of pairs seen, starting from
    ``total_iters``, is a multiple of ``display_freq`` gets the next slot,
    up to ``n_slots``. ``valids`` holds each step's (B,) valid mask.
    Returns (steps,) int32, -1 for no capture."""
    slots = np.full(len(valids), -1, np.int32)
    running, slot = total_iters, 0
    for s, valid in enumerate(valids):
        running += int(valid.sum())
        if running % display_freq == 0 and slot < n_slots:
            slots[s] = slot
            slot += 1
    return slots


def eval_batches(num_pairs: int, batch_size: int):
    """The eval pass's (steps, batch) pair indices and valid mask: every
    pair once, in order, the last batch padded by repeating pair N-1 with
    valid 0 (its train-mode forward still moves the BN running stats, as in
    the reference)."""
    steps = (num_pairs + batch_size - 1) // batch_size
    flat = np.arange(steps * batch_size)
    idx = np.minimum(flat, num_pairs - 1).astype(np.int32).reshape(
        steps, batch_size)
    valid = (flat < num_pairs).astype(np.float32).reshape(steps, batch_size)
    return idx, valid


def _fetch(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in metrics.items()}


class DepthFineTuner:
    def __init__(self, range_dir: str, frames: List[int], params,
                 device="cuda", mesh: Optional[Mesh] = None):
        """``device`` is the card unless the caller asks for the CPU;
        without a CUDA device the default raises. ``mesh``: the data mesh,
        by default one over the launcher's ranks when it started more
        than one (and ``params.use_mesh`` is not False); under a mesh the
        device is the mesh's."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DepthFineTuner runs on the card and no CUDA device is "
                "available; pass device='cpu' to fine-tune on the CPU")
        if mesh is None and getattr(params, "use_mesh", True):
            mesh = launched_mesh(device)
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        # the rank that writes the artifacts
        self.writes = mesh is None or mesh.rank == 0
        self.frames = frames
        self.params = params
        self.base_dir = params.path
        self.range_dir = range_dir
        self.out_dir = pjoin(range_dir, make_tag(params))
        os.makedirs(self.out_dir, exist_ok=True)
        print(f"Fine-tuning directory: '{self.out_dir}'")
        self.checkpoints_dir = pjoin(self.out_dir, "checkpoints")
        os.makedirs(self.checkpoints_dir, exist_ok=True)

        model_cls = get_depth_model(params.model_type)
        checkpoint = getattr(params, "model_checkpoint", None)
        self.model = model_cls(checkpoint=checkpoint, device=device)

        # the reference's GPU-count batch scaling
        # (depth_fine_tuning.py:155-159), after the tag is made
        if mesh is not None and mesh.size > 1:
            print(f"Using {mesh.size} devices.")
            self.params.batch_size *= mesh.size
            print(f"Adjusting batch size to {self.params.batch_size}.")

        self.weights = LossWeights(
            lambda_view_baseline=params.lambda_view_baseline,
            lambda_reprojection=params.lambda_reprojection,
            lambda_parameter=params.lambda_parameter,
        )
        tx = optimizer_registry.create(
            params.optimizer, params.learning_rate, betas=(0.9, 0.999))
        self.engine = TrainingEngine(
            self.model, tx, self.weights,
            precision=getattr(params, "precision", "f32"), mesh=mesh)
        self.vis_depth_scale: Optional[float] = None
        # host wall seconds of each epoch (as printed) and of each eval
        # pass (its queueing plus its processing)
        self.epoch_seconds: List[float] = []
        self.eval_seconds: List[float] = []

    # ------------------------------------------------------------------
    def save_depth(self, dir: str = None, frames=None,  # noqa: A002
                   batch_size: int = 4):
        """Run eval-mode inference on every frame; write inverse depth
        .raw + global-range visualizations
        (reference: depth_fine_tuning.py:164-199). Under a mesh rank 0
        alone runs it: ``infer`` runs no collective."""
        if not self.writes:
            return
        if dir is None:
            dir = self.out_dir  # noqa: A001
        if frames is None:
            frames = self.frames

        color_fmt = pjoin(self.base_dir, "color_down", "frame_{:06d}.raw")
        depth_dir = pjoin(dir, "depth")
        depth_fmt = pjoin(depth_dir, "frame_{:06d}")
        dataset = VideoFrameDataset(color_fmt, frames)
        os.makedirs(depth_dir, exist_ok=True)

        def flush(pending):
            depth, ids = pending
            depth = depth.float().cpu().numpy()[:, 0]
            for d, frame_id in zip(depth, ids):
                image_io.save_raw_float32_image(
                    depth_fmt.format(frame_id) + ".raw", 1.0 / d)

        # dispatch-ahead: batch k+1's host load + device infer overlap
        # batch k's result fetch and .raw writes
        pending = None
        for start in range(0, len(dataset), batch_size):
            indices = list(range(start, min(start + batch_size, len(dataset))))
            images, ids = dataset.load_batch(indices)
            pad = batch_size - len(indices)
            if pad:
                images = np.concatenate(
                    [images, np.repeat(images[-1:], pad, axis=0)])
            depth = self.engine.infer(images[:, None])  # (B, 1, H, W)
            if pending is not None:
                flush(pending)
            pending = (depth, ids)
        if pending is not None:
            flush(pending)

        visualization.visualize_depth_dir(depth_dir, depth_dir, force=True)

    # ------------------------------------------------------------------
    def fine_tune(self, writer=None):
        meta_file = pjoin(self.range_dir, "metadata_scaled.npz")
        dataset = VideoPairDataset(self.base_dir, meta_file)
        data = dataset.load()
        dev_data = self.engine.put_data(data.__dict__)
        dev_data.pop("frame_ids", None)
        num_pairs = data.num_pairs
        B = self.params.batch_size

        own_writer = writer is None and self.writes
        if own_writer:
            log_dir = self.params.log_dir or pjoin(self.out_dir, "tensorboard")
            os.makedirs(log_dir, exist_ok=True)
            writer = SummaryWriter(log_dir=log_dir)
        if not self.writes:
            writer = None

        eval_dir = pjoin(self.out_dir, "eval")
        os.makedirs(eval_dir, exist_ok=True)

        def suffix(epoch, niters):
            return "_e{:04d}_iter{:06d}".format(epoch, niters)

        def dispatch_validate(epoch, niters):
            """Queue the eval pass now; return the host-side processing
            closure to run later (overlapped with the next epoch's device
            work)."""
            t0 = time.perf_counter()
            metrics, idx = self.dispatch_eval(dev_data, data)
            queued = time.perf_counter() - t0
            if not self.writes:
                return lambda: None

            def process():
                t1 = time.perf_counter()
                loss_meta = self.process_eval(
                    metrics, idx, data, suffix(epoch, niters))
                self.eval_seconds.append(queued + time.perf_counter() - t1)
                if writer is not None:
                    log_loss_stats(
                        writer, "validation", loss_meta, epoch,
                        log_histogram=True)
                print(f"Done Validation for epoch {epoch} "
                      f"({niters} iterations)")
            return process

        start_epoch = 0
        if getattr(self.params, "resume", False):
            latest = ckpt.latest_epoch_checkpoint(self.checkpoints_dir)
            if latest is not None:
                restored = ckpt.restore_full_state(latest[0], self.engine)
                if restored is not None:
                    start_epoch = restored
                    print(f"Resumed from {latest[0]} (epoch {start_epoch}).")

        self.vis_depth_scale = None

        # Host/device pipelining: each epoch's train (+eval) passes are
        # QUEUED before the previous epoch's host work (metric fetches,
        # prints, TB events, eval artifact writes, checkpoint export)
        # runs. ``pending`` holds the deferred host closures; at most one
        # epoch stays in flight.
        pending: List = []
        # steady-state epoch duration = delta between successive
        # deferred-processing completions (the fetch inside process()
        # waits behind the NEXT epoch's queued work, so "now - dispatch
        # time" would span two epochs)
        last_done = [time.perf_counter()]

        def run_pending(limit: int):
            while len(pending) > limit:
                pending.pop(0)()

        it = PairBatchIterator(
            num_pairs, B, shuffle=True, seed=getattr(self.params, "seed", 0))
        # the count of pairs seen: each epoch's valid pairs, so that a
        # resumed run names its evals and events as the uninterrupted one
        # (steps x B would count the padding of a ragged last batch)
        total_iters = start_epoch * num_pairs
        profile_dir = (getattr(self.params, "profile_dir", None)
                       if self.writes else None)
        # profiling wants a clean trace of one epoch: no overlap
        in_flight = 0 if profile_dir else 1
        prof = None

        if start_epoch == 0:
            pending.append(dispatch_validate(0, 0))

        for epoch in range(start_epoch, self.params.num_epochs):
            if profile_dir and epoch == start_epoch:
                run_pending(0)
                prof = _start_profiler(self.model.device)
            epoch_start_time = time.perf_counter()

            steps = list(it.epoch(epoch))
            idx_mat = np.stack([s[0] for s in steps])
            valid_mat = np.stack([s[1] for s in steps])

            # the steps that hit display_freq keep their training
            # predictions in the epoch (no extra forward); every rank of a
            # mesh captures the same steps, whose depths it gathers
            capture_slot = capture_slots(
                valid_mat, total_iters, self.params.display_freq,
                self.engine.CAPTURE_SLOTS)

            metrics = self.engine.train_epoch(
                dev_data, idx_mat, valid_mat, capture_slot)

            # the iteration counter advances deterministically, so the
            # whole epoch's host bookkeeping can be computed at dispatch
            # time and its value-dependent parts deferred
            iters_at = []
            for _, valid in steps:
                total_iters += int(valid.sum())
                iters_at.append(total_iters)

            val_proc = (
                dispatch_validate(epoch + 1, total_iters)
                if (epoch + 1) % self.params.val_epoch_freq == 0 else None)
            # the checkpoint is a device COPY of the state taken now: the
            # next epoch's steps update the live tensors in place before
            # the deferred export runs
            ckpt_state = (
                self.engine.state_dict()
                if (epoch + 1) % self.params.save_epoch_freq == 0
                and self.writes else None)

            def process(epoch=epoch, metrics=metrics, steps=steps,
                        capture_slot=capture_slot, iters_at=iters_at,
                        val_proc=val_proc, ckpt_state=ckpt_state,
                        t0=epoch_start_time):
                # fetch everything except the display-freq depth-capture
                # buffer (22 MB at demo size; sliced per used slot)
                small = _fetch({k: v for k, v in metrics.items()
                                if k != "captured_depth"})
                for s, (idx, valid) in enumerate(steps):
                    loss = float(small["loss"][s])
                    pairs = data.pair_ids[idx[valid > 0]].tolist()
                    print(f"Epoch = {epoch}, pairs = {pairs}, loss = {loss}")
                    if small["skipped_nan"][s]:
                        print("Loss is NaN. Skipping.")
                    n_iter = iters_at[s]
                    if (writer is not None
                            and n_iter % self.params.print_freq == 0):
                        writer.add_scalar("Train/loss", loss, n_iter)
                        log_loss_stats(
                            writer, "Train/loss",
                            {k: small[k][s]
                             for k in ("reprojection", "disparity")
                             if k in small},
                            n_iter)
                    if writer is not None and capture_slot[s] >= 0:
                        self._write_summary(
                            writer, dev_data, idx,
                            metrics["captured_depth"][capture_slot[s]]
                            .cpu().numpy(),
                            n_iter)
                now = time.perf_counter()
                took = now - max(t0, last_done[0])
                self.epoch_seconds.append(took)
                print(f"Epoch {epoch} took {took:.2f}s.")
                last_done[0] = now
                # the checkpoint export (fetch + serialize) is
                # independent of the eval artifacts, so it runs on a
                # worker thread under the eval writes
                ckpt_job = None
                if ckpt_state is not None:
                    def export_ckpt():
                        self.save_checkpoint(
                            pjoin(self.checkpoints_dir,
                                  f"{epoch + 1:04d}.pth"),
                            state=ckpt_state["model"])
                        if getattr(self.params, "resume", False):
                            ckpt.save_full_state(
                                pjoin(self.checkpoints_dir,
                                      f"full_{epoch + 1:04d}"),
                                ckpt_state, epoch + 1)
                    ckpt_job = concurrent.futures.ThreadPoolExecutor(1)
                    ckpt_fut = ckpt_job.submit(export_ckpt)
                # join the export even when val_proc raises: a leaked
                # worker thread would hide concurrent export failures
                try:
                    if val_proc is not None:
                        val_proc()
                finally:
                    if ckpt_job is not None:
                        ckpt_fut.result()
                        ckpt_job.shutdown()

            if self.writes:
                pending.append(process)
            run_pending(in_flight)

            if prof is not None and epoch == start_epoch:
                run_pending(0)
                _stop_profiler(prof, self.model.device, profile_dir)
                prof = None

        run_pending(0)
        if self.params.num_epochs % self.params.val_epoch_freq != 0:
            dispatch_validate(self.params.num_epochs, total_iters)()
        if own_writer:
            writer.close()
        if self.mesh is not None:
            self.mesh.barrier()
        print("Finished Training")

    def _write_summary(self, writer, dev_data, idx, depth, n_iter):
        """Image grids of inputs / predicted disparity / masks
        (reference: depth_fine_tuning.py:93-114). ``depth`` is the
        training forward's prediction captured in the epoch: no extra
        forward is paid here."""
        batch = gather_batch(dev_data, torch.as_tensor(
            np.asarray(idx), dtype=torch.long, device=self.model.device))
        images = batch["images"].cpu().numpy()
        masks = batch["masks"].cpu().numpy()
        imgs = images.reshape((-1,) + images.shape[2:])
        writer.add_image(
            "Train/image", make_image_grid(imgs, normalize=True), n_iter)
        inv_depth = 1.0 / np.asarray(depth).astype(np.float32)
        writer.add_image(
            "Train/pred_full",
            make_image_grid(
                inv_depth.reshape((-1,) + inv_depth.shape[2:] + (1,)),
                normalize=True),
            n_iter)
        writer.add_image(
            "Train/mask",
            make_image_grid(masks.reshape((-1,) + masks.shape[2:] + (1,))),
            n_iter)

    # ------------------------------------------------------------------
    def dispatch_eval(self, dev_data, data):
        """Queue the eval pass (``engine.eval_epoch``); the returned
        metrics are device tensors. Pair with :meth:`process_eval`:
        splitting the two lets the caller overlap the artifact fetch and
        host writes with the next training epoch's work (batches:
        :func:`eval_batches`)."""
        idx, valid = eval_batches(data.num_pairs, self.params.batch_size)
        metrics = self.engine.eval_epoch(dev_data, idx, valid)
        return metrics, idx

    def process_eval(self, metrics, idx, data, suf: str
                     ) -> Dict[str, np.ndarray]:
        """Fetch a queued eval's metrics and write the loss JSON, depth
        .raw/.png dumps, and console table."""
        N = data.num_pairs
        eval_dir = pjoin(self.out_dir, "eval")
        metrics = _fetch(metrics)

        all_pairs: List[List[int]] = data.pair_ids[:N].tolist()
        max_frame_index = int(data.pair_ids.max())
        loss_dict: Dict[str, Dict[str, float]] = {}
        for name in ("reprojection", "disparity"):
            losses = np.asarray(metrics[name]).reshape(-1)[:N]
            loss_dict[name] = {
                str(list(pair)): float(value)
                for pair, value in zip(all_pairs, losses)
            }

        # f16 under the engine's bf16 policy (engine.eval_epoch); the
        # .raw artifacts stay float32
        inv_frames = 1.0 / np.asarray(
            metrics["depth_frames"]).astype(np.float32)
        seen = np.asarray(metrics["frames_seen"])
        if self.vis_depth_scale is None:
            # fixed visualization range from the first batch, like the
            # reference (depth_fine_tuning.py:352-354)
            first_slots = np.unique(data.pair_slots[idx[0], :].reshape(-1))
            self.vis_depth_scale = float(inv_frames[first_slots].max())
        import cv2

        # the ~2N independent artifact writes run on a thread pool:
        # numpy/cv2 release the GIL for the colormap/encode work
        def write_frame(slot):
            index = int(data.frame_ids[slot])
            fn_pre = pjoin(eval_dir, f"depth_{index:06d}{suf}")
            image_io.save_raw_float32_image(fn_pre + ".raw", inv_frames[slot])
            vis = visualization.visualize_depth(
                inv_frames[slot], depth_min=0, depth_max=self.vis_depth_scale)
            cv2.imwrite(fn_pre + ".png", vis)

        slots = np.nonzero(seen)[0]
        if len(slots) > 1:
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                list(pool.map(write_frame, slots))
        else:
            for slot in slots:
                write_frame(slot)

        loss_meta = {
            name: np.array(list(values.values()))
            for name, values in loss_dict.items()
        }
        loss_dict["mean"] = {k: float(v.mean()) for k, v in loss_meta.items()}
        with open(pjoin(eval_dir, f"loss{suf}.json"), "w") as f:
            json.dump(loss_dict, f)

        self._print_eval_table(loss_dict, all_pairs, max_frame_index)
        return loss_meta

    @staticmethod
    def _print_eval_table(loss_dict, all_pairs, max_frame_index):
        index_width = int(math.ceil(math.log10(max(max_frame_index, 2))))
        loss_names = [k for k in loss_dict if k != "mean"]
        fmt = {}
        for name in loss_names:
            max_value = max(loss_dict[name].values())
            width = math.ceil(math.log10(max(max_value, 1.1)))
            fmt[name] = f"{width + 7}.6f"
        for pair in sorted(all_pairs):
            line = f"({pair[0]:{index_width}d}, {pair[1]:{index_width}d}): "
            line += ", ".join(
                f"{name}: {loss_dict[name][str(list(pair))]:{fmt[name]}}"
                for name in loss_names)
            print(line)
        print("Mean: " + " " * (2 * index_width) + ", ".join(
            f"{name}: {loss_dict['mean'][name]:{fmt[name]}}"
            for name in loss_names))

    # ------------------------------------------------------------------
    def save_checkpoint(self, file_name: str, state=None):
        """Write the model's weights (or ``state``, a ``state_dict``
        snapshot) as a torch-layout ``.pth``."""
        torch_import.save_checkpoint(
            file_name, self.engine.variables_of() if state is None else state)


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, profile_dir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(pjoin(profile_dir, "trace.json"))
