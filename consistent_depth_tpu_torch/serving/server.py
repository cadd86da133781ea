"""Batched multi-video depth serving: the port of
``consistent_depth_tpu/serving/server.py``.

- Frames from many videos share static ``(B, 1, H, W, 3)`` micro-batches,
  one bucket per resolution aligned to the backbone's ``align``; frames
  whose size is not aligned are edge-padded and the depth is cropped back.
- Dispatch is double-buffered: batch k+1 is enqueued on the device before
  batch k's result is fetched. Each padded batch goes host->device from
  pinned memory with ``non_blocking=True``; each result comes back
  device->host into a pinned buffer with ``non_blocking=True``, followed by
  a recorded ``torch.cuda.Event``. Fetching a result waits on its event.
  Both pinned buffers are held by the in-flight record until then.
- Under ``precision="bf16"`` the network and images are bf16 (the kernels
  accumulate in f32) and the depth travels as f16; under ``"f32"`` it is
  f32 throughout, with TF32 turned off for cuDNN and matmuls.
- With ``ServeConfig.mesh`` (``..parallel.mesh``), as the JAX server's
  sharded programs: every rank receives the same request stream, the
  weights are rank 0's, each rank computes its block of every micro-batch
  (the batch size must be a multiple of the mesh size) and the depths are
  gathered, so every rank yields the same results in the same order.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.registry import create_depth_model
from ..parallel.mesh import (
    Mesh, all_gather_batch, put_replicated, shard_batch)

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@dataclass
class ServeConfig:
    """Configuration for a :class:`DepthServer`."""

    model_type: str = "mc"
    checkpoint: Optional[str] = None
    precision: str = "bf16"
    batch_size: int = 8
    # latency bound for ragged streams: flush a partially-filled
    # resolution bucket (padded) once this many requests for OTHER
    # buckets have arrived since it last grew. None = only flush full
    # buckets / end of stream (max throughput, unbounded latency).
    flush_max_wait: Optional[int] = None
    # dispatch pipeline depth: how many micro-batches may be in flight
    # before the oldest result is fetched. 1 = double buffering.
    max_in_flight: int = 1
    device: str = "cuda"
    # the data mesh; under it the device is the mesh's
    mesh: Optional[Mesh] = None
    # extra kwargs forwarded to the backbone constructor
    model_kwargs: Dict[str, Any] = field(default_factory=dict)


def _align_up(x: int, align: int) -> int:
    return -(-x // align) * align


@dataclass
class _Flight:
    """One dispatched micro-batch: its result buffer, the event recorded
    after the device->host copy, and the pinned input kept alive until
    that event has fired."""

    host_in: torch.Tensor
    host_out: torch.Tensor
    event: Optional[torch.cuda.Event]
    keys: List[Any]
    sizes: List[Tuple[int, int]]

    def fetch(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host_out.numpy().astype(np.float32)[:, 0]


class DepthServer:
    """Serves eval-mode depth inference for a stream of frames that may
    come from many different videos (and resolutions) at once."""

    def __init__(self, config: ServeConfig, model: Optional[Any] = None):
        if config.precision not in _DTYPES:
            raise ValueError(f"precision must be one of {sorted(_DTYPES)}")
        self.config = config
        self.mesh = config.mesh
        if self.mesh is not None and config.batch_size % self.mesh.size:
            raise ValueError(
                f"batch_size {config.batch_size} does not split over the "
                f"mesh's {self.mesh.size} ranks")
        self.device = torch.device(
            config.device if self.mesh is None else self.mesh.device)
        dtype = _DTYPES[config.precision]
        if config.precision == "f32" and self.device.type == "cuda":
            # f32 means f32: no TF32 in cuDNN convs or matmuls
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if model is None:
            model = create_depth_model(
                config.model_type, checkpoint=config.checkpoint,
                device=self.device, dtype=dtype, **config.model_kwargs)
        else:
            model.to(self.device, dtype)
        if self.mesh is not None:
            put_replicated(self.mesh, model.net.state_dict().values())
        self.model = model
        self.align = model.align
        # the host-bound depth travels as f16 under bf16 (same convention
        # as the JAX server)
        self._out_dtype = (torch.float16 if config.precision == "bf16"
                           else torch.float32)
        self._pin = self.device.type == "cuda"

    def _bucket_of(self, h: int, w: int) -> Tuple[int, int]:
        return _align_up(h, self.align), _align_up(w, self.align)

    def _dispatch(self, frames: List[np.ndarray], bucket: Tuple[int, int],
                  keys: List[Any]) -> _Flight:
        """Pad ``frames`` (each (h, w, 3)) to the bucket shape and the
        static batch size, and enqueue the forward and the copy back.
        Returns without waiting for the device."""
        B = self.config.batch_size
        bh, bw = bucket
        host_in = torch.zeros((B, 1, bh, bw, 3), dtype=torch.float32,
                              pin_memory=self._pin)
        batch = host_in.numpy()
        for i, f in enumerate(frames):
            h, w = f.shape[:2]
            batch[i, 0, :h, :w] = f
            # edge-pad so the conv receptive fields at the crop border
            # see plausible content rather than zeros
            if h < bh:
                batch[i, 0, h:] = batch[i, 0, h - 1:h]
            if w < bw:
                batch[i, 0, :, w:] = batch[i, 0, :, w - 1:w]
        rows = host_in if self.mesh is None else shard_batch(self.mesh,
                                                             host_in)
        with torch.inference_mode():
            images = rows.to(self.device, non_blocking=True)
            depth = self.model.apply(images).to(self._out_dtype)
            if self.mesh is not None:
                depth = all_gather_batch(self.mesh, depth)
            if self._pin:
                host_out = torch.empty(depth.shape, dtype=depth.dtype,
                                       pin_memory=True)
                host_out.copy_(depth, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host_out, event = depth, None
        return _Flight(host_in, host_out, event, keys,
                       [f.shape[:2] for f in frames])

    # -- synchronous batched API ---------------------------------------
    def infer_frames(self, frames: np.ndarray) -> np.ndarray:
        """Eval-mode depth for ``frames`` (N, H, W, 3) BGR [0, 1] ->
        (N, H, W) depth."""
        results = [
            d for _, d in self.serve(
                ((i, f) for i, f in enumerate(np.asarray(frames))))
        ]
        return np.stack(results)

    # -- streaming multi-video API -------------------------------------
    def serve(self, requests: Iterable[Tuple[Any, np.ndarray]],
              ) -> Iterator[Tuple[Any, np.ndarray]]:
        """Serve a stream of ``(key, frame)`` requests, yielding
        ``(key, depth)`` as micro-batches complete.

        Frames are grouped into per-resolution buckets; a bucket is
        flushed when it reaches the static batch size, when it has waited
        ``config.flush_max_wait`` foreign requests, and at end of stream.
        Order within a bucket is preserved; across buckets results arrive
        in flush order. Up to ``config.max_in_flight`` micro-batches stay
        in flight before the oldest is fetched.
        """
        pending: Dict[Tuple[int, int], List[Tuple[Any, np.ndarray]]] = {}
        # requests seen at the time the bucket last grew (staleness probe)
        last_grew: Dict[Tuple[int, int], int] = {}
        in_flight: deque = deque()
        n_seen = 0
        max_if = max(1, self.config.max_in_flight)

        def launch(bucket) -> Optional[_Flight]:
            group = pending.pop(bucket)
            last_grew.pop(bucket, None)
            in_flight.append(self._dispatch(
                [f for _, f in group], bucket, [k for k, _ in group]))
            if len(in_flight) > max_if:
                return in_flight.popleft()
            return None

        def fetch(flight: _Flight):
            depth = flight.fetch()
            for i, (key, (h, w)) in enumerate(zip(flight.keys, flight.sizes)):
                yield key, depth[i, :h, :w]

        wait = self.config.flush_max_wait
        for key, frame in requests:
            frame = np.asarray(frame, np.float32)
            bucket = self._bucket_of(*frame.shape[:2])
            pending.setdefault(bucket, []).append((key, frame))
            n_seen += 1
            last_grew[bucket] = n_seen
            if len(pending[bucket]) == self.config.batch_size:
                done = launch(bucket)
                if done is not None:
                    yield from fetch(done)
            if wait is not None:
                stale = [b for b, at in last_grew.items()
                         if n_seen - at >= wait]
                for b in stale:
                    done = launch(b)
                    if done is not None:
                        yield from fetch(done)
        for bucket in sorted(pending):
            done = launch(bucket)
            if done is not None:
                yield from fetch(done)
        while in_flight:
            yield from fetch(in_flight.popleft())

    # -- convenience ----------------------------------------------------
    def infer_videos(self, videos: Dict[Any, np.ndarray],
                     ) -> Dict[Any, np.ndarray]:
        """Serve whole videos at once: ``{video_id: (N, H, W, 3)}`` ->
        ``{video_id: (N, H, W)}``. Frames of all videos are interleaved
        into shared batches."""

        def gen():
            iters = {
                vid: enumerate(np.asarray(v)) for vid, v in videos.items()
            }
            while iters:
                for vid in list(iters):
                    try:
                        i, frame = next(iters[vid])
                        yield (vid, i), frame
                    except StopIteration:
                        del iters[vid]

        out = {
            vid: np.zeros(np.asarray(v).shape[:3], np.float32)
            for vid, v in videos.items()
        }
        for (vid, i), depth in self.serve(gen()):
            out[vid][i] = depth
        return out
