"""Optical-flow stage: the port of
``consistent_depth_tpu/pipeline/flow_stage.py`` (reference: flow.py), with
the same files and formats.

Responsibilities: compute or import per-pair flow, derive validity masks
(batched on the device), filter pairs by mask overlap, write debug
visualisations. Device work is torch on ``device``; each chunk goes up
from pinned host memory with ``non_blocking=True`` and comes back into
pinned buffers followed by a recorded CUDA event, so the host reads chunk
k+1 and writes chunk k-1's PNGs while the device computes chunk k.
"""

from __future__ import annotations

import json
import os
from os.path import join as pjoin
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..flow.backends import create_flow_backend
from ..io import image_io
from ..ops import consistency
from ..ops.flow_viz import flow_to_image_torch
from ..ops.geometry import pixel_grid
from ..ops.resample import sample_uv


class _Fetch:
    """Device results on their way to the host: copies into pinned
    buffers and an event recorded after them (on a CUDA device), holding
    the chunk's inputs alive until then."""

    def __init__(self, outs: Sequence[torch.Tensor], inputs=()):
        self.inputs = inputs
        self.event = None
        if outs and outs[0].device.type == "cuda":
            self.host = []
            for t in outs:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(outs)

    def result(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def _upload(arrays: Sequence[np.ndarray], device: torch.device):
    """Host arrays -> device tensors (through pinned memory on CUDA)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out.append(t)
    return out


def _render(flows, colors, masks, warp: bool):
    """Panels (and warped frames) for a chunk of pairs, uint8.

    flows/colors/masks: (B, 2, H, W, {2, 3, 1}); colours 0..255."""
    B, _, H, W = flows.shape[:4]
    flow_ims = flow_to_image_torch(
        flows.reshape(B * 2, H, W, 2)).reshape(B, 2, H, W, 3)
    green = torch.tensor([0.0, 255.0, 0.0], device=flows.device)
    dropped = (masks <= 0).float()          # (B, 2, H, W, 1)

    def overlay(im, d):
        return 0.7 * im + 0.3 * (dropped[:, d] * green)

    # panel layout matches the reference: top row originals, bottom row
    # mask overlays; columns [color_i, color_j, flow_ij, flow_ji]; mask_ij
    # applies to color_i/flow_ij
    original = torch.cat(
        [colors[:, 0], colors[:, 1], flow_ims[:, 0], flow_ims[:, 1]], dim=2)
    masked = torch.cat(
        [overlay(colors[:, 0], 0), overlay(colors[:, 1], 1),
         overlay(flow_ims[:, 0], 0), overlay(flow_ims[:, 1], 1)], dim=2)
    panel = torch.cat([original, masked], dim=1)

    def to_u8(x):
        return torch.clamp(x, 0, 255).to(torch.uint8)

    if not warp:
        return (to_u8(panel),)
    uv = pixel_grid((H, W), device=flows.device) + flows.reshape(
        B * 2, H, W, 2)
    src = torch.stack([colors[:, 1], colors[:, 0]], dim=1)
    warped = sample_uv(src.reshape(B * 2, H, W, 3), uv)
    return to_u8(panel), to_u8(warped)


class Flow:
    def __init__(self, path: str, out_path: str, device="cuda"):
        self.path = path
        self.out_path = out_path
        self.device = torch.device(device)

    @staticmethod
    def max_size() -> int:
        return 1024

    # ------------------------------------------------------------------
    def check_flow_files(self, index_pairs) -> bool:
        flow_dir = pjoin(self.path, "flow")
        return all(
            os.path.exists(pjoin(flow_dir, f"flow_{i:06d}_{j:06d}.raw"))
            for (i, j) in index_pairs
        )

    def compute_flow(self, index_pairs, checkpoint: str = "FlowNet2") -> None:
        """Compute (or verify precomputed) flow for every pair
        (reference: flow.py:96-145)."""
        os.makedirs(pjoin(self.path, "flow"), exist_ok=True)
        if self.check_flow_files(index_pairs):
            return

        tmp = image_io.load_raw_float32_image(
            pjoin(self.path, "color_down", "frame_{:06d}.raw".format(0)))
        size = tmp.shape[:2][::-1]
        print("Resizing flow to", size)

        backend = create_flow_backend(checkpoint, device=self.device)
        missing = [p for p in index_pairs if not self.check_flow_files([p])]
        backend.process_pairs(
            frame_dir=pjoin(self.path, "color_flow"),
            pairs=missing,
            out_fmt=pjoin(self.path, "flow", "flow_{:06d}_{:06d}.raw"),
            out_size=size,
        )
        if not self.check_flow_files(index_pairs):
            raise RuntimeError(
                "Flow files still missing after backend run. Provide "
                "precomputed flow/ files or a supported flow backend.")

    # ------------------------------------------------------------------
    def mask_valid_correspondences(
        self, flow_thresh: float = 1.0, color_thresh: float = 1.0,
        batch_pairs: int = 16,
    ) -> None:
        """Masks for every flow pair, both directions at once, in device
        batches of ``batch_pairs`` pairs (reference: flow.py:199-228 loops
        pairs on the host)."""
        import cv2

        flow_fmt = pjoin(self.path, "flow", "flow_{:06d}_{:06d}.raw")
        mask_fmt = pjoin(self.path, "mask", "mask_{:06d}_{:06d}.png")
        color_fmt = pjoin(self.path, "color_down", "frame_{:06d}.raw")

        os.makedirs(os.path.dirname(mask_fmt), exist_ok=True)
        todo: List[List[int]] = []
        for name in os.listdir(os.path.dirname(flow_fmt)):
            indices = [int(s) for s in
                       os.path.splitext(name)[0].split("_")[1:]]
            if os.path.isfile(mask_fmt.format(*indices)):
                continue
            if indices[::-1] in todo:
                continue
            todo.append(indices)

        def write_out(chunk, fetch):
            (masks,) = fetch.result()
            for pair, mask_pair in zip(chunk, masks):
                for idxs, mask in zip((pair, pair[::-1]), mask_pair):
                    cv2.imwrite(mask_fmt.format(*idxs),
                                mask.astype(np.uint8) * 255)

        pending = None
        for start in range(0, len(todo), batch_pairs):
            chunk = todo[start:start + batch_pairs]
            flows = np.stack([
                np.stack([
                    image_io.load_raw_float32_image(flow_fmt.format(*idxs))
                    for idxs in (pair, pair[::-1])
                ]) for pair in chunk
            ])
            colors = np.stack([
                np.stack([
                    image_io.load_raw_float32_image(color_fmt.format(i))
                    for i in pair
                ]) for pair in chunk
            ])
            with torch.inference_mode():
                inputs = _upload((flows, colors), self.device)
                masks = consistency.consistent_flow_masks(
                    *inputs, flow_thresh, color_thresh)
                fetch = _Fetch([masks], inputs)
            if pending is not None:
                write_out(*pending)
            pending = (chunk, fetch)
        if pending is not None:
            write_out(*pending)

    # ------------------------------------------------------------------
    def check_good_flow_pairs(self, frame_pairs, overlap_ratio: float) -> str:
        """Filter pairs whose masks cover >= overlap_ratio of the image
        (reference: flow.py:46-86)."""
        import cv2

        flow_list_path = pjoin(
            self.out_path, "flow_list_%.2f.json" % overlap_ratio)
        if os.path.isfile(flow_list_path):
            return flow_list_path

        def ratio(mask):
            return np.sum(mask > 0) / np.prod(mask.shape[:2])

        mask_fmt = pjoin(self.path, "mask", "mask_{:06d}_{:06d}.png")
        result_pairs: List[Tuple[int, int]] = []
        checked = set()
        for pair in frame_pairs:
            pair = tuple(pair)
            if pair in checked:
                continue
            cur_pairs = [pair, pair[::-1]]
            checked.update(cur_pairs)
            ratios = [
                ratio(cv2.imread(mask_fmt.format(*ids), 0))
                for ids in cur_pairs
            ]
            if all(r >= overlap_ratio for r in ratios):
                result_pairs.extend(cur_pairs)
            else:
                print(f"Bad frame pair({pair[0]}, {pair[1]}). "
                      f"Overlap_ratio=", ratios)

        print(f"Filtered {len(result_pairs)} / {len(frame_pairs)} "
              "good frame pairs")
        if not result_pairs:
            raise Exception("No good frame pairs are found.")

        dists = np.array([abs(i - j) for (i, j) in result_pairs])
        print("Frame distance statistics: "
              f"max = {dists.max()}, mean = {dists.mean():.0f}, "
              f"median = {np.median(dists):.0f}")
        with open(flow_list_path, "w") as f:
            json.dump([list(p) for p in result_pairs], f)
        return flow_list_path

    # ------------------------------------------------------------------
    def visualize_flow(self, warp: bool = False,
                       batch_pairs: int = 16) -> None:
        """Colour-wheel panels with mask overlays (and, with ``warp``,
        each frame warped by its flow) for every flow pair (reference:
        flow.py:147-197, a per-pair host loop there). Rendering runs on
        the device in batches of ``batch_pairs`` pairs; the host reads
        inputs and writes PNGs."""
        import cv2

        flow_fmt = pjoin(self.path, "flow", "flow_{:06d}_{:06d}.raw")
        mask_fmt = pjoin(self.path, "mask", "mask_{:06d}_{:06d}.png")
        color_fmt = pjoin(self.path, "color_down", "frame_{:06d}.raw")
        vis_fmt = pjoin(self.path, "vis_flow", "frame_{:06d}_{:06d}.png")
        warp_fmt = pjoin(
            self.path, "vis_flow_warped", "frame_{:06d}_{:06d}_warped.png")

        for fmt in (vis_fmt, warp_fmt):
            os.makedirs(os.path.dirname(fmt), exist_ok=True)

        todo = []
        for flow_name in os.listdir(os.path.dirname(flow_fmt)):
            indices = sorted(
                int(s) for s in os.path.splitext(flow_name)[0].split("_")[1:])
            if indices in todo:
                continue
            if os.path.isfile(vis_fmt.format(*indices)) and (
                not warp or os.path.isfile(warp_fmt.format(*indices))
            ):
                continue
            todo.append(indices)

        def write_out(chunk, fetch):
            panel, *warped = fetch.result()
            for k, pair in enumerate(chunk):
                cv2.imwrite(vis_fmt.format(*pair), panel[k])
                if warp:
                    for s, idxs in enumerate((pair, pair[::-1])):
                        cv2.imwrite(warp_fmt.format(*idxs),
                                    warped[0][2 * k + s])

        pending = None
        for start in range(0, len(todo), batch_pairs):
            chunk = todo[start:start + batch_pairs]
            flows = np.stack([
                np.stack([
                    image_io.load_raw_float32_image(flow_fmt.format(*idxs))
                    for idxs in (pair, pair[::-1])
                ]) for pair in chunk
            ])
            colors = np.stack([
                np.stack([
                    image_io.load_raw_float32_image(color_fmt.format(i)) * 255
                    for i in pair
                ]) for pair in chunk
            ])
            masks = np.stack([
                np.stack([
                    cv2.imread(mask_fmt.format(*idxs), 0)
                    for idxs in (pair, pair[::-1])
                ]) for pair in chunk
            ]).astype(np.float32)[..., None]
            with torch.inference_mode():
                inputs = _upload((flows, colors, masks), self.device)
                fetch = _Fetch(_render(*inputs, warp), inputs)
            if pending is not None:
                write_out(*pending)
            pending = (chunk, fetch)
        if pending is not None:
            write_out(*pending)
