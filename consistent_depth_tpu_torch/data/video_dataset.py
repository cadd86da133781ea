"""The fine-tune's data: the port's copy of
``consistent_depth_tpu/data/video_dataset.py``.

The whole per-video dataset is small (hundreds of MB), so it is loaded once
into host arrays, put on the card once
(:meth:`..training.engine.TrainingEngine.put_data`), and an epoch is a
sequence of device-side gathers by shuffled index. Unique frames are
stored once ((F, H, W, 3)) and gathered per pair.

Directory layout consumed (the reference's, loaders/video_dataset.py:80-125):

    color_down/frame_{:06d}.raw   (H, W, 3); .raw stores RGB, the loader
                                  swizzles back to BGR [0, 1]
    flow/flow_{ref:06d}_{tgt:06d}.raw   (H, W, 2) pixels
    mask/mask_{ref:06d}_{tgt:06d}.png   0/255
    metadata.npz: intrinsics (N, 4), extrinsics (N, 3, 4)
    flow_list.json: [[i, j], ...]

Plain numpy; the JAX package's optional native batch reader is not used,
and OpenCV is imported only inside the PNG readers.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from os.path import join as pjoin
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..io import image_io
from ..utils import frame_sampling as sampling


def load_color(path: str) -> np.ndarray:
    """(H, W, 3) float32 BGR in [0, 1] (reference:
    loaders/video_dataset.py:48-59: .raw stores RGB, swizzled to BGR;
    PNGs are read BGR by cv2 and scaled)."""
    if os.path.splitext(path)[-1] == ".raw":
        im = image_io.load_raw_float32_image(path)
        if im.ndim == 3:
            im = im[..., ::-1]
    else:
        import cv2

        im = cv2.imread(path, cv2.IMREAD_UNCHANGED) / 255.0
    return np.ascontiguousarray(im.reshape(im.shape[:2] + (-1,)), np.float32)


def load_flow(path: str) -> np.ndarray:
    flow = image_io.load_raw_float32_image(path)
    assert flow.ndim == 3 and flow.shape[-1] == 2, f"bad flow {flow.shape}"
    return flow


def load_mask(path: str) -> np.ndarray:
    import cv2

    mask = cv2.imread(path, 0)
    return (mask > 0).astype(np.float32)


def load_color_batch(paths) -> np.ndarray:
    """(N, H, W, 3) float32 BGR stack of same-shaped color frames."""
    return np.stack([load_color(p) for p in paths])


def load_flow_batch(paths, h: int, w: int) -> np.ndarray:
    """(N, H, W, 2) float32 stack of flow fields."""
    return np.stack([load_flow(p) for p in paths])


def load_mask_batch(paths) -> np.ndarray:
    """(N, H, W) float32 stack of binary masks (threaded PNG decode: cv2
    releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    if len(paths) <= 4:
        return np.stack([load_mask(p) for p in paths])
    with ThreadPoolExecutor(max_workers=8) as pool:
        return np.stack(list(pool.map(load_mask, paths)))


@dataclass
class PairData:
    """All arrays for fine-tuning one video; host numpy, static shapes."""

    frames: np.ndarray        # (F, H, W, 3) unique frames, BGR [0,1]
    frame_ids: np.ndarray     # (F,) original frame indices
    pair_slots: np.ndarray    # (P, 2) int32 indices into frames
    pair_ids: np.ndarray      # (P, 2) original frame-id pairs
    flows: np.ndarray         # (P, 2, H, W, 2)
    masks: np.ndarray         # (P, 2, H, W)
    intrinsics: np.ndarray    # (P, 2, 4)
    extrinsics: np.ndarray    # (P, 2, 3, 4)
    scales: Optional[np.ndarray] = None  # (P, 2) or None

    @property
    def num_pairs(self) -> int:
        return self.pair_ids.shape[0]


class VideoPairDataset:
    """Loads the full pair dataset from a reference-layout directory."""

    def __init__(self, path: str, meta_file: Optional[str] = None,
                 scales: Optional[Dict[int, float] | float] = None):
        self.path = path
        color_fmt = pjoin(path, "color_down", "frame_{:06d}.raw")
        if not os.path.isfile(color_fmt.format(0)):
            color_fmt = pjoin(path, "color_down", "frame_{:06d}.png")
        self.color_fmt = color_fmt
        self.mask_fmt = pjoin(path, "mask", "mask_{:06d}_{:06d}.png")
        self.flow_fmt = pjoin(path, "flow", "flow_{:06d}_{:06d}.raw")
        self.meta_file = meta_file
        self.scales = scales

        flow_list_fn = pjoin(path, "flow_list.json")
        if os.path.isfile(flow_list_fn):
            with open(flow_list_fn, "r") as f:
                pairs = json.load(f)
        else:
            flow_dir = os.path.dirname(self.flow_fmt)
            names = os.listdir(flow_dir) if os.path.isdir(flow_dir) else []
            pairs = [
                [int(s) for s in os.path.splitext(n)[0].split("_")[-2:]]
                for n in names if n.endswith(".raw")
            ]
        self.pairs: List[Tuple[int, int]] = sorted(
            tuple(p) for p in sampling.SamplePairs.to_one_way(pairs)
        )

    def __len__(self) -> int:
        return len(self.pairs)

    def load(self) -> PairData:
        frame_ids = sorted({i for pair in self.pairs for i in pair})
        id_to_slot = {f: s for s, f in enumerate(frame_ids)}

        frames = load_color_batch(
            [self.color_fmt.format(i) for i in frame_ids])
        H, W = frames.shape[1:3]

        P = len(self.pairs)
        directed = [(a, b)
                    for (i, j) in self.pairs for (a, b) in ((i, j), (j, i))]
        flows = load_flow_batch(
            [self.flow_fmt.format(a, b) for a, b in directed],
            H, W).reshape(P, 2, H, W, 2)
        masks = load_mask_batch(
            [self.mask_fmt.format(a, b) for a, b in directed]
        ).reshape(P, 2, H, W)

        if self.meta_file is not None:
            with np.load(self.meta_file) as meta:
                intr_all = meta["intrinsics"].astype(np.float32)
                extr_all = meta["extrinsics"].astype(np.float32)
            assert intr_all.shape[0] == extr_all.shape[0], (
                f"#extrinsics({extr_all.shape[0]}) != "
                f"#intrinsics({intr_all.shape[0]})")
            pair_arr = np.array(self.pairs)
            intrinsics = intr_all[pair_arr]
            extrinsics = extr_all[pair_arr]
        else:
            intrinsics = np.zeros((P, 2, 4), np.float32)
            extrinsics = np.zeros((P, 2, 3, 4), np.float32)

        scales = None
        if self.scales is not None:
            if isinstance(self.scales, dict):
                scales = np.array(
                    [[self.scales[i], self.scales[j]] for i, j in self.pairs],
                    np.float32)
            else:
                scales = np.full((P, 2), float(self.scales), np.float32)

        return PairData(
            frames=frames,
            frame_ids=np.array(frame_ids, np.int32),
            pair_slots=np.array(
                [[id_to_slot[i], id_to_slot[j]] for i, j in self.pairs],
                np.int32),
            pair_ids=np.array(self.pairs, np.int32),
            flows=flows, masks=masks,
            intrinsics=intrinsics, extrinsics=extrinsics,
            scales=scales,
        )


class VideoFrameDataset:
    """Single-frame dataset for batch inference (reference:
    loaders/video_dataset.py:213-242)."""

    def __init__(self, color_fmt: str, frames: Optional[Sequence[int]] = None):
        self.color_fmt = color_fmt
        if frames is None:
            files = os.listdir(os.path.dirname(color_fmt))
            frames = range(len(files))
        self.frames = list(frames)

    def __len__(self):
        return len(self.frames)

    def load_batch(self, indices: Sequence[int]
                   ) -> Tuple[np.ndarray, List[int]]:
        ids = [self.frames[i] for i in indices]
        images = load_color_batch([self.color_fmt.format(i) for i in ids])
        return images, ids


class PairBatchIterator:
    """Padded static-shape batch indices with a validity mask.

    Shuffle is host-side (seeded numpy RNG); gathers happen on the device
    in the train step. The last partial batch is padded with index 0 and
    valid=0 (the loss divides by the valid count, see
    :func:`..ops.losses.consistency_loss`).
    """

    def __init__(self, num_pairs: int, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        self.num_pairs = num_pairs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def epoch(self, epoch_index: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(self.num_pairs)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch_index)
            rng.shuffle(order)
        B = self.batch_size
        n_full = self.num_pairs // B
        for b in range(n_full):
            idx = order[b * B:(b + 1) * B]
            yield idx.astype(np.int32), np.ones((B,), np.float32)
        rem = self.num_pairs - n_full * B
        if rem and not self.drop_last:
            idx = np.zeros((B,), np.int32)
            idx[:rem] = order[n_full * B:]
            valid = np.zeros((B,), np.float32)
            valid[:rem] = 1.0
            yield idx, valid

    def steps_per_epoch(self) -> int:
        n = self.num_pairs / self.batch_size
        return int(n) if self.drop_last else int(np.ceil(n))
