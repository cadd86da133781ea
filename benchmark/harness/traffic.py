"""The benchmark's one traffic generator: every mix is a file of parameters
under ``benchmark/traffic/`` that these functions read.

- :func:`pair_dataset`: the fine-tune's resident dataset, the recipe of
  ``bench.py::make_workload`` (copied from ``chip_smoke.py::
  make_train_workload``): frames U[0, 1), the hierarchical2 pair set
  (``utils/frame_sampling.py``), flows N(0, 2^2), masks U > 0.2,
  intrinsics (1.2 W, 1.2 W, W / 2, H / 2), identity extrinsics; made on
  the device from the seed.
- :func:`epoch_batches`, :func:`eval_batches`: the train pass's shuffled,
  padded (steps, batch) pair indices and the eval pass's ordered ones
  (``data/video_dataset.py::PairBatchIterator``,
  ``training/fine_tuning.py::eval_batches``).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, data, order, ...) of a run:
    the streams of one seed are independent, and any whole seed works."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def hierarchical2_pairs(n_frames: int) -> np.ndarray:
    """The one-way hierarchical2 pair set over frames 0..n-1, sorted: for
    each distance d = 2^l, pairs (s, s + d) with s stepping by max(1,
    d / 2) in both directions, as ``utils/frame_sampling.py`` samples
    it."""
    pairs = set()
    for level in range(0, int(math.floor(math.log2(max(n_frames - 1, 1)))) + 1):
        dist = 1 << level
        step = 1 << max(0, level - 1)
        for start in range(0, n_frames, step):
            for end in (start - dist, start + dist):
                if 0 <= end < n_frames:
                    pairs.add((min(start, end), max(start, end)))
    return np.array(sorted(pairs), np.int64)


def pair_dataset(traffic: Mapping, size: Tuple[int, int], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The resident dataset of ``traffic["frames"]`` frames at ``size``,
    on ``device``, from ``seed``."""
    H, W = size
    n = int(traffic["frames"])
    pairs = torch.as_tensor(hierarchical2_pairs(n), device=device)
    P = len(pairs)
    g = generator(seed, "data", device)
    f32 = torch.float32
    frames = torch.rand((n, H, W, 3), generator=g, device=device, dtype=f32)
    flows = torch.randn((P, 2, H, W, 2), generator=g, device=device,
                        dtype=f32).mul_(2.0)
    masks = (torch.rand((P, 2, H, W), generator=g, device=device,
                        dtype=f32) > 0.2).to(f32)
    intr = torch.tensor([W * 1.2, W * 1.2, W / 2, H / 2], dtype=f32,
                        device=device).expand(P, 2, 4).contiguous()
    ext = torch.cat([torch.eye(3, dtype=f32, device=device),
                     torch.zeros((3, 1), dtype=f32, device=device)], 1)
    return {"frames": frames, "pair_slots": pairs.int(),
            "pair_ids": pairs.int(), "flows": flows, "masks": masks,
            "intrinsics": intr, "extrinsics": ext.expand(P, 2, 3, 4).contiguous()}


def epoch_batches(n_pairs: int, batch: int, seed: int, epoch: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(steps, batch) indices and valid mask of one train epoch: the pairs
    in an order shuffled from (seed, epoch), the last batch padded with
    pair 0 and valid 0."""
    rng = np.random.default_rng([derive(seed, "order"), epoch])
    order = rng.permutation(n_pairs)
    steps = -(-n_pairs // batch)
    idx = np.zeros(steps * batch, np.int64)
    idx[:n_pairs] = order
    valid = (np.arange(steps * batch) < n_pairs).astype(np.float32)
    return idx.reshape(steps, batch), valid.reshape(steps, batch)


def eval_batches(n_pairs: int, batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """The eval pass: every pair once, in order, the last batch padded by
    repeating pair n - 1 with valid 0."""
    steps = -(-n_pairs // batch)
    flat = np.arange(steps * batch)
    idx = np.minimum(flat, n_pairs - 1).reshape(steps, batch)
    valid = (flat < n_pairs).astype(np.float32).reshape(steps, batch)
    return idx, valid


class StepStream:
    """Consecutive slices of (steps, batch) index and valid arrays drawn
    from ``make(epoch)``, rolling over into the next epoch."""

    def __init__(self, make):
        self.make = make
        self.epoch = 0
        self.pos = 0
        self.idx, self.valid = make(0)

    def take(self, steps: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.pos >= len(self.idx):
            self.epoch += 1
            self.pos = 0
            self.idx, self.valid = self.make(self.epoch)
        end = min(self.pos + steps, len(self.idx))
        out = self.idx[self.pos:end], self.valid[self.pos:end]
        self.pos = end
        return out
