"""The pair-batch iterator of the train loop: the port's copy of
``consistent_depth_tpu/data/video_dataset.py::PairBatchIterator``.

The dataset itself is put on the card by
:meth:`..training.engine.TrainingEngine.put_data`; this module only draws
the shuffled, padded batches of pair indices on the host.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


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
