"""Faults planted under the timed path, to show that the output check
catches them (``tests/test_bench_faults.py``, ``tools/calibrate.py``):

- ``unchanged``: the optimizer's step returns the state unchanged;
- ``half_batch``: the network sees the first half of each batch, and the
  second half gets copies of its outputs, so that a mean is taken over the
  first half alone;
- ``altered``: every answer is 1% off where it is produced: each depth
  the network gives and each loss the engine's loss chain gives.

The one-card cells have no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    from consistent_depth_tpu_torch.models.base import DepthModel
    from consistent_depth_tpu_torch.training import engine

    saved = (DepthModel.apply, torch.optim.Adam.step, engine.joint_loss)
    apply, joint_loss = saved[0], saved[2]

    def half_batch(self, images, scales=None, train=False):
        h = -(-images.shape[0] // 2)
        d = apply(self, images[:h], None if scales is None else scales[:h],
                  train)
        return torch.cat([d, d])[:images.shape[0]]

    def altered(self, images, scales=None, train=False):
        return apply(self, images, scales, train) * 1.01

    def altered_loss(*args, **kwargs):
        loss, batch_losses = joint_loss(*args, **kwargs)
        return loss * 1.01, {k: v * 1.01 for k, v in batch_losses.items()}

    try:
        if name == "unchanged":
            torch.optim.Adam.step = lambda self, closure=None: None
        elif name == "half_batch":
            DepthModel.apply = half_batch
        else:
            DepthModel.apply = altered
            engine.joint_loss = altered_loss
        yield
    finally:
        DepthModel.apply, torch.optim.Adam.step, engine.joint_loss = saved
