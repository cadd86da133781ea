"""Full-state checkpoints beside the reference's model-only ``.pth`` files:
the port's counterpart of ``consistent_depth_tpu/training/checkpoints.py``.

The reference restarts fine-tuning from epoch 0 on every run; ``--resume``
continues from the newest ``full_{epoch:04d}`` directory instead. The
port's format is its own: ``state.pt`` holds the model's ``state_dict``
(parameters and BN running stats), the optimizer's ``state_dict`` (Adam's
moments and step), the engine's ``step`` and the epoch, written to a
temporary file and then moved into place. It does not read the JAX
package's ``state.npz``.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional, Tuple

import torch

from .engine import TrainingEngine, map_tensors


def save_full_state(path: str, state: Mapping[str, Any], epoch: int) -> None:
    """Write a resumable checkpoint directory from ``state``
    (:meth:`TrainingEngine.state_dict`, a snapshot on the device)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "state_tmp.pt")
    torch.save({"state": map_tensors(torch.Tensor.cpu, state),
                "epoch": int(epoch)}, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))


def restore_full_state(path: str, engine: TrainingEngine) -> Optional[int]:
    """Load a checkpoint written by :func:`save_full_state` into
    ``engine``; returns its epoch, or None if there is none."""
    fn = os.path.join(path, "state.pt")
    if not os.path.isfile(fn):
        return None
    ckpt = torch.load(fn, map_location="cpu", weights_only=True)
    engine.load_state_dict(ckpt["state"])
    return int(ckpt["epoch"])


def latest_epoch_checkpoint(checkpoints_dir: str
                            ) -> Optional[Tuple[str, int]]:
    """Find the newest full-state checkpoint dir ``full_{epoch:04d}``."""
    if not os.path.isdir(checkpoints_dir):
        return None
    best = None
    for name in os.listdir(checkpoints_dir):
        if name.startswith("full_") and name[5:].isdigit():
            epoch = int(name[5:])
            if best is None or epoch > best[1]:
                best = (os.path.join(checkpoints_dir, name), epoch)
    return best
