"""Optimizer registry: the port of ``consistent_depth_tpu/training/optimizer.py``
(reference: optimizer/__init__.py, torch Adam only).

Each entry returns a factory that takes the parameters, so that an engine
can be handed an optimizer before it owns the parameters, as an optax
transformation is. The hyperparameters are those of the JAX package's
optax calls: eps 1e-8, betas (0.9, 0.999), SGD without momentum, and AdamW
with optax's default weight decay of 1e-4 (``torch.optim.AdamW`` would
default to 1e-2). Both apply the decay to the parameters before the step,
``p -= lr * (adam_update + wd * p)``.

Every optimizer is built ``fused``: a fused torch optimizer takes a device
flag, ``opt.found_inf`` (with ``opt.grad_scale = None``), and where the
flag is 1 it leaves the parameters and its state (moments and ``step``)
bitwise unchanged, with no read on the host. That is the engine's masked
update, the JAX engine's select (``training/engine.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import torch

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]],
                            torch.optim.Optimizer]

OPTIMIZER_MAP = {
    "Adam": lambda lr, betas=(0.9, 0.999): functools.partial(
        torch.optim.Adam, lr=lr, betas=tuple(betas), eps=1e-8, fused=True),
    "SGD": lambda lr, betas=None: functools.partial(
        torch.optim.SGD, lr=lr, fused=True),
    "AdamW": lambda lr, betas=(0.9, 0.999): functools.partial(
        torch.optim.AdamW, lr=lr, betas=tuple(betas), eps=1e-8,
        weight_decay=1e-4, fused=True),
}

OPTIMIZER_NAMES = list(OPTIMIZER_MAP.keys())


def create(name: str, learning_rate: float, **kwargs) -> OptimizerFactory:
    return OPTIMIZER_MAP[name](learning_rate, **kwargs)
