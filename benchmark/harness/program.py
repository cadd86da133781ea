"""The system under test and the reference, built alike: the port's network
(``consistent_depth_tpu_torch``) and the reference's, both given the
benchmark's weights from the seed (``weights.make``), and the comparison
of their readings."""

from __future__ import annotations

import statistics
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from . import weights


def depth_model(run):
    """The port's depth model of the configuration, f32 on the run's
    device, with the benchmark's weights."""
    from consistent_depth_tpu_torch.models.registry import create_depth_model

    model = create_depth_model(run.config["model_type"], checkpoint="",
                               device=run.device)
    n = sum(p.numel() for p in model.net.parameters())
    if n != run.config["parameters"]:
        raise ValueError(f"the port's {run.config['model_type']} has {n} "
                         f"parameters, the configuration "
                         f"{run.config['parameters']}")
    weights.make(model.net, run.seed, run.reference, run.config)
    return model


def reference_net(run, rounding: Optional[str] = None):
    """The reference's network, f32 on the run's device, with the same
    weights; its convs computed at ``rounding`` (None: f32)."""
    from benchmark.reference import common

    with torch.device("meta"):
        net = run.reference.build()
    net = net.to_empty(device=run.device)
    weights.make(net, run.seed, run.reference, run.config)
    common.f32_policy()
    return common.set_rounding(net, rounding)


def relative_gap(a, b) -> float:
    """|a - b| / |b|."""
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def log_depth_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """Relative L2 distance of two depth maps' logs: ||log got - log ref||
    / ||log ref||; not finite where ``got`` is not."""
    lg = np.log(np.asarray(got, np.float64))
    lr = np.log(np.asarray(ref, np.float64))
    return float(np.linalg.norm(lg - lr) / max(np.linalg.norm(lr), 1e-30))


def norm_gap(got: Mapping[str, float], ref: Mapping[str, float],
             names: Optional[Sequence[str]] = None) -> float:
    """The worst leaf's gap of norms: max over ``names`` (default all) of
    |got - ref| / max(ref of the leaf, the median leaf's ref)."""
    names = list(ref) if names is None else list(names)
    med = statistics.median(ref[k] for k in names)
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names)


def train_readings(got: Dict, ref: Dict, moved_floor: float) -> Dict[str, float]:
    """loss_gap: the worst of the first steps' relative loss gaps;
    grad_gap: the first gradient's worst leaf; change_gap: the parameters'
    change over the first steps, worst leaf of those whose reference
    gradient is at least ``moved_floor`` times the median leaf's (below it
    a leaf moves under Adam by round-off alone)."""
    gmed = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= moved_floor * gmed]
    return {
        "loss_gap": max(relative_gap(a, b)
                        for a, b in zip(got["loss"], ref["loss"])),
        "grad_gap": norm_gap(got["grad"], ref["grad"]),
        "change_gap": norm_gap(got["change"], ref["change"], moved),
    }


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """{name: L2 norm} in f64 on the host, in one transfer."""
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))
