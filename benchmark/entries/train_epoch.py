"""Entry: ``TrainingEngine.train_epoch``, the fine-tune's hot loop, on slices
of epochs whose pair order is shuffled from the seed.

Set-up makes the resident dataset and the weights on the device, builds one
engine, and drives it through the first ``check_steps`` steps by the
window's own call (one step, then the rest), on pairs that all differ:
that warms every shape, and the Adam state after the first step and the
parameters after the last are the program's readings. The window then goes
on with the same engine. The reference follows the same steps from the
same weights and data after the window (``reference/common.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from benchmark.harness import program, roofline, traffic
from benchmark.harness.runner import Work
from benchmark.reference import common

KIND = "train"
# leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone and are left out of change_gap
MOVED_FLOOR = 1e-3


@dataclass
class State:
    run: Any
    data: Dict[str, torch.Tensor]
    engine: Any
    stream: traffic.StepStream
    steps_per_call: int
    flop_per_pair: float
    step_bounds_s: Dict[str, float]
    first_idx: Any = None
    first_valid: Any = None
    readings: Dict = field(default_factory=dict)
    skipped: List = field(default_factory=list)


def _call(st: State, steps: int):
    idx, valid = st.stream.take(steps)
    m = st.engine.train_epoch(st.data, idx, valid)
    st.skipped.append((m["skipped_nan"], valid.sum(1)))
    units = int(valid.sum())
    return Work(units, st.flop_per_pair * units, len(idx),
                {k: v * len(idx) for k, v in st.step_bounds_s.items()}), m


def call(st: State) -> Work:
    return _call(st, st.steps_per_call)[0]


def setup(run) -> State:
    from consistent_depth_tpu_torch.ops.losses import LossWeights
    from consistent_depth_tpu_torch.training import (
        TrainingEngine, create_optimizer)

    cfg, tr = run.config, run.traffic
    H, W = cfg["size"]
    B = int(tr["batch"])
    data = traffic.pair_dataset(tr, (H, W), run.seed, run.device)
    run.mark("data")
    n_pairs = int(data["pair_ids"].shape[0])
    engine = TrainingEngine(
        program.depth_model(run),
        create_optimizer("Adam", cfg["learning_rate"]),
        LossWeights(lambda_view_baseline=cfg["lambda_view_baseline"],
                    lambda_reprojection=1.0),
        precision=run.precision)
    run.mark("program")
    st = State(
        run=run, data=data, engine=engine,
        stream=traffic.StepStream(
            lambda e: traffic.epoch_batches(n_pairs, B, run.seed, e)),
        steps_per_call=int(tr["steps_per_call"]),
        # forward, and twice the forward for the backward, of both frames
        flop_per_pair=3 * 2 * roofline.forward_flop(run.reference, H, W),
        step_bounds_s=roofline.bounds_s(run.reference, 2 * B, H, W,
                                        run.precision, backward=True))

    n = int(tr["check_steps"])
    st.first_idx = st.stream.idx[:n].copy()
    st.first_valid = st.stream.valid[:n].copy()
    params = engine.params
    init = {k: p.detach().clone() for k, p in params.items()}
    _, m1 = _call(st, 1)
    beta1 = engine.optimizer.defaults["betas"][0]
    # no state at all where the optimizer never stepped
    grad = {k: engine.optimizer.state.get(p, {}).get(
        "exp_avg", torch.zeros_like(p)) / (1 - beta1)
        for k, p in params.items()}
    _, m2 = _call(st, n - 1)
    st.readings = {
        "loss": torch.cat([m1["loss"], m2["loss"]]).cpu().tolist(),
        "grad": program.leaf_norms(grad),
        "change": program.leaf_norms(
            {k: p.detach() - init[k] for k, p in params.items()}),
    }
    st.skipped = []
    return st


def close(st: State) -> int:
    return int(sum(float((sk.float().cpu() * torch.as_tensor(v)).sum())
                   for sk, v in st.skipped))


def release(st: State) -> None:
    st.engine = None


def _reference(st: State, rounding):
    run = st.run
    net = program.reference_net(run, rounding)
    init = {k: p.detach().clone() for k, p in net.named_parameters()}
    dev = run.device
    steps = [torch.as_tensor(i, device=dev) for i in st.first_idx]
    valid = [torch.as_tensor(v, device=dev) for v in st.first_valid]
    losses, first, after = common.train_steps(
        lambda images: run.reference.depth(net, images), net, st.data,
        steps, valid, run.config["learning_rate"],
        run.config["lambda_view_baseline"])
    return {"loss": losses.cpu().tolist(), "grad": program.leaf_norms(first),
            "change": program.leaf_norms(
                {k: after[k] - init[k] for k in init})}


def check(st: State, rounding=None) -> Dict[str, float]:
    ref = _reference(st, None)
    got = st.readings if rounding is None else _reference(st, rounding)
    return program.train_readings(got, ref, MOVED_FLOOR)
