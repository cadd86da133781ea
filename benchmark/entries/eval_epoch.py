"""Entry: ``TrainingEngine.eval_epoch``, the fine-tune's validation pass
(paired, the f32 default: a train-mode forward and the loss per pair
batch), on slices of the pass's ordered batches.

Each call keeps its first batch's per-pair losses and the depths of that
batch's frames (each frame's first occurrence, as the pass keeps it).
After the window a sample of the calls, drawn from the seed, is recomputed
by the reference: train-mode batch norm normalises by the batch's own
statistics, so a batch's outputs depend on the weights and its inputs
alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.harness import program, roofline, traffic
from benchmark.harness.runner import Work
from benchmark.reference import common

KIND = "eval"


@dataclass
class State:
    run: Any
    data: Dict[str, torch.Tensor]
    engine: Any
    stream: traffic.StepStream
    steps_per_call: int
    flop_per_pair: float
    batch_bounds_s: Dict[str, float]
    kept: List = field(default_factory=list)
    bad: List = field(default_factory=list)


def _call(st: State):
    idx, valid = st.stream.take(st.steps_per_call)
    m = st.engine.eval_epoch(st.data, idx, valid)
    # the pair ids are the frame slots of this recipe's dataset
    slots = m["pair_ids"][0].long()
    losses = m["reprojection"] + m["disparity"]
    st.bad.append((~torch.isfinite(losses)).sum())
    return idx, valid, losses, m["depth_frames"][slots]


def call(st: State) -> Work:
    idx, valid, losses, depth0 = _call(st)
    st.kept.append((idx[0].copy(), valid[0].copy(), losses[0], depth0))
    units = int(valid.sum())
    return Work(units, st.flop_per_pair * units, 0,
                {k: v * len(idx) for k, v in st.batch_bounds_s.items()})


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
        precision=run.precision, eval_dedup=False)
    run.mark("program")
    st = State(
        run=run, data=data, engine=engine,
        stream=traffic.StepStream(
            lambda e: traffic.eval_batches(n_pairs, B)),
        steps_per_call=int(tr["steps_per_call"]),
        flop_per_pair=2 * roofline.forward_flop(run.reference, H, W),
        batch_bounds_s=roofline.bounds_s(run.reference, 2 * B, H, W,
                                         run.precision, backward=False))
    _call(st)                      # warm-up: the window's shapes
    st.bad = []
    return st


def close(st: State) -> int:
    return int(sum(int(b) for b in st.bad))


def release(st: State) -> None:
    st.engine = None


def _first_occurrence(slots: np.ndarray, valid: np.ndarray) -> List[tuple]:
    """(pair, side) of each distinct frame of a batch's valid pairs, at its
    first occurrence in pair-then-side order."""
    seen, out = set(), []
    for i in range(len(slots)):
        if valid[i] <= 0:
            continue
        for side in (0, 1):
            s = int(slots[i, side])
            if s not in seen:
                seen.add(s)
                out.append((i, side))
    return out


@torch.no_grad()
def check(st: State, rounding=None) -> Dict[str, float]:
    run = st.run
    tr, cfg = run.traffic, run.config
    rng = np.random.default_rng(traffic.derive(run.seed, "check"))
    picks = rng.choice(len(st.kept), min(int(tr["check_calls"]),
                                         len(st.kept)), replace=False)
    nets = {r: program.reference_net(run, r) for r in {None, rounding}}
    for net in nets.values():
        net.train()
    loss_gap = depth_gap = 0.0
    for c in sorted(int(p) for p in picks):
        idx0, valid0, got_loss, got_depth = st.kept[c]
        idx_t = torch.as_tensor(idx0, device=run.device)
        v_t = torch.as_tensor(valid0, device=run.device)
        batch = common.gather_batch(st.data, idx_t)
        out = {}
        for r, net in nets.items():
            depth = run.reference.depth(net, batch["images"])
            _, losses = common.consistency_loss(
                depth, batch["intrinsics"], batch["extrinsics"],
                batch["flows"], batch["masks"], v_t,
                cfg["lambda_view_baseline"])
            out[r] = (losses["reprojection"] + losses["disparity"], depth)
        if rounding is not None:
            got_loss, got_depth = out[rounding]
        ref_loss, ref_depth = out[None]
        got_loss, ref_loss = got_loss.cpu().numpy(), ref_loss.cpu().numpy()
        got_depth, ref_depth = got_depth.cpu().numpy(), ref_depth.cpu().numpy()
        slots = st.data["pair_slots"][idx_t].cpu().numpy()
        for i in np.flatnonzero(valid0 > 0):
            loss_gap = max(loss_gap, program.relative_gap(got_loss[i],
                                                          ref_loss[i]))
        for i, side in _first_occurrence(slots, valid0):
            depth_gap = max(depth_gap, program.log_depth_gap(
                got_depth[i, side], ref_depth[i, side]))
        if not (np.isfinite(got_loss).all() and np.isfinite(got_depth).all()):
            return {"pair_loss_gap": float("nan"), "depth_gap": float("nan")}
    return {"pair_loss_gap": loss_gap, "depth_gap": depth_gap}
