#!/usr/bin/env python3
"""Times the port's ``mc`` train step (bf16 by default, whose time the
host's issue rate bounds) on one H100 for the checkout given by ``--repo``
(default: this one), so that two commits can be compared in one call, in
turns, each in its own process (parent, change, change, parent).

The workload is ``chip_smoke.py``'s (``bench.py::make_workload``'s demo data
rebuilt from the same seeded recipe, 244 frames at 224x384, 715 pairs,
batch 4 pairs, the seeded ``mc`` init with the tamed head, Adam at 4e-4),
taken from the checkout's own ``chip_smoke.py``. After 3 warm-up steps it
times 3 runs of 20 steps: CUDA events over each run (ms per step), the host
clock, the host's time to queue the steps, and, for a checkout whose
NaN-skip reads a flag on the host, its wait in that read; then it profiles
5 more steps with the checkout's ``chip_smoke.profile_train`` (the device's
busy ms per step, its idle share and the k x k convs' ms). It prints one
JSON line with the card's name and power limit.

Usage, from the root of a checkout on the card:
``python3 tools/torch_step_time.py [--repo build/parent] [--precision f32]``
"""

import argparse
import json
import sys
import time
from itertools import islice
from pathlib import Path

STEPS = 20
REPEATS = 3


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("--precision", choices=["bf16", "f32"],
                        default="bf16")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_step_time: no CUDA device")

    import chip_smoke as cs
    from consistent_depth_tpu_torch import training
    from consistent_depth_tpu_torch.models.registry import (
        create_depth_model)
    from consistent_depth_tpu_torch.ops import s2d_conv
    from consistent_depth_tpu_torch.ops.losses import LossWeights

    workload = cs.make_train_workload(training, cs.SIZE)
    model = create_depth_model("mc", checkpoint="", seed=0, device="cuda")
    with torch.no_grad():
        model.net.pred_layer.weight.mul_(cs.TAME_HEAD)
        model.net.pred_layer.bias.mul_(cs.TAME_HEAD)
    engine = training.TrainingEngine(
        model, training.create_optimizer("Adam", cs.TRAIN_LR),
        LossWeights(lambda_view_baseline=0.1, lambda_reprojection=1.0),
        precision=args.precision)
    data = engine.put_data(workload)
    n_pairs = len(workload["pair_ids"])
    batches = list(islice(training.PairBatchIterator(
        n_pairs, cs.TRAIN_BATCH, seed=0).epoch(0),
        3 + STEPS * REPEATS + cs.PROFILED_STEPS))
    for idx, valid in batches[:3]:
        engine.train_step(data, idx, valid)
    runs = []
    for r in range(REPEATS):
        timed = batches[3 + r * STEPS:3 + (r + 1) * STEPS]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reads_flag = hasattr(engine, "flag_wait_s")
        if reads_flag:
            engine.flag_wait_s = 0.0
        t0 = time.perf_counter()
        start.record()
        for idx, valid in timed:
            engine.train_step(data, idx, valid)
        issued = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        runs.append({
            "ms_per_step": start.elapsed_time(end) / len(timed),
            "host_ms_per_step": 1e3 * (time.perf_counter() - t0) / len(timed),
            "host_issue_ms_per_step": 1e3 * issued / len(timed),
            "flag_wait_ms_per_step": (1e3 * engine.flag_wait_s / len(timed)
                                      if reads_flag else None)})
    profile = cs.profile_train(torch, engine, data, batches, s2d_conv)
    print(json.dumps({"repo": args.repo, "precision": args.precision,
                      "steps": STEPS, "runs": runs,
                      "device_ms_per_step": profile["device_ms_per_step"],
                      "device_idle_share": profile["device_idle_share"],
                      "ranges_ms_per_step": profile["ranges_ms_per_step"],
                      "nvidia_smi": cs.nvidia_smi_line()}), flush=True)


if __name__ == "__main__":
    main()
