#!/usr/bin/env python3
"""The port's data mesh across the cards of one host: the ``mc`` train step
on N ranks, one per card, over NCCL, against the same step on one card, and
both timed.

The workload is ``chip_smoke.py``'s (``bench.py::make_workload``'s demo data
rebuilt from the same seeded recipe, 244 frames at 224x384, 715 pairs, the
seeded ``mc`` init with the tamed head, Adam at 4e-4), at ``--batch`` pairs
per card, so the global batch is N times that. Every rank holds the
workload; the engine broadcasts rank 0's weights.

1. Check, f32: ``--check`` steps on the mesh; the ranks' parameters after
   them must be bitwise equal; then rank 0 runs the same steps on the global
   batch without a mesh, on its own card: the first loss within 1e-5
   relative, the later ones within 1e-3 and the parameters within relative
   L2 5e-2 (``chip_smoke.py`` phase 14's bands).
2. Time, per precision: 3 warm-up and ``--steps`` timed steps on the mesh
   at the global batch, and ``torch.profiler`` over 5 more (rank 0's device
   time per step, idle share and top kernels), then on rank 0 alone (the
   others waiting at a barrier) the step without a mesh at the global batch
   and at the per-card batch; the median ms per step from CUDA events
   around each step, and pairs per second.

Rank 0 prints one JSON line, with the card's name and power limit; any
failed check exits non-zero.

Usage, from the root of a checkout on a host with N cards:
``torchrun --standalone --nproc_per_node N tools/torch_mesh_cards.py
[--batch 4] [--steps 20] [--check 3]``. On the CPU, to rehearse the
control flow: ``... --device cpu --size 32 48 --frames 8 --steps 2``.
"""

import argparse
import json
import os
import sys
from itertools import islice

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP = 3
TOL_FIRST_LOSS = 1e-5
TOL_LATER_LOSS = 1e-3
TOL_PARAMS = 5e-2


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=4,
                        help="pairs per card")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--check", type=int, default=3)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--size", type=int, nargs=2, default=[224, 384])
    parser.add_argument("--frames", type=int, default=244)
    args = parser.parse_args()

    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    import chip_smoke
    from consistent_depth_tpu_torch import training
    from consistent_depth_tpu_torch.models.registry import create_depth_model
    from consistent_depth_tpu_torch.ops import s2d_conv
    from consistent_depth_tpu_torch.ops.losses import LossWeights
    from consistent_depth_tpu_torch.parallel import (
        all_gather_batch, make_mesh)

    cuda = args.device == "cuda"
    mesh = make_mesh(device=None if cuda else "cpu")
    device = mesh.device
    n, b = mesh.size, args.batch
    workload = chip_smoke.make_train_workload(training, tuple(args.size),
                                              n_frames=args.frames)
    init = create_depth_model("mc", checkpoint="", seed=0, device=device)
    with torch.no_grad():
        init.net.pred_layer.weight.mul_(chip_smoke.TAME_HEAD)
        init.net.pred_layer.bias.mul_(chip_smoke.TAME_HEAD)
    init_sd = {k: v.clone() for k, v in init.net.state_dict().items()}
    del init
    n_pairs = len(workload["pair_ids"])

    def batches(size, count):
        return list(islice(training.PairBatchIterator(
            n_pairs, size, seed=0).epoch(0), count))

    def engine(precision, with_mesh):
        model = create_depth_model("mc", checkpoint="", device=device)
        model.net.load_state_dict(init_sd)
        return training.TrainingEngine(
            model, training.create_optimizer("Adam", chip_smoke.TRAIN_LR),
            LossWeights(lambda_view_baseline=0.1, lambda_reprojection=1.0),
            precision=precision, mesh=mesh if with_mesh else None)

    def flat_params(eng):
        return torch.cat([p.detach().reshape(-1)
                          for p in eng.params.values()])

    # 1. the check
    steps = batches(n * b, args.check)
    eng = engine("f32", True)
    data = eng.put_data(workload)
    losses = [float(eng.train_step(data, i, v)["loss"]) for i, v in steps]
    params = flat_params(eng)
    every = all_gather_batch(mesh, params[None])
    replicas_equal = all(torch.equal(every[0], every[r]) for r in range(n))
    del eng, every
    out = {"tool": "torch_mesh_cards", "ranks": n, "backend": mesh.backend,
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "batch_per_card": b, "global_batch": n * b,
           "size": args.size, "frames": args.frames}
    if mesh.rank == 0:
        ref = engine("f32", False)
        ref_losses = [float(ref.train_step(data, i, v)["loss"])
                      for i, v in steps]
        ref_params = flat_params(ref)
        rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)]
        out["check"] = {
            "steps": args.check, "losses": losses,
            "one_card_losses": ref_losses, "first_loss_rel": rel[0],
            "loss_rel": max(rel),
            "params_rel_l2": float((params - ref_params).double().norm()
                                   / ref_params.double().norm()),
            "replicas_bitwise": replicas_equal}
        del ref
    mesh.barrier()

    # 2. the times
    def ms_per_step(eng, dev_data, step_batches):
        for i, v in step_batches[:WARMUP]:
            eng.train_step(dev_data, i, v)
        if not cuda:
            return None
        events = []
        for i, v in step_batches[WARMUP:]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng.train_step(dev_data, i, v)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(device)
        return float(np.median([s.elapsed_time(e) for s, e in events]))

    count = WARMUP + args.steps
    out["ms_per_step"] = {}
    out["mesh_profile"] = {}
    for precision in ("f32", "bf16"):
        eng = engine(precision, True)
        step_batches = batches(n * b, count)
        times = {"mesh": ms_per_step(eng, data, step_batches)}
        if cuda:
            prof = chip_smoke.profile_train(torch, eng, data, step_batches,
                                            s2d_conv)
            out["mesh_profile"][precision] = {
                "device_ms_per_step": prof["device_ms_per_step"],
                "device_idle_share": prof["device_idle_share"],
                "top_kernels_ms_per_step":
                    prof["top_kernels_ms_per_step"][:10]}
        del eng
        if mesh.rank == 0:
            for name, size in (("one_card_global", n * b),
                               ("one_card_per_card", b)):
                eng = engine(precision, False)
                times[name] = ms_per_step(eng, data, batches(size, count))
                del eng
                if cuda:
                    torch.cuda.empty_cache()
        mesh.barrier()
        if cuda and mesh.rank == 0:
            times["pairs_per_s"] = {
                "mesh": 1e3 * n * b / times["mesh"],
                "one_card_global": 1e3 * n * b / times["one_card_global"],
                "one_card_per_card": 1e3 * b / times["one_card_per_card"]}
        out["ms_per_step"][precision] = times

    ok = True
    if mesh.rank == 0:
        c = out["check"]
        ok = (c["replicas_bitwise"] and c["first_loss_rel"] <= TOL_FIRST_LOSS
              and c["loss_rel"] <= TOL_LATER_LOSS
              and c["params_rel_l2"] <= TOL_PARAMS)
        out["pass"] = ok
        if cuda:
            out["nvidia_smi"] = chip_smoke.nvidia_smi_line()
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
