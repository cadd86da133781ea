#!/usr/bin/env python3
"""Whether the k x k conv kernel's 3xTF32 truncation drifts over a long f32
fine-tune, on one NVIDIA H100.

On ``chip_smoke.py``'s train workload (``bench.py::make_workload``'s demo
data rebuilt from its seeded recipe: 244 frames at 224x384, 715
hierarchical2 pairs, batch 4 pairs; the seeded ``mc`` init with the tamed
head; Adam at 4e-4; f32 with cuDNN's and matmul's TF32 off, as phase 8
runs it), steps engines in lockstep over the same ``--steps`` batches
(epochs 0, 1, ... of ``PairBatchIterator(seed=0)``):

- ``kernels``: the k x k convs through the kernel (the plan's f32 route,
  3xTF32 on the tensor cores);
- ``plain``: the same convs through ``same_conv_reference`` and its
  grad-input (cuDNN in f32, TF32 off), from the same init;
- ``noise<s>``: ``plain`` from the init times (1 + noise z), z standard
  normal from ``torch.Generator().manual_seed(s)``, for each seed of
  ``--seeds``: the plain path's own spread, the yardstick.

After every step it records, for each engine but ``plain``, the relative
gap of its loss to ``plain``'s and the relative L2 distance of all its
parameters to ``plain``'s. It writes every step to ``--out`` and prints one
JSON line with the card's name and power limit: the gaps at a few steps,
each gap's envelope over the noise seeds, and the first step at which the
kernels' parameter gap exceeds that step's envelope, with the share of the
later steps at which it does.

Usage, from the root of a checkout on the card: ``python3
tools/torch_tf32_drift.py [--steps 300] [--noise 1e-7] [--seeds 0 1 2]
[--out build/tf32_drift.json]``
"""

import argparse
import json
import os
import sys
import time
from itertools import chain, count, islice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

REPORT_STEPS = (1, 2, 5, 10, 20, 50, 100, 150, 200, 250, 300)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--noise", type=float, default=1e-7)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "tf32_drift.json"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_tf32_drift: no CUDA device", file=sys.stderr)
        return 2
    from consistent_depth_tpu_torch import training
    from consistent_depth_tpu_torch.models.registry import create_depth_model
    from consistent_depth_tpu_torch.ops import _cuda, s2d_conv
    from consistent_depth_tpu_torch.ops.losses import LossWeights

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _cuda.build()
    _cuda.library()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    workload = cs.make_train_workload(training, cs.SIZE)
    init = create_depth_model("mc", checkpoint="", seed=0, device="cuda")
    with torch.no_grad():
        init.net.pred_layer.weight.mul_(cs.TAME_HEAD)
        init.net.pred_layer.bias.mul_(cs.TAME_HEAD)
    init_sd = {k: v.clone() for k, v in init.net.state_dict().items()}
    del init

    def engine(sd):
        model = create_depth_model("mc", checkpoint="", device="cuda")
        model.net.load_state_dict(sd)
        return training.TrainingEngine(
            model, training.create_optimizer("Adam", cs.TRAIN_LR),
            LossWeights(lambda_view_baseline=0.1, lambda_reprojection=1.0),
            precision="f32")

    engines = {"kernels": engine(init_sd), "plain": engine(init_sd)}
    for s in args.seeds:
        gen = torch.Generator().manual_seed(s)
        engines[f"noise{s}"] = engine({
            k: (v * (1 + args.noise * torch.randn(
                v.shape, generator=gen, dtype=v.dtype).cuda())
                if v.is_floating_point() else v)
            for k, v in init_sd.items()})
    data = engines["plain"].put_data(workload)
    n_pairs = len(workload["pair_ids"])
    it = training.PairBatchIterator(n_pairs, cs.TRAIN_BATCH, seed=0)
    batches = list(islice(chain.from_iterable(it.epoch(e) for e in count()),
                          args.steps))
    setup_s = time.perf_counter() - t0

    def flat(eng):
        return torch.cat([p.detach().reshape(-1).double()
                          for p in eng.params.values()])

    others = [n for n in engines if n != "plain"]
    loss_gap = {n: [] for n in others}
    param_gap = {n: [] for n in others}
    plain_loss = []
    skipped = {n: 0 for n in engines}
    t0 = time.perf_counter()
    for idx, valid in batches:
        losses = {}
        for name, eng in engines.items():
            ctx = (cs.nullcontext() if name == "kernels"
                   else cs.plain_convs(s2d_conv))
            with ctx:
                m = eng.train_step(data, idx, valid)
            losses[name] = float(m["loss"])
            skipped[name] += int(bool(m["skipped_nan"]))
        ref = flat(engines["plain"])
        ref_norm = float(ref.norm())
        plain_loss.append(losses["plain"])
        for name in others:
            loss_gap[name].append(abs(losses[name] - losses["plain"])
                                  / abs(losses["plain"]))
            param_gap[name].append(float((flat(engines[name]) - ref).norm())
                                   / ref_norm)
    steps_s = time.perf_counter() - t0

    noise = [n for n in others if n != "kernels"]

    def envelope(gaps):
        return [max(gaps[n][t] for n in noise) for t in range(args.steps)]

    env_param, env_loss = envelope(param_gap), envelope(loss_gap)
    above = [param_gap["kernels"][t] > env_param[t]
             for t in range(args.steps)]
    first = next((t + 1 for t, a in enumerate(above) if a), None)
    at = [s for s in REPORT_STEPS if s <= args.steps]
    summary = {
        "steps": args.steps, "noise": args.noise, "seeds": args.seeds,
        "size": list(cs.SIZE), "batch": cs.TRAIN_BATCH, "lr": cs.TRAIN_LR,
        "setup_s": setup_s, "steps_s": steps_s, "skipped_nan": skipped,
        "at_step": at,
        "kernels_loss_gap": [loss_gap["kernels"][s - 1] for s in at],
        "noise_loss_gap_max": [env_loss[s - 1] for s in at],
        "kernels_param_rel_l2": [param_gap["kernels"][s - 1] for s in at],
        "noise_param_rel_l2_max": [env_param[s - 1] for s in at],
        "noise_param_rel_l2_min": [min(param_gap[n][s - 1] for n in noise)
                                   for s in at],
        "kernels_loss_gap_max": max(loss_gap["kernels"]),
        "noise_loss_gap_max_all": max(env_loss),
        "kernels_param_above_noise_first_step": first,
        "kernels_param_above_noise_share_after": (
            sum(above[first - 1:]) / (args.steps - first + 1)
            if first else 0.0),
        "kernels_param_above_noise_steps": sum(above),
        "plain_loss_first_last": [plain_loss[0], plain_loss[-1]],
        "nvidia_smi": smi}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({**summary, "plain_loss": plain_loss,
                   "loss_gap": loss_gap, "param_rel_l2": param_gap}, f)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
