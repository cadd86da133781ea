#!/usr/bin/env python3
"""How far apart two CLI runs end after training, on the CPU: the spread
that ``tests/test_torch_cli.py``'s post-training bands must clear.

On the golden fixture of ``tests/synthetic.py`` (6 frames at 32x48), runs
of the whole pipeline from the JAX seed-0 ``mc`` weights, each in its
own directory: the JAX CLI on one device (``use_mesh = False``), the
port's CLI, the port's CLI at each other torch thread count of
``--threads``, and the port's CLI from the same weights times
(1 + noise z), z standard normal from a seed, for each noise of
``--noise`` and each seed of ``--seeds``. Prints, for the port against
each other run, the largest relative gap of the eval loss means before
and after training, the post-training gap of each (eval, loss key), and
the largest relative RMSE of the final depth maps
(``tools/compare_artifacts.py``), with the post-training means of the
port and the JAX runs, as one JSON line. At the settings
the goldens were made with (``--head 1 --lr 0``: untamed, the CLI's default
lr), it also holds the JAX and the port runs against ``tests/golden/e2e``
(an 8-device run): the largest relative gap of the eval means before and
after training and the final-depth RMSE max.

    JAX_PLATFORMS=cpu python tools/torch_cli_noise_probe.py \
        [--lr 4e-5] [--head 0.05] [--batch_size 2] [--threads 2 [4 ...]] \
        [--noise 1e-7 [1e-6 ...]] [--seeds 0 [1 ...]]

``--head`` scales the prediction head of the seed-0 weights (1 leaves
them untamed). ``--batch_size`` is the batch of every run, all on one
device: 16 is the goldens' global batch (8 devices at 2). Needs both
packages, so it runs where the tests run.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
from os.path import join as pjoin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, pjoin(REPO, "tests"), pjoin(REPO, "tools")]

RANGE = "R_hierarchical2_mc"
GOLDEN = pjoin(REPO, "tests", "golden", "e2e")


def _tag_dir(path):
    (tag,) = [d for d in os.listdir(pjoin(path, RANGE)) if d.startswith("B")]
    return pjoin(path, RANGE, tag)


def _post_means(path):
    """{(eval file, loss key): mean} of the eval passes after training."""
    out = {}
    for f in sorted(glob.glob(pjoin(_tag_dir(path), "eval", "loss_e*.json"))):
        name = os.path.basename(f)
        if name.startswith("loss_e0000_"):
            continue
        with open(f) as fh:
            for k, v in json.load(fh)["mean"].items():
                out[f"{name[:10]} {k}"] = v
    return out


def _mean_gap(eval_a, eval_b, pre):
    """Largest relative gap of the eval loss means, over the pre-training
    eval (``pre``) or over the later ones."""
    gap = 0.0
    for f in glob.glob(pjoin(eval_b, "loss_e*.json")):
        name = os.path.basename(f)
        if name.startswith("loss_e0000_") != pre:
            continue
        with open(pjoin(eval_a, name)) as fa, open(f) as fb:
            ma, mb = json.load(fa)["mean"], json.load(fb)["mean"]
        gap = max(gap, *(abs(ma[k] - mb[k]) / abs(mb[k]) for k in mb))
    return gap


def _compare(port, other):
    """Port run against another: the pre- and post-training gaps of the
    eval means, the post-training gap of each (eval, key), and the final
    depth's RMSE max."""
    import compare_artifacts as ca

    a, b = _post_means(port), _post_means(other)
    d = ca.compare_depth_dirs(pjoin(_tag_dir(other), "depth"),
                              pjoin(_tag_dir(port), "depth"))
    return {
        "pre_eval_mean_gap": _mean_gap(pjoin(_tag_dir(port), "eval"),
                                       pjoin(_tag_dir(other), "eval"),
                                       pre=True),
        "post_eval_mean_gap": max(abs(a[k] - b[k]) / abs(b[k]) for k in b),
        "post_gap_by_eval_key": {k: abs(a[k] - b[k]) / abs(b[k]) for k in b},
        "final_depth_rmse_max": d["rmse_max"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", default="4e-5")
    ap.add_argument("--head", type=float, default=0.05)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--threads", type=int, nargs="+", default=[2],
                    help="torch threads: the first for the port's run and "
                    "the perturbed runs, each other for one more port run")
    ap.add_argument("--noise", type=float, nargs="+", default=[1e-7])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="noise seeds, one perturbed run per (noise, seed)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    import compare_artifacts as ca
    import synthetic
    from consistent_depth_tpu.cli.params import (
        Video3dParamsParser as JaxParser)
    from consistent_depth_tpu.models import torch_import as jax_ti
    from consistent_depth_tpu.models.mannequin_challenge import (
        MannequinChallengeModel as JaxMC)
    from consistent_depth_tpu.pipeline.process import (
        DatasetProcessor as JaxProcessor)
    from consistent_depth_tpu_torch.cli.params import Video3dParamsParser
    from consistent_depth_tpu_torch.models import torch_import
    from consistent_depth_tpu_torch.pipeline.process import DatasetProcessor

    argv = synthetic.E2E_PIPELINE_ARGS + ["--learning_rate", args.lr,
                                          "--batch_size",
                                          str(args.batch_size)]
    with tempfile.TemporaryDirectory() as work:
        variables = jax.tree_util.tree_map(
            np.asarray, JaxMC(checkpoint="", seed=0).variables)
        params = dict(variables["params"])
        params["pred_layer"] = {k: v * np.float32(args.head)
                                for k, v in params["pred_layer"].items()}
        weights = pjoin(work, "seed0.pth")
        jax_ti.save_torch_checkpoint(weights, {**variables,
                                               "params": params})
        runs = [("jax", weights, args.threads[0]),
                ("port", weights, args.threads[0])]
        runs += [(f"port_threads{t}", weights, t) for t in args.threads[1:]]
        clean = torch_import.load_checkpoint(weights)
        for noise in args.noise:
            for seed in args.seeds:
                gen = torch.Generator().manual_seed(seed)
                noisy = {k: (v * (1 + noise * torch.randn(
                             v.shape, generator=gen, dtype=v.dtype))
                             if v.is_floating_point() else v)
                         for k, v in clean.items()}
                name = f"port_noise{noise:g}_seed{seed}"
                torch_import.save_checkpoint(pjoin(work, name + ".pth"),
                                             noisy)
                runs.append((name, pjoin(work, name + ".pth"),
                             args.threads[0]))

        paths = {}
        for name, ckpt, threads in runs:
            torch.set_num_threads(threads)
            path = paths[name] = pjoin(work, name)
            os.makedirs(path)
            synthetic.build_e2e_dataset(path)
            if name == "jax":
                p = JaxParser().parse(["--path", path] + argv)
                p.model_checkpoint, p.use_mesh = ckpt, False
                JaxProcessor().process(p)
            else:
                p = Video3dParamsParser().parse(["--path", path] + argv)
                p.model_checkpoint = ckpt
                DatasetProcessor(device="cpu").process(p)

        result = {"lr": args.lr, "head": args.head,
                  "batch_size": args.batch_size, "threads": args.threads,
                  "noise": args.noise, "seeds": args.seeds,
                  "port_post_means": _post_means(paths["port"]),
                  "jax_post_means": _post_means(paths["jax"])}
        for name in paths:
            if name != "port":
                result["port_vs_" + name] = _compare(paths["port"],
                                                     paths[name])
        # the goldens' settings: untamed weights, lr resolved to 4e-4
        if args.head == 1 and _tag_dir(paths["jax"]).endswith(
                "_LR0.0004_BS%d_Oadam" % args.batch_size):
            for name in ("jax", "port"):
                d = ca.compare_depth_dirs(pjoin(GOLDEN, "final_depth"),
                                          pjoin(_tag_dir(paths[name]), "depth"))
                result[name + "_vs_golden"] = {
                    "pre_eval_mean_gap": _mean_gap(
                        pjoin(_tag_dir(paths[name]), "eval"),
                        pjoin(GOLDEN, "eval"), pre=True),
                    "post_eval_mean_gap": _mean_gap(
                        pjoin(_tag_dir(paths[name]), "eval"),
                        pjoin(GOLDEN, "eval"), pre=False),
                    "final_depth_rmse_max": d["rmse_max"]}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
