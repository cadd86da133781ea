#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone, on one NVIDIA H100: the port's CLI
on the 24-frame plane-scene directory (``chip_smoke.cli_path``), in-process
and then cached as ``python -m consistent_depth_tpu_torch``, with every
check of that phase. Prints the card's name and power limit as nvidia-smi
gives them, then the phase's JSON line, whose ``stage_s`` holds the host
seconds of each stage. Here the CLI's first stages pay the process's CUDA
and cuDNN set-up, which the earlier phases pay in the whole script. With
``--backbones``, phases 12-13 (``chip_smoke.backbone_path``) follow on the
same directory and on phase 8's workload, rebuilt here, with every check of
those phases.

Usage, from the root of a checkout: ``python3 tools/torch_cli_stages.py
[--backbones midas2 monodepth2]``
"""

import argparse
import os
import shutil
import sys
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backbones", nargs="*", default=[],
                        choices=cs.BACKBONES)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_cli_stages: no CUDA device", file=sys.stderr)
        return 2
    from consistent_depth_tpu_torch import training
    from consistent_depth_tpu_torch.flow import correlation as corr
    from consistent_depth_tpu_torch.models import hourglass
    from consistent_depth_tpu_torch.models.registry import create_depth_model
    from consistent_depth_tpu_torch.ops import _cuda, s2d_conv
    from consistent_depth_tpu_torch.ops.losses import LossWeights
    from consistent_depth_tpu_torch.serving import DepthServer, ServeConfig

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _cuda.build()
    _cuda.library()
    # as the whole script leaves them: f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init = create_depth_model("mc", checkpoint="", seed=0, device="cuda")
    with torch.no_grad():
        init.net.pred_layer.weight.mul_(cs.TAME_HEAD)
        init.net.pred_layer.bias.mul_(cs.TAME_HEAD)
    init_sd = {k: v.clone() for k, v in init.net.state_dict().items()}
    del init
    n_incep = sum(1 for m in hourglass.HourglassModel().modules()
                  if isinstance(m, hourglass.Inception))
    # the f32 routes per forward and per train step by the plan: a step's
    # grad-inputs are the forward's classes on their outputs' shapes, but
    # the stem's (its 3-channel input needs no gradient)
    probe = create_depth_model("mc", checkpoint="", device="cuda")
    classes = cs.record_conv_classes(torch, s2d_conv, probe)
    del probe
    gx = Counter({((*x[:3], w[3]), w): n for (x, w, _), n in classes.items()
                  if x[3] != 3})
    f32_routes = {f"forward_{r}": n for r, n in cs.expected_routes(
        s2d_conv, classes, torch.float32, False).items()}
    f32_routes.update({f"grad_input_{r}": n for r, n in cs.expected_routes(
        s2d_conv, gx, torch.float32, True).items()})
    mods = cs.cli_modules(training)
    try:
        cs.cli_path(torch, smi, mods, s2d_conv, corr, 1 + 3 * n_incep + 1,
                    init_sd, f32_routes, keep=True)
        if args.backbones:
            engine = training.TrainingEngine(
                create_depth_model("mc", checkpoint="", device="cuda"),
                training.create_optimizer("Adam", cs.TRAIN_LR), LossWeights())
            data = engine.put_data(cs.make_train_workload(training, cs.SIZE))
            del engine
        for name in args.backbones:
            torch.cuda.empty_cache()
            cs.backbone_path(torch, smi, name, training, s2d_conv, mods,
                             LossWeights, DepthServer, ServeConfig, data,
                             cs.CLI_DIR)
    finally:
        shutil.rmtree(cs.CLI_DIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
