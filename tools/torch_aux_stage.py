#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone, on one NVIDIA H100: ``mc``'s
``DepthModel.save``, reload and ``forward`` at full width (the k x k conv
kernel's f32 route), ``calibrate_scale``, the weighted losses and one
calibration render against the CPU, and the sparse calibration of a model
written by the port's COLMAP writer at a known scale
(``chip_smoke.aux_path``), with every check of that phase. Prints the
card's name and power limit as nvidia-smi gives them, then the phase's
JSON line.

Usage, from the root of a checkout: ``python3 tools/torch_aux_stage.py``
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_aux_stage: no CUDA device", file=sys.stderr)
        return 2
    from consistent_depth_tpu_torch.models.registry import create_depth_model
    from consistent_depth_tpu_torch.ops import _cuda, s2d_conv

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
    classes = cs.record_conv_classes(torch, s2d_conv, init)
    del init
    cs.aux_path(torch, smi, s2d_conv, init_sd, classes,
                sum(classes.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
