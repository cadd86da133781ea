#!/usr/bin/env python3
"""Where a backbone's f32 error on the card comes from, at the 64x96
card-against-CPU check of ``chip_smoke.backbone_path``: the same seeded,
tamed network (``chip_smoke.seed_backbone``'s weights) and the same two
pairs of ``chip_smoke.make_train_workload``'s data, one eval-mode loss and
backward per configuration, each held against the CPU in f64.

Configurations:

- ``cpu_f32``, ``card_f32`` (the kernels), ``card_f32_plain``
  (``same_conv_reference``, cuDNN, in place of the kernel),
  ``card_f32_nocudnn`` and ``card_f32_plain_nocudnn`` (cuDNN disabled: the
  convs outside the kernel take PyTorch's native CUDA convolutions),
  ``card_f64``;
- ``<device>_f64_<group>_f32``: the network in f64 but one group of modules
  in f32 (``routed``: the k x k convs through the kernel, ``routed_plain``:
  the same convs on cuDNN, ``grouped``: the grouped 3x3 convs, ``conv1x1``,
  ``stem``, ``bn``), which shows each group's own share;
- ``card_f32_<group>_f64``: the network in f32 but one group in f64.

Then ``cpu_f32``, ``card_f32`` and ``card_f32_plain`` again with
lambda_view_baseline 1, against the CPU's f64 at that weight.

Prints the card's name and power limit as nvidia-smi gives them, then one
JSON line per configuration: the eval loss's relative error, the network's
output's relative L2 error (midas2: 1/depth less the output conv's bias,
the part of the disparity the network computes; monodepth2: the depth),
the gradients' relative L2 error over all parameters, and the five
parameters that carry most of it.

Usage, from the root of a checkout: ``python3 tools/torch_backbone_precision.py
[--backbone midas2] [--out build/precision.jsonl]``
"""

import argparse
import copy
import json
import os
import sys
import tempfile
from contextlib import contextmanager, nullcontext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

GROUPS = ("routed", "routed_plain", "grouped", "conv1x1", "stem", "bn")


def group_of(m, torch):
    """The group of a module, or None."""
    nn = torch.nn
    if isinstance(m, nn.BatchNorm2d):
        return "bn"
    if not isinstance(m, nn.Conv2d):
        return None
    if getattr(m, "routed", False):
        return "routed"
    if m.groups > 1:
        return "grouped"
    if m.kernel_size == (1, 1):
        return "conv1x1"
    return "stem"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backbone", default="midas2", choices=cs.BACKBONES)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_backbone_precision: no CUDA device", file=sys.stderr)
        return 2
    from consistent_depth_tpu_torch import training
    from consistent_depth_tpu_torch.models import torch_import
    from consistent_depth_tpu_torch.models.registry import (
        create_depth_model, get_depth_model)
    from consistent_depth_tpu_torch.ops import _cuda, s2d_conv
    from consistent_depth_tpu_torch.ops.losses import LossWeights

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _cuda.build()
    _cuda.library()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cls = get_depth_model(args.backbone)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cs.seed_backbone(torch, args.backbone, create_depth_model,
                         torch_import, ckpt_dir)
        with cs.env_var("CDTPU_CHECKPOINT_DIR", ckpt_dir):
            base = create_depth_model(args.backbone, device="cpu")
    small = {k: v[:2] if k != "frames" else v for k, v in
             cs.make_train_workload(training, cs.TRAIN_SMALL_SIZE).items()}

    # routed convs: the kernel in f32 and bf16 unless ``plain`` is set;
    # same_conv_reference in f64, which the kernel does not take
    real_conv = s2d_conv.same_conv
    plain = {"on": False}

    def dispatch(x, w, bias=None):
        if plain["on"] or x.dtype == torch.float64:
            return s2d_conv.same_conv_reference(x, w, bias)
        return real_conv(x, w, bias)

    s2d_conv.same_conv = dispatch

    @contextmanager
    def island(net, group, dtype):
        """Modules of ``group`` compute in ``dtype``, the rest in the
        net's own."""
        saved = []
        kind = "routed" if group == "routed_plain" else group
        for m in net.modules():
            if group_of(m, torch) != kind:
                continue
            outer = m.forward

            def fwd(x, m=m, outer=outer):
                if isinstance(m, torch.nn.BatchNorm2d):
                    p = [t.to(dtype) for t in (m.running_mean, m.running_var,
                                               m.weight, m.bias)]
                    y = F.batch_norm(x.to(dtype), *p, False, 0.0, m.eps)
                else:
                    y = outer(x.to(dtype))
                return y.to(x.dtype)

            m.forward = fwd
            saved.append(m)
        plain["on"] = group == "routed_plain"
        try:
            yield
        finally:
            plain["on"] = False
            for m in saved:
                del m.forward

    def run(device, dtype, nocudnn=False, group=None, group_dtype=None,
            lvb=cls.lambda_view_baseline):
        """The engine after one eval-mode loss and backward, the loss and
        the network's own part of the disparity (1/depth less the output
        conv's bias, midas2) or the depth (monodepth2), in f64 on the
        host."""
        model = copy.deepcopy(base)
        model.to(device, torch.float32)
        engine = training.TrainingEngine(
            model, training.create_optimizer("Adam", cls.learning_rate),
            LossWeights(lambda_view_baseline=lvb,
                        lambda_reprojection=1.0), precision="f32")
        d = engine.put_data(small)
        if dtype == torch.float64:
            model.net.double()
            model.compute_dtype = dtype
            d = {k: v.double() if v.is_floating_point() else v
                 for k, v in d.items()}
        idx, valid = engine._indices([0, 1], [1.0, 1.0])
        batch = training.gather_batch(d, idx)
        torch.backends.cudnn.enabled = not nocudnn
        try:
            with (island(model.net, group, group_dtype) if group
                  else nullcontext()):
                engine.optimizer.zero_grad(set_to_none=True)
                loss, _, depth = engine._loss(batch, valid.to(dtype),
                                              train=False)
                loss.backward()
        finally:
            torch.backends.cudnn.enabled = True
        out = depth.detach().double().cpu()
        if args.backbone == "midas2":
            out = 1.0 / out - float(model.net.scratch.output_conv[4].bias)
        return engine, loss.item(), out

    def measure(name, device, dtype, ref=None, **kw):
        engine, loss, out = run(device, dtype, **kw)
        grads = cs.grads_of(engine)
        del engine
        if ref is None:
            return grads, loss, out
        num = {k: float((grads[k] - ref[0][k]).square().sum())
               for k in ref[0]}
        den = sum(float(g.square().sum()) for g in ref[0].values())
        top = sorted(num.items(), key=lambda kv: -kv[1])[:5]
        rec = {"config": name, "loss_rel": abs(loss - ref[1]) / abs(ref[1]),
               "grads_rel_l2": (sum(num.values()) / den) ** 0.5,
               "output_rel_l2": float((out - ref[2]).norm() / ref[2].norm()),
               "top": [[k, (v / den) ** 0.5] for k, v in top],
               "nvidia_smi": smi}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        return grads, loss, out

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
    ref = measure("cpu_f64", "cpu", torch.float64)
    f32, f64 = torch.float32, torch.float64
    measure("cpu_f32", "cpu", f32, ref)
    measure("card_f64", "cuda", f64, ref)
    measure("card_f32", "cuda", f32, ref)
    measure("card_f32_nocudnn", "cuda", f32, ref, nocudnn=True)
    plain["on"] = True
    measure("card_f32_plain", "cuda", f32, ref)
    measure("card_f32_plain_nocudnn", "cuda", f32, ref, nocudnn=True)
    plain["on"] = False
    for group in GROUPS:
        for device, tag in (("cpu", "cpu"), ("cuda", "card")):
            if device == "cpu" and group == "routed_plain":
                continue
            measure(f"{tag}_f64_{group}_f32", device, f64, ref,
                    group=group, group_dtype=f32)
    for group in GROUPS:
        if group != "routed_plain":
            measure(f"card_f32_{group}_f64", "cuda", f32, ref,
                    group=group, group_dtype=f64)
    # the same at lambda_view_baseline 1 (monodepth2's), where the loss's
    # gradient is not the view-baseline term's alone
    ref1 = measure("cpu_f64_lvb1", "cpu", f64, lvb=1.0)
    measure("cpu_f32_lvb1", "cpu", f32, ref1, lvb=1.0)
    measure("card_f32_lvb1", "cuda", f32, ref1, lvb=1.0)
    plain["on"] = True
    measure("card_f32_plain_lvb1", "cuda", f32, ref1, lvb=1.0)
    plain["on"] = False
    s2d_conv.same_conv = real_conv
    return 0


if __name__ == "__main__":
    sys.exit(main())
