#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

Drives the port's main path, eval-mode MannequinChallenge depth serving
through ``consistent_depth_tpu_torch.serving.DepthServer`` at the model's
full width on 224x384 frames, with random weights from a seed, and checks
the hand-written kernel on that path against its plain PyTorch version.

Phases, each printing one JSON line:

1. device: a CUDA card of compute capability 9.0, its name and power limit;
2. build: compile the CUDA sources of the checkout into ``build/cuda/``;
3. kernels: for every conv shape the main path launches (recorded from one
   batch-8 forward at 224x384), the kernel against ``same_conv_reference``
   in f32 (TF32 off) and bf16, and both times from CUDA events;
4. serve: two interleaved 224x384 videos of 32 frames plus three 230x380
   frames (the 240x384 bucket) at batch 8 in bf16: shapes, finite depths,
   the kernel's launch count, agreement with an f32 server, frames/s; and
   the f32 path on the card against the same model on the CPU.

Then the card's name and power limit as nvidia-smi prints them, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero.

Usage, from the root of a checkout: ``python3 chip_smoke.py``
"""

import json
import math
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE = (224, 384)
ODD_SIZE = (230, 380)      # lands in the 240x384 bucket
FRAMES_PER_VIDEO = 32
ODD_FRAMES = 3
BATCH = 8
# kernel against plain, max |kernel - reference| / max |reference|:
# f32 differs only by summation order (up to 7744 terms at k=11, Ci=64);
# bf16 output is rounded once to 8 mantissa bits (2^-8 relative), against
# an f32 reference on the same bf16-rounded inputs
TOL_F32 = 1e-4
TOL_BF16 = 2 ** -7
# bf16 server against f32 server: relative L2 error of the depth, the band
# of the JAX package's bf16 test (tests/test_bf16.py)
TOL_SERVE_BF16 = 0.05
# f32 on the card against the plain path on the CPU: the hourglass parity
# band of the JAX package's twin test (tests/test_hourglass.py)
TOL_CPU_REF = 1e-4


def require(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=20, warmup=3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def record_conv_classes(torch, s2d_conv, model):
    """The (x shape, w shape) of every same_conv call of one batch-8
    forward at 224x384, with its count."""
    seen = Counter()
    orig = s2d_conv.same_conv

    def recording(x, w, bias=None):
        seen[(tuple(x.shape), tuple(w.shape), bias is not None)] += 1
        return orig(x, w, bias)

    s2d_conv.same_conv = recording
    try:
        with torch.inference_mode():
            model.apply(torch.rand((BATCH, 1, *SIZE, 3), device="cuda"))
    finally:
        s2d_conv.same_conv = orig
    return seen


def check_kernel(torch, s2d_conv, xshape, wshape, has_bias, seed):
    """One conv class: errors in f32 and bf16, kernel and cuDNN times."""
    N, H, W, Ci = xshape
    k, _, _, Co = wshape
    g = torch.Generator(device="cuda").manual_seed(seed)
    # activations and weights with the strides the main path gives them:
    # x an NHWC view of channels_last, w an HWIO view of OIHW channels_last
    x = torch.randn((N, Ci, H, W), generator=g, device="cuda").to(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    w = (torch.randn((Co, Ci, k, k), generator=g, device="cuda")
         / math.sqrt(k * k * Ci)).to(
             memory_format=torch.channels_last).permute(2, 3, 1, 0)
    b = (0.1 * torch.randn((Co,), generator=g, device="cuda")
         if has_bias else None)
    row = {"x": list(xshape), "w": list(wshape)}
    ok = True
    for name, dt, tol in (("f32", torch.float32, TOL_F32),
                          ("bf16", torch.bfloat16, TOL_BF16)):
        xd, wd = x.to(dt), w.to(dt)
        bd = b.to(dt) if b is not None else None
        ref = s2d_conv.same_conv_reference(
            xd.float(), wd.float(), bd.float() if bd is not None else None)
        got = s2d_conv.same_conv(xd, wd, bd).float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        t = [cuda_ms(torch, lambda: s2d_conv.same_conv_reference(xd, wd, bd)),
             cuda_ms(torch, lambda: s2d_conv.same_conv(xd, wd, bd)),
             cuda_ms(torch, lambda: s2d_conv.same_conv(xd, wd, bd)),
             cuda_ms(torch, lambda: s2d_conv.same_conv_reference(xd, wd, bd))]
        row[name] = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
                     "ms": (t[1] + t[2]) / 2, "cudnn_ms": (t[0] + t[3]) / 2}
        ok = ok and math.isfinite(rel) and rel <= tol
    row["pass"] = ok
    return row


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "H100", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from consistent_depth_tpu_torch.models import hourglass
        from consistent_depth_tpu_torch.models.registry import (
            create_depth_model)
        from consistent_depth_tpu_torch.ops import _cuda, s2d_conv
        from consistent_depth_tpu_torch.serving import (
            DepthServer, ServeConfig)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    # -- 1. device --------------------------------------------------------
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(cap), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: the kernels are built for sm_90a and "
                         f"need compute capability 9.0, not {cap}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, REPO)})

    # -- 3. kernel against plain, per conv class of the main path ---------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    probe = create_depth_model("mc", checkpoint="", device="cuda",
                               dtype=torch.bfloat16)
    classes = record_conv_classes(torch, s2d_conv, probe)
    del probe
    n_incep = sum(1 for m in hourglass.HourglassModel().modules()
                  if isinstance(m, hourglass.Inception))
    per_forward = 1 + 3 * n_incep + 1   # stem, k x k branches, merged heads
    rows = []
    for i, ((xs, ws, has_bias), count) in enumerate(sorted(classes.items())):
        row = check_kernel(torch, s2d_conv, xs, ws, has_bias, seed=i)
        row["per_forward"] = count
        rows.append(row)
        emit({"phase": "kernel", **row})
    totals = {dt: {key: sum(r[dt][key] * r["per_forward"] for r in rows)
                   for key in ("ms", "cudnn_ms")} for dt in ("f32", "bf16")}
    emit({"phase": "kernels", "classes": len(rows),
          "launches_per_forward": sum(classes.values()),
          "expected_per_forward": per_forward,
          "per_forward_ms": totals, "nvidia_smi": smi,
          "pass": all(r["pass"] for r in rows)})
    require(all(r["pass"] for r in rows), "kernel disagrees with plain")
    require(sum(classes.values()) == per_forward,
            f"{sum(classes.values())} same_conv calls per forward, "
            f"expected {per_forward}")

    # -- 4. the main path: serving ----------------------------------------
    rng = np.random.default_rng(0)
    videos = {
        "a": rng.random((FRAMES_PER_VIDEO, *SIZE, 3), dtype=np.float32),
        "b": rng.random((FRAMES_PER_VIDEO, *SIZE, 3), dtype=np.float32),
        "c": rng.random((ODD_FRAMES, *ODD_SIZE, 3), dtype=np.float32),
    }
    n_frames = 2 * FRAMES_PER_VIDEO + ODD_FRAMES
    n_batches = 2 * FRAMES_PER_VIDEO // BATCH + math.ceil(ODD_FRAMES / BATCH)
    server = DepthServer(ServeConfig(
        model_type="mc", checkpoint="", precision="bf16", batch_size=BATCH))
    server.infer_videos(videos)            # warm-up
    torch.cuda.synchronize()
    s2d_conv.launches = 0
    t0 = time.perf_counter()
    out = server.infer_videos(videos)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = s2d_conv.launches

    server32 = DepthServer(ServeConfig(
        model_type="mc", checkpoint="", precision="f32", batch_size=BATCH))
    out32 = server32.infer_videos(videos)
    shapes_ok = all(out[v].shape == videos[v].shape[:3] for v in videos)
    finite = all(bool(np.isfinite(out[v]).all()) for v in videos)
    rel_l2 = {v: float(np.linalg.norm(out[v] - out32[v])
                       / np.linalg.norm(out32[v])) for v in videos}
    log32 = np.concatenate([np.log(out32[v]).ravel() for v in videos])
    max_log_diff = max(float(np.abs(np.log(out[v]) - np.log(out32[v])).max())
                       for v in videos)

    # the f32 path on the card against the plain path on the CPU, same
    # seeded weights, on a small input
    small = torch.from_numpy(videos["a"][:2, :96, :128])[None]
    cpu_model = create_depth_model("mc", checkpoint="", device="cpu")
    with torch.inference_mode():
        d_cpu = cpu_model.apply(small).numpy()
        d_gpu = server32.model.apply(small.cuda()).cpu().numpy()
    cpu_err = float(np.abs(d_gpu - d_cpu).max() / np.abs(d_cpu).max())

    serve = {
        "phase": "serve", "frames": n_frames, "batches": n_batches,
        "batch_size": BATCH, "precision": "bf16", "seconds": dt,
        "fps": n_frames / dt, "ms_per_frame": 1e3 * dt / n_frames,
        "launches": launches, "expected_launches": per_forward * n_batches,
        "shapes_ok": shapes_ok, "finite": finite,
        "init_log_depth_range": [float(log32.min()), float(log32.max())],
        "bf16_vs_f32_rel_l2": rel_l2, "bf16_vs_f32_max_log_diff": max_log_diff,
        "tol_rel_l2": TOL_SERVE_BF16,
        "f32_card_vs_cpu_rel_err": cpu_err, "tol_cpu": TOL_CPU_REF,
        "nvidia_smi": smi,
    }
    emit(serve)
    require(shapes_ok, "wrong output shapes")
    require(finite, "non-finite depth")
    require(launches == per_forward * n_batches,
            f"{launches} kernel launches, expected {per_forward * n_batches}")
    require(max(rel_l2.values()) < TOL_SERVE_BF16,
            f"bf16 against f32 depth {rel_l2}")
    require(cpu_err < TOL_CPU_REF, f"card against CPU {cpu_err}")

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "same_conv", "route": "cuda",
        "source": "consistent_depth_tpu_torch/csrc/same_conv.cu",
        "replaces": "consistent_depth_tpu/ops/s2d_conv.py:168",
        "launches": launches,
        "max_abs_err": max(r["f32"]["max_abs_err"] for r in rows),
        "ms": totals["bf16"]["ms"], "plain_ms": totals["bf16"]["cudnn_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
