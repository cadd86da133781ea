#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

Drives the port's two paths with random weights from a seed, each at its
model's full width, and checks every hand-written kernel on them against
its plain PyTorch version:

- eval-mode MannequinChallenge depth serving through
  ``consistent_depth_tpu_torch.serving.DepthServer`` on 224x384 frames
  (kernel: ``csrc/same_conv.cu``);
- full FlowNet2 optical flow (C->S->S + SD + fusion) in f32 through
  ``consistent_depth_tpu_torch.flow.runner.TorchFlowBackend`` at the flow
  stage's 448x1024 feed, then the flow stage's masks and visualisation
  (kernel: ``csrc/correlation.cu``).

Phases, each printing one JSON line:

1. device: a CUDA card of compute capability 9.0, its name and power limit;
2. build: compile the CUDA sources of the checkout into ``build/cuda/``;
3. kernels: for every conv shape the main path launches (recorded from one
   batch-8 forward at 224x384), the kernel against ``same_conv_reference``
   in f32 (TF32 off) and bf16, and both times from CUDA events;
4. serve: two interleaved 224x384 videos of 32 frames plus three 230x380
   frames (the 240x384 bucket) at batch 8 in bf16: shapes, finite depths,
   the kernel's launch count, agreement with an f32 server, frames/s; and
   the f32 path on the card against the same model on the CPU;
5. correlation: the kernel against ``correlation_reference`` in f32 at the
   shape recorded from one FlowNet2 forward at 448x1024 (1x56x128x256),
   at 2x56x128x256, at 1x72x128x256 (the 576x1024 feed), at a ragged
   1x7x13x64, and with max displacement 4; both times from CUDA events;
6. flow: FlowNet2 on four directed pairs of 448x1024 frames: shapes,
   finite flow, one correlation launch per pair, agreement with the same
   network using ``correlation_reference``, the card against the CPU on a
   64x128 pair, ms per pair; then ``consistent_flow_masks`` and
   ``flow_to_image_torch`` on those flows against the CPU, and the flow
   stage's mask and visualisation passes (``pipeline.flow_stage.Flow``) on
   the card, whose masks must match the CPU's.

Then the card's name and power limit as nvidia-smi prints them, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero.

Usage, from the root of a checkout: ``python3 chip_smoke.py``
"""

import json
import math
import os
import shutil
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
# flow path: the FlowNet2 feed of the pipeline (process.py aligns frames to
# 64, at most 1024 wide), one pair per forward, f32
FLOW_SIZE = (448, 1024)
FLOW_PAIRS = [(0, 1), (1, 0), (1, 2), (2, 1)]
# correlation against plain, max |kernel - reference| / max |reference|:
# one f32 sum over C = 256 channels taken in another order
TOL_CORR = 1e-5
# (name, (B, H, W, C), max_displacement, stride); the first is checked
# against the shape recorded from the FlowNet2 forward
CORR_CASES = [
    ("flownet2_448x1024", (1, 56, 128, 256), 20, 2),
    ("bench_2x56x128", (2, 56, 128, 256), 20, 2),
    ("feed_576x1024", (1, 72, 128, 256), 20, 2),
    ("ragged", (1, 7, 13, 64), 20, 2),
    ("max_disp_4", (1, 56, 128, 256), 4, 2),
]
# FlowNet2 with the kernel against FlowNet2 with correlation_reference, and
# the card against the CPU: max |d| / max |flow|, the cascade band of
# tests/test_torch_flownet.py (only summation orders differ)
TOL_FLOW = 1e-4
# masks may differ where an f32 sum lies within rounding of its threshold;
# colours by one level where floor() meets a rounding difference
TOL_MASK_FRACTION = 1e-3
TOL_COLOUR_LEVELS = 1.0


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


def check_correlation(torch, corr, name, shape, max_disp, stride, seed):
    """One correlation case: error against the plain version and both
    times, from inputs with the strides the flow path gives them (NHWC
    views of channels_last NCHW activations)."""
    B, H, W, C = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    f1, f2 = (torch.randn((B, C, H, W), generator=g, device="cuda").to(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for _ in range(2))
    ref = corr.correlation_reference(f1, f2, max_disp, stride)
    got = corr.correlation(f1, f2, max_disp, stride)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    t = [cuda_ms(torch, lambda: corr.correlation_reference(
            f1, f2, max_disp, stride)),
         cuda_ms(torch, lambda: corr.correlation(f1, f2, max_disp, stride)),
         cuda_ms(torch, lambda: corr.correlation(f1, f2, max_disp, stride)),
         cuda_ms(torch, lambda: corr.correlation_reference(
             f1, f2, max_disp, stride))]
    return {"case": name, "shape": list(shape), "max_displacement": max_disp,
            "stride": stride, "out": list(got.shape), "max_abs_err": err,
            "max_rel_err": rel, "tol_rel": TOL_CORR,
            "ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
            "pass": math.isfinite(rel) and rel <= TOL_CORR}


def record_correlation_shapes(torch, corr, backend, frames):
    """The (f1 shape, max_displacement, stride) of every correlation call
    of one FlowNet2 forward on ``frames``."""
    seen = []
    orig = corr.correlation

    def recording(f1, f2, max_displacement=20, stride=2):
        seen.append((tuple(f1.shape), max_displacement, stride))
        return orig(f1, f2, max_displacement, stride)

    corr.correlation = recording
    try:
        backend.compute_pair(*frames)
    finally:
        corr.correlation = orig
    return seen


def rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def drive_flow_stage(image_io, Flow, flows, frames, work_dir):
    """The flow stage's mask and visualisation passes on the card, over
    flow/ and color_down/ files holding ``flows`` and ``frames``. Returns
    the masks it wrote, by pair, and the panel and warped-frame files."""
    import cv2

    shutil.rmtree(work_dir, ignore_errors=True)
    for sub in ("flow", "color_down"):
        os.makedirs(os.path.join(work_dir, sub))
    for i, frame in enumerate(frames):
        image_io.save_raw_float32_image(
            os.path.join(work_dir, "color_down", f"frame_{i:06d}.raw"), frame)
    for (i, j), flow in zip(FLOW_PAIRS, flows):
        image_io.save_raw_float32_image(
            os.path.join(work_dir, "flow", f"flow_{i:06d}_{j:06d}.raw"), flow)
    stage = Flow(work_dir, work_dir, device="cuda")
    stage.mask_valid_correspondences(batch_pairs=1)
    stage.visualize_flow(warp=True, batch_pairs=1)
    masks = {p: cv2.imread(os.path.join(
        work_dir, "mask", "mask_{:06d}_{:06d}.png".format(*p)), 0)
        for p in FLOW_PAIRS}
    panels = sorted(os.listdir(os.path.join(work_dir, "vis_flow")))
    warped = sorted(os.listdir(os.path.join(work_dir, "vis_flow_warped")))
    shutil.rmtree(work_dir)
    return masks, panels, warped


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
        from consistent_depth_tpu_torch.flow import correlation as corr
        from consistent_depth_tpu_torch.flow.backends import image_io
        from consistent_depth_tpu_torch.flow.runner import TorchFlowBackend
        from consistent_depth_tpu_torch.models import hourglass
        from consistent_depth_tpu_torch.models.registry import (
            create_depth_model)
        from consistent_depth_tpu_torch.ops import _cuda, s2d_conv
        from consistent_depth_tpu_torch.ops.consistency import (
            consistent_flow_masks)
        from consistent_depth_tpu_torch.ops.flow_viz import (
            flow_to_image_torch)
        from consistent_depth_tpu_torch.pipeline.flow_stage import Flow
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
    s2d_conv.launches = corr.launches = 0
    t0 = time.perf_counter()
    out = server.infer_videos(videos)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = s2d_conv.launches
    serve_corr_launches = corr.launches

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
        "correlation_launches": serve_corr_launches,
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

    # -- 5. correlation kernel against plain ------------------------------
    del server, server32, cpu_model
    torch.cuda.empty_cache()
    flow_rng = np.random.default_rng(1)
    frames = [flow_rng.random((*FLOW_SIZE, 3), dtype=np.float32)
              for _ in range(3)]
    backend = TorchFlowBackend(checkpoint=None, full=True, homography=False,
                               seed=0, device="cuda")
    recorded = record_correlation_shapes(torch, corr, backend, frames[:2])
    corr_rows = []
    for i, (name, shape, md, st) in enumerate(CORR_CASES):
        row = check_correlation(torch, corr, name, shape, md, st, seed=i)
        corr_rows.append(row)
        emit({"phase": "correlation", **row, "nvidia_smi": smi})
    main_row = corr_rows[0]
    emit({"phase": "correlations", "recorded_per_forward": [
        list(r) for r in recorded], "nvidia_smi": smi,
        "pass": all(r["pass"] for r in corr_rows)})
    require(recorded == [(CORR_CASES[0][1], 20, 2)],
            f"FlowNet2 at {FLOW_SIZE} made correlation calls {recorded}")
    require(all(r["pass"] for r in corr_rows),
            "correlation kernel disagrees with plain")

    # -- 6. the flow path: FlowNet2 at 448x1024, masks, visualisation -----
    backend.compute_pair(frames[0], frames[1])        # warm-up
    torch.cuda.synchronize()
    s2d_conv.launches = corr.launches = 0
    t0 = time.perf_counter()
    flows = [backend.compute_pair(frames[i], frames[j]) for i, j in FLOW_PAIRS]
    torch.cuda.synchronize()
    flow_dt = time.perf_counter() - t0
    flow_launches = corr.launches
    flow_conv_launches = s2d_conv.launches

    orig = corr.correlation
    corr.correlation = corr.correlation_reference
    try:
        plain_flows = [backend.compute_pair(frames[i], frames[j])
                       for i, j in FLOW_PAIRS]
    finally:
        corr.correlation = orig
    plain_err = max(rel_err(f, p) for f, p in zip(flows, plain_flows))

    small = [f[:64, :128] for f in frames[:2]]
    cpu_backend = TorchFlowBackend(checkpoint=None, full=True,
                                   homography=False, seed=0, device="cpu")
    flow_cpu_err = rel_err(backend.compute_pair(*small),
                           cpu_backend.compute_pair(*small))
    del cpu_backend

    pair_flows = np.stack([np.stack(flows[0:2]), np.stack(flows[2:4])])
    pair_colors = np.stack([np.stack(frames[0:2]), np.stack(frames[1:3])])
    with torch.inference_mode():
        masks_gpu = consistent_flow_masks(
            torch.from_numpy(pair_flows).cuda(),
            torch.from_numpy(pair_colors).cuda()).cpu().numpy()
        masks_cpu = consistent_flow_masks(
            torch.from_numpy(pair_flows),
            torch.from_numpy(pair_colors)).numpy()
        flat = torch.from_numpy(np.stack(flows))
        colours_gpu = flow_to_image_torch(flat.cuda()).cpu().numpy()
        colours_cpu = flow_to_image_torch(flat).numpy()
    mask_diff = float(np.mean(masks_gpu != masks_cpu))
    colour_diff = float(np.abs(colours_gpu - colours_cpu).max())
    stage_masks, panels, warped = drive_flow_stage(
        image_io, Flow, flows, frames,
        os.path.join(REPO, "build", "chip_smoke_flow"))
    # FLOW_PAIRS in order are pair 0 both ways, then pair 1 both ways
    cpu_by_pair = dict(zip(FLOW_PAIRS, masks_cpu.reshape(4, *FLOW_SIZE)))
    stage_mask_diff = max(float(np.mean((stage_masks[p] > 0)
                                        != cpu_by_pair[p]))
                          for p in FLOW_PAIRS)

    ms_pair = 1e3 * flow_dt / len(FLOW_PAIRS)
    flow_shapes_ok = all(f.shape == (*FLOW_SIZE, 2) for f in flows)
    flow_finite = all(bool(np.isfinite(f).all()) for f in flows)
    emit({
        "phase": "flow", "size": list(FLOW_SIZE), "pairs": len(FLOW_PAIRS),
        "network": type(backend.net).__name__, "precision": "f32",
        "seconds": flow_dt, "ms_per_pair": ms_pair,
        "correlation_ms": main_row["ms"],
        "correlation_share": main_row["ms"] / ms_pair,
        "launches": flow_launches, "expected_launches": len(FLOW_PAIRS),
        "same_conv_launches": flow_conv_launches,
        "shapes_ok": flow_shapes_ok, "finite": flow_finite,
        "max_abs_flow": max(float(np.abs(f).max()) for f in flows),
        "kernel_vs_plain_rel_err": plain_err, "tol_plain": TOL_FLOW,
        "card_vs_cpu_rel_err": flow_cpu_err, "tol_cpu": TOL_FLOW,
        "mask_kept_fraction": float(masks_cpu.mean()),
        "mask_card_vs_cpu_fraction": mask_diff,
        "stage_mask_vs_cpu_fraction": stage_mask_diff,
        "tol_mask_fraction": TOL_MASK_FRACTION,
        "colour_card_vs_cpu_levels": colour_diff,
        "tol_colour_levels": TOL_COLOUR_LEVELS,
        "stage_panels": len(panels), "stage_warped": len(warped),
        "nvidia_smi": smi,
    })
    require(flow_shapes_ok, "wrong flow shapes")
    require(flow_finite, "non-finite flow")
    require(flow_launches == len(FLOW_PAIRS),
            f"{flow_launches} correlation launches for {len(FLOW_PAIRS)} "
            "pairs")
    require(flow_conv_launches == 0, "FlowNet2 launched same_conv")
    require(plain_err < TOL_FLOW, f"flow with kernel vs plain {plain_err}")
    require(flow_cpu_err < TOL_FLOW, f"flow card vs CPU {flow_cpu_err}")
    require(mask_diff <= TOL_MASK_FRACTION, f"masks card vs CPU {mask_diff}")
    require(stage_mask_diff <= TOL_MASK_FRACTION,
            f"stage masks vs CPU {stage_mask_diff}")
    require(colour_diff <= TOL_COLOUR_LEVELS,
            f"flow colours card vs CPU {colour_diff}")
    require(len(panels) == 2 and len(warped) == 4,
            f"stage wrote {len(panels)} panels, {len(warped)} warped frames")

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "same_conv", "route": "cuda",
        "source": "consistent_depth_tpu_torch/csrc/same_conv.cu",
        "replaces": "consistent_depth_tpu/ops/s2d_conv.py:168",
        "launches": launches,
        "max_abs_err": max(r["f32"]["max_abs_err"] for r in rows),
        "ms": totals["bf16"]["ms"], "plain_ms": totals["bf16"]["cudnn_ms"],
    }, {
        "name": "correlation", "route": "cuda",
        "source": "consistent_depth_tpu_torch/csrc/correlation.cu",
        "replaces": "consistent_depth_tpu/flow/correlation.py:116",
        "launches": flow_launches,
        "max_abs_err": max(r["max_abs_err"] for r in corr_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
