#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

Drives the port's three paths with random weights from a seed, each at
its model's full width, and checks every hand-written kernel on them
against its plain PyTorch version:

- eval-mode MannequinChallenge depth serving through
  ``consistent_depth_tpu_torch.serving.DepthServer`` on 224x384 frames
  (kernels: ``csrc/same_conv_tc.cu`` for bf16 and ``csrc/same_conv_tf32.cu``
  for f32, both on the tensor cores; ``csrc/same_conv.cu``, the FMA
  template, for the shapes they do not take);
- full FlowNet2 optical flow (C->S->S + SD + fusion) in f32 through
  ``consistent_depth_tpu_torch.flow.runner.TorchFlowBackend`` at the flow
  stage's 448x1024 feed, then the flow stage's masks and visualisation
  (kernel: ``csrc/correlation.cu``);
- the ``mc`` fine-tune train step through
  ``consistent_depth_tpu_torch.training.TrainingEngine.train_step`` on the
  reference demo workload of ``bench.py::make_workload`` (244 frames at
  224x384, the hierarchical2 pair set of 715 pairs, batch 4 pairs), in
  bf16 and f32, f32 being the fine-tune's default precision (the same
  kernels, forward and grad-input).

Phases, each printing one JSON line:

1. device: a CUDA card of compute capability 9.0, its name and power limit;
2. build: compile the CUDA sources of the checkout into ``build/cuda/``;
3. kernels: for every conv shape the main path launches (recorded from one
   batch-8 forward at 224x384), the kernel of the plan's route against
   ``same_conv_reference`` in f32 (TF32 off) and bf16, both times from
   CUDA events (in f32 also the FMA template's, the design the 3xTF32
   kernel replaced), the class's GFLOP, its bound by route (the larger of
   its operations over the route's peak and its bytes over 3.35 TB/s; f32
   rows give the 3xTF32 and the FMA bound), TFLOP/s and share of the
   bound; then, untimed, ragged cases (1x7x13 k=11 64->16, 2x14x24
   32->64), the stem's grad-input (2x64x96, which takes the FMA template
   in both dtypes) and every class of the train phase's 64x96 check, in
   both directions;
4. serve: two interleaved 224x384 videos of 32 frames plus three 230x380
   frames (the 240x384 bucket) at batch 8 in bf16: shapes, finite depths,
   the kernels' launch counts by route, agreement with an f32 server,
   frames/s; and the f32 path on the card against the same model on the
   CPU;
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
   the card, whose masks must match the CPU's;
7. grad-input kernel: for every (cotangent, weight) shape that one bf16
   train step sends through ``same_conv_grad_input``, the kernel of the
   plan's route against ``same_conv_grad_input_reference`` in f32 (TF32
   off) and bf16, its time, the plain version's and cuDNN's dgrad's from
   CUDA events (f32: the FMA template's too), and the numbers of phase 3;
8. train: the workload resident on the card; 68 forward and 67 grad-input
   launches per step, by the routes the plan gives; a finite loss and a
   finite gradient for every parameter (non-zero except the confidence
   head's, which the loss does not read); the f32 step with the kernels
   against the same step with their plain versions; the f32 step on the
   card against the CPU at
   64x96 (loss, BN running stats, and gradients with eval-mode BN); the
   bf16 step's loss against the f32 step's; the NaN-skip; ms per step in
   bf16 and f32 (CUDA events and host clock), the peak memory, and the
   device idle share and kernel split from ``torch.profiler``.

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
from contextlib import contextmanager
from itertools import islice

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
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16 and
# TF32 on the tensor cores, f32 on the FMA pipes, and the HBM rate; each
# kernel's bound is the larger of its operations over the peak and its
# bytes over the rate
PEAK_TFLOPS = {"bf16": 989.0, "tf32": 495.0, "f32": 67.0}
HBM_BYTES_PER_S = 3.35e12
# each conv route's peak and its operations per FLOP of the conv: the
# 3xTF32 kernel does three TF32 products for each product
ROUTE_PEAK = {"tc": ("bf16", 1), "tf32": ("tf32", 3), "fma": ("f32", 1)}
CONV_SOURCES = {r: f"consistent_depth_tpu_torch/csrc/{f}" for r, f in (
    ("tc", "same_conv_tc.cu"), ("tf32", "same_conv_tf32.cu"),
    ("fma", "same_conv.cu"))}
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
# train path: bench.py::make_workload's reference demo workload, the mc
# settings of the reference demo (B0.1_R1.0, Adam, LR 4e-4, BS 4 pairs)
TRAIN_FRAMES = 244
TRAIN_PAIRS = 715           # hierarchical2 over 244 frames
TRAIN_BATCH = 4
TRAIN_LR = 4e-4
WARMUP_STEPS = 3
TIMED_STEPS = 20
PROFILED_STEPS = 5
# a random init emits extreme log-depths and exp() then blows up the 1/z
# gradients; a pretrained net predicts O(1) depths. Scale the prediction
# head as tests/test_bf16.py does.
TAME_HEAD = 0.05
# kernel against plain, f32 step: the loss; the gradients (relative L2
# over all parameters), whose band covers train-mode BN dividing by the
# batch sigma at each of ~70 layers at random init, which amplifies
# summation-order differences (the port's own f32 gradients differ from
# its f64 gradients by 2.4e-3 relative on the CPU at 32x48)
TOL_STEP_LOSS = 1e-5
TOL_STEP_GRADS = 1e-2
# card against CPU, f32, two pairs of the same recipe's data at 64x96: the
# loss and the BN running stats after the step (max |d| / max |ref| per
# tensor), and the gradients with eval-mode BN (relative L2), where no batch
# statistics amplify anything (measured 6.1e-7). A 64x96 crop of the
# 224x384 data would keep intrinsics whose principal point lies outside
# the crop; its f32 gradients differ from f64 by 1.5e-5 on the CPU alone.
TRAIN_SMALL_SIZE = (64, 96)
TOL_CPU_LOSS = 1e-5
TOL_CPU_STATS = 1e-4
TOL_CPU_GRADS = 1e-5
# bf16 step against f32 step: relative loss difference (tests/test_bf16.py)
TOL_TRAIN_BF16 = 0.05
# the parameters the loss does not read: the confidence head
NO_GRAD_PARAMS = ("uncertainty_layer.",)


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


def record_conv_classes(torch, s2d_conv, model, batch=BATCH, size=SIZE):
    """The (x shape, w shape, has bias) of every same_conv call of one
    forward of ``batch`` frames at ``size`` (batch 8 at 224x384 by
    default), with its count."""
    seen = Counter()
    orig = s2d_conv.same_conv

    def recording(x, w, bias=None):
        seen[(tuple(x.shape), tuple(w.shape), bias is not None)] += 1
        return orig(x, w, bias)

    s2d_conv.same_conv = recording
    try:
        with torch.inference_mode():
            model.apply(torch.rand((batch, 1, *size, 3), device="cuda"))
    finally:
        s2d_conv.same_conv = orig
    return seen


def conv_bound(direction, N, H, W, k, Ci, Co, elem_bytes, route):
    """GFLOP of one conv call, 2 N H W k^2 Ci Co, and the least time the
    card could take for it on ``route``: the larger of the operations
    (ROUTE_PEAK) over the route's peak and the bytes (each input read once,
    each output written once) over the memory rate. Returns (gflop,
    bound_ms, bound_by)."""
    flop = 2 * N * H * W * k * k * Ci * Co
    # forward: x, w, bias in, out; grad-input: ct, w in, dx out
    elems = N * H * W * (Ci + Co) + k * k * Ci * Co + (
        Co if direction == "forward" else 0)
    peak, per_flop = ROUTE_PEAK[route]
    t_ops = per_flop * flop / (PEAK_TFLOPS[peak] * 1e12)
    t_bytes = elems * elem_bytes / HBM_BYTES_PER_S
    return (flop / 1e9, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


@contextmanager
def fma_route(s2d_conv):
    """The conv wrappers take the FMA template (csrc/same_conv.cu) for
    every shape inside the block: the design the tensor-core kernels
    replaced, timed beside them on the same inputs."""
    orig = s2d_conv._plan
    s2d_conv._plan = lambda *args, **kwargs: ("fma", 0, 1)
    try:
        yield
    finally:
        s2d_conv._plan = orig


def check_conv(torch, s2d_conv, direction, ashape, wshape, has_bias, seed,
               timed=True):
    """One conv class in both directions' sense: ``direction`` "forward"
    checks same_conv on x = ``ashape`` (N, H, W, Ci), "grad_input" checks
    same_conv_grad_input on the cotangent ``ashape`` (N, H, W, Co); w is
    ``wshape`` (k, k, Ci, Co). In f32 (TF32 off) and bf16: the route the
    plan gives, the error against the plain version on the same rounded
    inputs, the bound of the route (f32: both the 3xTF32 and the FMA
    bound), and when ``timed`` the times of the kernel, the plain version,
    (grad-input) cuDNN's dgrad and (f32) the FMA template from CUDA
    events."""
    N, H, W, C = ashape
    k, _, Ci, Co = wshape
    g = torch.Generator(device="cuda").manual_seed(seed)
    # the strides of the main path: activations and cotangents NHWC views
    # of channels_last tensors, w an HWIO view of an OIHW channels_last
    # weight
    a = torch.randn((N, C, H, W), generator=g, device="cuda").to(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    w = (torch.randn((Co, Ci, k, k), generator=g, device="cuda")
         / math.sqrt(k * k * Ci)).to(
             memory_format=torch.channels_last).permute(2, 3, 1, 0)
    b = (0.1 * torch.randn((Co,), generator=g, device="cuda")
         if has_bias else None)
    grad = direction == "grad_input"
    row = {"direction": direction, "ct" if grad else "x": list(ashape),
           "w": list(wshape)}
    ok = True
    for name, dt, tol in (("f32", torch.float32, TOL_F32),
                          ("bf16", torch.bfloat16, TOL_BF16)):
        ad, wd = a.to(dt), w.to(dt)
        bd = b.to(dt) if b is not None else None
        if grad:
            def kernel():
                return s2d_conv.same_conv_grad_input(ad, wd)

            def plain():
                return s2d_conv.same_conv_grad_input_reference(ad, wd)

            def library():
                return torch.nn.grad.conv2d_input(
                    (N, Ci, H, W), wd.permute(3, 2, 0, 1),
                    ad.permute(0, 3, 1, 2), padding=(k - 1) // 2)

            ref = s2d_conv.same_conv_grad_input_reference(ad.float(),
                                                          wd.float())
        else:
            def kernel():
                return s2d_conv.same_conv(ad, wd, bd)

            def plain():
                return s2d_conv.same_conv_reference(ad, wd, bd)

            library = plain    # the plain version is one cuDNN call
            ref = s2d_conv.same_conv_reference(
                ad.float(), wd.float(), bd.float() if bd is not None else None)
        got = kernel().float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        route, tile_h, split = s2d_conv._plan(dt, N, H, W, Ci, Co, k,
                                              grad_input=grad)
        gflop, bound_ms, bound_by = conv_bound(
            direction, N, H, W, k, Ci, Co, ad.element_size(), route)
        r = {"route": route, "tile_h": tile_h, "split": split,
             "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
             "bound_ms": bound_ms, "bound_by": bound_by}
        if name == "f32":
            for key, rt in (("bound_ms_3xtf32", "tf32"),
                            ("bound_ms_fma", "fma")):
                r[key] = conv_bound(direction, N, H, W, k, Ci, Co, 4, rt)[1]
        if timed:
            t = [cuda_ms(torch, plain), cuda_ms(torch, kernel),
                 cuda_ms(torch, kernel), cuda_ms(torch, plain)]
            r["ms"] = (t[1] + t[2]) / 2
            r["plain_ms"] = (t[0] + t[3]) / 2
            if name == "f32":
                with fma_route(s2d_conv):
                    r["fma_ms"] = (cuda_ms(torch, kernel)
                                   + cuda_ms(torch, kernel)) / 2
            r["library_ms"] = (r["plain_ms"] if library is plain else
                               (cuda_ms(torch, library)
                                + cuda_ms(torch, library)) / 2)
            r["tflops"] = gflop / r["ms"]
            r["bound_share"] = bound_ms / r["ms"]
        row[name] = r
        ok = ok and math.isfinite(rel) and rel <= tol
    row["gflop"] = gflop
    row["pass"] = ok
    return row


# the timed numbers of a class that add up over classes; f32 rows carry
# the FMA template's time and both bounds as well
SUMMED = ("ms", "plain_ms", "library_ms", "bound_ms", "fma_ms",
          "bound_ms_3xtf32", "bound_ms_fma")


def conv_totals(rows, count_key):
    """Per-dtype sums over classes times their counts: ms, plain, library
    and bound ms (f32: the FMA template's ms and both bounds too), GFLOP,
    the achieved TFLOP/s and the share of the bound."""
    totals = {}
    for dt in ("f32", "bf16"):
        t = {key: sum(r[dt][key] * r[count_key] for r in rows)
             for key in SUMMED if key in rows[0][dt]}
        t["gflop"] = sum(r["gflop"] * r[count_key] for r in rows)
        t["tflops"] = t["gflop"] / t["ms"]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        totals[dt] = t
    return totals


def conv_entry(name, replaces, launches, rows, count_key, dt, route):
    """One entry of the ``kernels`` line, or None where the plan gives
    ``route`` no class of ``rows`` in ``dt``: those classes' times and
    bounds summed with their counts (ms, the plain version's, the library
    call's: cuDNN's fprop for the forward, whose plain version it is, and
    its dgrad for the grad-input; f32: the FMA template's ms and both
    bounds), the largest error against plain."""
    mine = [r for r in rows if r[dt]["route"] == route]
    if not mine:
        return None
    by = Counter()
    for r in mine:
        by[r[dt]["bound_by"]] += r[dt]["bound_ms"] * r[count_key]
    entry = {"name": name, "route": "cuda", "source": CONV_SOURCES[route],
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r[dt]["max_abs_err"] for r in mine)}
    for key in SUMMED:
        if key in mine[0][dt]:
            entry[key] = sum(r[dt][key] * r[count_key] for r in mine)
    entry["bound_by"] = by.most_common(1)[0][0]
    return entry


def expected_routes(s2d_conv, classes, dtype, grad_input):
    """{route: launches} that ``classes`` ({(x or ct shape, w shape, ...):
    count}) should make in ``dtype`` by the plan."""
    routes = Counter()
    for key, count in classes.items():
        (N, H, W, _), (k, _, Ci, Co) = key[0], key[1]
        routes[s2d_conv._plan(dtype, N, H, W, Ci, Co, k,
                              grad_input=grad_input)[0]] += count
    return routes


def check_added_cases(torch, s2d_conv, create_depth_model):
    """The ragged cases, the stem's class (whose grad-input, into 3
    channels, takes the FMA template in both dtypes), and every forward and
    grad-input class of the train phase's card-against-CPU check (4 frames
    at 64x96), in f32 and bf16 against plain with the bands of phases 3
    and 7 (untimed)."""
    model = create_depth_model("mc", checkpoint="", device="cuda")
    classes = record_conv_classes(torch, s2d_conv, model, 4,
                                  TRAIN_SMALL_SIZE)
    del model
    cases = [(("ragged_1x7x13", (1, 7, 13, 64), (11, 11, 64, 16), True))]
    cases += [(f"ragged_2x14x24_k{k}", (2, 14, 24, 32), (k, k, 32, 64), True)
              for k in (3, 7)]
    cases += [("stem_2x64x96", (2, 64, 96, 3), (7, 7, 3, 128), True)]
    cases += [(f"train_64x96_{i}", xs, ws, hb)
              for i, (xs, ws, hb) in enumerate(sorted(classes))]
    rows, seed = [], 1000
    for name, xs, ws, hb in cases:
        k, _, Ci, Co = ws
        for direction in ("forward", "grad_input"):
            ashape = xs if direction == "forward" else (*xs[:3], Co)
            row = check_conv(torch, s2d_conv, direction, ashape, ws, hb,
                             seed, timed=False)
            seed += 1
            row["case"] = name
            rows.append(row)
    return rows


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
    # the bound: 2 C FLOPs per output element in f32 on the FMA pipes, and
    # f1, f2 read once and the volume written once
    planes = got.shape[-1]
    flop = 2 * B * H * W * planes * C
    t_ops = flop / (PEAK_TFLOPS["f32"] * 1e12)
    t_bytes = (2 * B * H * W * C + got.numel()) * 4 / HBM_BYTES_PER_S
    ms = (t[1] + t[2]) / 2
    return {"case": name, "shape": list(shape), "max_displacement": max_disp,
            "stride": stride, "out": list(got.shape), "max_abs_err": err,
            "max_rel_err": rel, "tol_rel": TOL_CORR,
            "ms": ms, "plain_ms": (t[0] + t[3]) / 2, "gflop": flop / 1e9,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms,
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


def make_train_workload(training, size, n_frames=TRAIN_FRAMES):
    """bench.py::make_workload's data, from the same seeded recipe: frames
    U[0, 1), the hierarchical2 pair set, flows N(0, 2^2), masks U > 0.2,
    intrinsics (1.2 W, 1.2 W, W / 2, H / 2), identity extrinsics."""
    fr, fs = training.frame_range, training.frame_sampling
    rng_frames = fr.FrameRange(fr.OptionalSet(), num_frames=n_frames)
    opts = [fs.SamplePairsOptions(fs.SamplePairsMode.HIERARCHICAL2)]
    pairs = sorted(fs.SamplePairs.to_one_way(
        fs.SamplePairs.sample(opts, rng_frames, two_way=True)))
    H, W = size
    rng = np.random.default_rng(0)
    P = len(pairs)
    pair_arr = np.array(pairs, np.int32)
    return {
        "frames": rng.random((n_frames, H, W, 3), np.float32),
        "pair_slots": pair_arr,
        "pair_ids": pair_arr,
        "flows": (rng.standard_normal((P, 2, H, W, 2)) * 2).astype(
            np.float32),
        "masks": (rng.random((P, 2, H, W)) > 0.2).astype(np.float32),
        "intrinsics": np.tile(
            np.array([W * 1.2, W * 1.2, W / 2, H / 2], np.float32), (P, 2, 1)),
        "extrinsics": np.tile(
            np.concatenate([np.eye(3, dtype=np.float32),
                            np.zeros((3, 1), np.float32)], 1), (P, 2, 1, 1)),
    }


def rel_l2(a, b) -> float:
    """Relative L2 distance of two {name: tensor} maps over all names."""
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return math.sqrt(num / max(den, 1e-300))


def grads_of(engine):
    return {k: p.grad.detach().double().cpu()
            for k, p in engine.params.items()}


def trace_summary(prof, window: str, ranges):
    """From a ``torch.profiler`` trace: the device idle share over the
    profiled range ``window`` (one minus the union of the kernels'
    intervals inside it over its length; None when the trace holds no
    kernels), the device time by kernel name, and for each named range in
    ``ranges`` the device time of the kernels that ran inside the
    device-side spans the profiler draws for it. Those spans place the
    kernels of a range whatever launched them: the conv kernels go out
    through ctypes, not through a torch op."""
    from bisect import bisect_left

    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events
           if e.name == window and e.device_type == DeviceType.CPU]
    # device activity only: kernels, copies and sets, not the device-side
    # spans the profiler draws for the named ranges
    labels = {e.name for e in events if e.device_type == DeviceType.CPU
              and getattr(e, "is_user_annotation", False)}
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device = [e for e in on_device
              if not getattr(e, "is_user_annotation", False)
              and e.name not in labels and e.name != window
              and not e.name.startswith("Optimizer.")]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in device)
    if not win or not kernels:
        return None, {}, {}
    lo, hi = win[0].time_range.start, win[0].time_range.end
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in kernels:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = Counter()
    for e in device:
        by_name[e.name] += e.time_range.end - e.time_range.start
    starts = [s for s, _ in kernels]
    in_ranges = dict.fromkeys(ranges, 0.0)
    for e in on_device:
        if e.name not in in_ranges:
            continue
        lo_r, hi_r = e.time_range.start, e.time_range.end
        i = max(bisect_left(starts, lo_r) - 1, 0)
        while i < len(kernels) and kernels[i][0] < hi_r:
            in_ranges[e.name] += max(
                0.0, min(kernels[i][1], hi_r) - max(kernels[i][0], lo_r))
            i += 1
    return 1.0 - busy / (hi - lo), by_name, in_ranges


def drive_train(torch, engine, data, batches, s2d_conv):
    """The train path's timed run: warm-up steps, then the timed steps
    with the launch counts zeroed just before and read just after."""
    for idx, valid in batches[:WARMUP_STEPS]:
        engine.train_step(data, idx, valid)
    timed = batches[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    skipped = []
    s2d_conv.reset_counts()
    engine.flag_wait_s = 0.0
    t0 = time.perf_counter()
    start.record()
    for idx, valid in timed:
        skipped.append(engine.train_step(data, idx, valid)["skipped_nan"])
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = (s2d_conv.launches, s2d_conv.grad_input_launches)
    return {
        "steps": len(timed),
        "ms_per_step": start.elapsed_time(end) / len(timed),
        "host_ms_per_step": 1e3 * host_s / len(timed),
        # the host blocked in the NaN-skip flag read, the step's one sync;
        # the rest of the host's time is spent issuing work
        "flag_wait_ms_per_step": 1e3 * engine.flag_wait_s / len(timed),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "skipped": int(sum(bool(s) for s in skipped)),
        "same_conv_launches": launches[0],
        "grad_input_launches": launches[1],
        "route_counts": dict(s2d_conv.route_counts),
    }


def profile_train(torch, engine, data, batches, s2d_conv):
    """``torch.profiler`` over PROFILED_STEPS steps: the device idle share,
    the device time of the forward + loss, the backward, the optimizer,
    the conv kernel's two directions, and the top kernels by name. The
    conv wrappers are wrapped in named ranges for the window only (the
    forward and the grad-input run the same kernel template)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def named(label, fn):
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    orig = (s2d_conv._forward, s2d_conv.same_conv_grad_input, engine._loss)
    s2d_conv._forward = named("same_conv_forward", orig[0])
    s2d_conv.same_conv_grad_input = named("same_conv_grad_input", orig[1])
    engine._loss = named("forward_and_loss", orig[2])
    steps = batches[-PROFILED_STEPS:]
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("train_window"):
                for idx, valid in steps:
                    engine.train_step(data, idx, valid)
                torch.cuda.synchronize()
    finally:
        s2d_conv._forward, s2d_conv.same_conv_grad_input = orig[:2]
        del engine._loss
    opt_label = f"Optimizer.step#{type(engine.optimizer).__name__}.step"
    idle, by_name, in_ranges = trace_summary(
        prof, "train_window", ("forward_and_loss", "same_conv_forward",
                               "same_conv_grad_input", opt_label))
    ranges = {k: v / 1e3 / len(steps) for k, v in in_ranges.items()}
    total = sum(by_name.values()) / 1e3 / len(steps)
    # the backward (and the NaN check after it) is what the forward, the
    # loss and the optimizer leave: autograd runs it in its own thread
    ranges["backward_and_nan_check"] = (
        total - ranges["forward_and_loss"] - ranges[opt_label])
    top = [[name[:120], t / 1e3 / len(steps)]
           for name, t in by_name.most_common(25)]
    return {"steps": len(steps), "device_idle_share": idle,
            "device_ms_per_step": total, "ranges_ms_per_step": ranges,
            "top_kernels_ms_per_step": top}


def train_path(torch, smi, classes, training, s2d_conv,
               create_depth_model, LossWeights):
    """Phases 7 and 8 on the reference demo workload; ``classes`` are the
    forward's conv classes of phase 3. Returns the grad-input rows, their
    per-step sums and the timed runs."""
    per_forward = sum(classes.values())
    # -- 7. grad-input kernel against plain, per backward conv class ------
    t_data = time.perf_counter()
    workload = make_train_workload(training, SIZE)
    n_pairs = len(workload["pair_ids"])
    require(n_pairs == TRAIN_PAIRS,
            f"hierarchical2 over {TRAIN_FRAMES} frames gave {n_pairs} pairs")
    init = create_depth_model("mc", checkpoint="", seed=0, device="cuda")
    with torch.no_grad():
        init.net.pred_layer.weight.mul_(TAME_HEAD)
        init.net.pred_layer.bias.mul_(TAME_HEAD)
    init_sd = {k: v.clone() for k, v in init.net.state_dict().items()}
    del init

    def make_engine(precision, device="cuda"):
        model = create_depth_model("mc", checkpoint="", device=device)
        model.net.load_state_dict(init_sd)
        return training.TrainingEngine(
            model, training.create_optimizer("Adam", TRAIN_LR),
            LossWeights(lambda_view_baseline=0.1, lambda_reprojection=1.0),
            precision=precision)

    eng16 = make_engine("bf16")
    data = eng16.put_data(workload)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t_data
    batches = list(islice(training.PairBatchIterator(
        n_pairs, TRAIN_BATCH, seed=0).epoch(0),
        1 + WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS))
    idx0, valid0 = batches[0]

    # one bf16 step: the grad-input classes, the launches, the health
    gx_classes = Counter()
    orig_gx = s2d_conv.same_conv_grad_input

    def recording_gx(ct, w):
        gx_classes[(tuple(ct.shape), tuple(w.shape))] += 1
        return orig_gx(ct, w)

    s2d_conv.same_conv_grad_input = recording_gx
    s2d_conv.reset_counts()
    try:
        first16 = eng16.train_step(data, idx0, valid0)
        torch.cuda.synchronize()
    finally:
        s2d_conv.same_conv_grad_input = orig_gx
    first_launches = (s2d_conv.launches, s2d_conv.grad_input_launches)
    first_routes = dict(s2d_conv.route_counts)
    first_grads = grads_of(eng16)
    loss16 = float(first16["loss"])

    gx_rows = []
    for i, ((cts, ws), count) in enumerate(sorted(gx_classes.items())):
        row = check_conv(torch, s2d_conv, "grad_input", cts, ws, False,
                         seed=100 + i)
        row["per_step"] = count
        gx_rows.append(row)
        emit({"phase": "grad_input", **row, "nvidia_smi": smi})
    gx_totals = conv_totals(gx_rows, "per_step")
    emit({"phase": "grad_inputs", "classes": len(gx_rows),
          "launches_per_step": sum(gx_classes.values()),
          "expected_per_step": per_forward - 1,
          "per_step_ms": gx_totals, "nvidia_smi": smi,
          "pass": all(r["pass"] for r in gx_rows)})
    require(all(r["pass"] for r in gx_rows),
            "grad-input kernel disagrees with plain")
    # the routes each precision's step must take, by the plan
    routes = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fwd = expected_routes(s2d_conv, classes, dt, False)
        bwd = expected_routes(s2d_conv, gx_classes, dt, True)
        routes[name] = {f"forward_{r}": fwd[r] for r in s2d_conv.ROUTES}
        routes[name].update(
            {f"grad_input_{r}": bwd[r] for r in s2d_conv.ROUTES})

    # -- 8. the train path ------------------------------------------------
    nonzero_ok = all(bool(g.abs().max() > 0) for k, g in first_grads.items()
                     if not k.startswith(NO_GRAD_PARAMS))
    finite_ok = all(bool(torch.isfinite(g).all())
                    for g in first_grads.values())
    no_grad_zero = all(bool(g.abs().max() == 0)
                       for k, g in first_grads.items()
                       if k.startswith(NO_GRAD_PARAMS))

    # the f32 step with the kernels against the same step with their plain
    # versions: same weights, same batch
    eng32 = make_engine("f32")
    first32 = eng32.train_step(data, idx0, valid0)
    grads32 = grads_of(eng32)
    loss32 = float(first32["loss"])
    plain = make_engine("f32")
    orig_conv = (s2d_conv.same_conv, s2d_conv.same_conv_grad_input)
    s2d_conv.same_conv = s2d_conv.same_conv_reference
    s2d_conv.same_conv_grad_input = s2d_conv.same_conv_grad_input_reference
    try:
        plain_out = plain.train_step(data, idx0, valid0)
        plain_loss = float(plain_out["loss"])
    finally:
        s2d_conv.same_conv, s2d_conv.same_conv_grad_input = orig_conv
    plain_loss_err = abs(loss32 - plain_loss) / abs(plain_loss)
    plain_grad_err = rel_l2(grads32, grads_of(plain))
    del plain

    # the card against the CPU, f32, two pairs at 64x96
    small = {k: v[:2] if k != "frames" else v for k, v in
             make_train_workload(training, TRAIN_SMALL_SIZE).items()}
    sides = {}
    for device in ("cuda", "cpu"):
        eng = make_engine("f32", device)
        d = eng.put_data(small)
        idx, valid = eng._indices([0, 1], [1.0, 1.0])
        loss, _, _ = eng._loss(training.gather_batch(d, idx), valid,
                               train=False)
        loss.backward()
        eval_grads, eval_loss = grads_of(eng), loss.item()
        out = eng.train_step(d, [0, 1], [1.0, 1.0])
        stats = {k: v.double().cpu()
                 for k, v in eng.model.net.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        sides[device] = (float(out["loss"]), stats, eval_grads, eval_loss)
    cpu_loss_err = abs(sides["cuda"][0] - sides["cpu"][0]) / abs(
        sides["cpu"][0])
    cpu_stats_err = max(
        float((sides["cuda"][1][k] - v).abs().max() / v.abs().max())
        for k, v in sides["cpu"][1].items())
    cpu_eval_loss_err = abs(sides["cuda"][3] - sides["cpu"][3]) / abs(
        sides["cpu"][3])
    cpu_grad_err = rel_l2(sides["cuda"][2], sides["cpu"][2])
    bf16_loss_err = abs(loss16 - loss32) / abs(loss32)

    # NaN-skip on the card: params and Adam's state stay bitwise
    bad = {k: data[k][:TRAIN_BATCH] for k in data if k != "frames"}
    bad["frames"] = data["frames"]
    bad["flows"] = bad["flows"].clone()
    bad["flows"][0] = float("nan")
    params_before = {k: p.detach().clone() for k, p in eng16.params.items()}
    opt_before = {k: {n: v.clone() if torch.is_tensor(v) else v
                      for n, v in st.items()}
                  for k, st in eng16.optimizer.state_dict()["state"].items()}
    bn_before = eng16.model.net.seq[1].running_mean.clone()
    step_before = eng16.step
    nan_out = eng16.train_step(bad, np.arange(TRAIN_BATCH), np.ones(
        TRAIN_BATCH, np.float32))
    opt_after = eng16.optimizer.state_dict()["state"]
    nan_skip = {
        "skipped": bool(nan_out["skipped_nan"]),
        "params_unchanged": all(torch.equal(p.detach(), params_before[k])
                                for k, p in eng16.params.items()),
        "optimizer_unchanged": opt_after.keys() == opt_before.keys() and all(
            all(torch.equal(v, opt_before[k][n]) if torch.is_tensor(v)
                else v == opt_before[k][n] for n, v in st.items())
            for k, st in opt_after.items()),
        "bn_stats_moved": not torch.equal(
            eng16.model.net.seq[1].running_mean, bn_before),
        "step_advanced": eng16.step == step_before + 1,
    }
    emit({
        "phase": "train_checks", "frames": TRAIN_FRAMES, "pairs": n_pairs,
        "size": list(SIZE), "batch_pairs": TRAIN_BATCH,
        "resident_gib": sum(v.numel() * v.element_size()
                            for v in data.values()) / 2 ** 30,
        "workload_seconds": data_s,
        "first_step_launches": list(first_launches),
        "expected_launches": [per_forward, per_forward - 1],
        "first_step_routes": first_routes,
        "expected_routes": routes["bf16"],
        "loss_bf16": loss16, "loss_f32": loss32,
        "skipped_first": [bool(first16["skipped_nan"]),
                          bool(first32["skipped_nan"])],
        "grads_finite": finite_ok, "grads_nonzero": nonzero_ok,
        "confidence_head_grad_zero": no_grad_zero,
        "kernel_vs_plain_loss_rel": plain_loss_err,
        "tol_loss": TOL_STEP_LOSS,
        "kernel_vs_plain_grads_rel_l2": plain_grad_err,
        "tol_grads": TOL_STEP_GRADS,
        "card_vs_cpu_loss_rel": cpu_loss_err, "tol_cpu_loss": TOL_CPU_LOSS,
        "card_vs_cpu_bn_stats_rel": cpu_stats_err,
        "tol_cpu_stats": TOL_CPU_STATS,
        "card_vs_cpu_eval_loss_rel": cpu_eval_loss_err,
        "card_vs_cpu_eval_grads_rel_l2": cpu_grad_err,
        "tol_cpu_grads": TOL_CPU_GRADS,
        "bf16_vs_f32_loss_rel": bf16_loss_err, "tol_bf16": TOL_TRAIN_BF16,
        "nan_skip": nan_skip, "nvidia_smi": smi,
    })
    require(first_launches == (per_forward, per_forward - 1),
            f"one train step made {first_launches} same_conv / grad-input "
            f"launches, expected {(per_forward, per_forward - 1)}")
    require(all(first_routes[k] == v for k, v in routes["bf16"].items()),
            f"one bf16 train step took routes {first_routes}, expected "
            f"{routes['bf16']}")
    require(math.isfinite(loss16) and math.isfinite(loss32),
            "non-finite train loss")
    require(not bool(first16["skipped_nan"])
            and not bool(first32["skipped_nan"]), "first train step skipped")
    require(finite_ok and nonzero_ok, "a parameter got a non-finite or zero "
            "gradient")
    require(plain_loss_err <= TOL_STEP_LOSS,
            f"f32 step loss, kernels vs plain {plain_loss_err}")
    require(plain_grad_err <= TOL_STEP_GRADS,
            f"f32 step gradients, kernels vs plain {plain_grad_err}")
    require(cpu_loss_err <= TOL_CPU_LOSS, f"train loss card vs CPU "
            f"{cpu_loss_err}")
    require(cpu_stats_err <= TOL_CPU_STATS, f"BN stats card vs CPU "
            f"{cpu_stats_err}")
    require(cpu_eval_loss_err <= TOL_CPU_LOSS and cpu_grad_err
            <= TOL_CPU_GRADS, f"eval-mode loss/gradients card vs CPU "
            f"{cpu_eval_loss_err} / {cpu_grad_err}")
    require(bf16_loss_err <= TOL_TRAIN_BF16,
            f"bf16 step loss vs f32 {bf16_loss_err}")
    require(all(nan_skip.values()), f"NaN-skip on the card {nan_skip}")

    # the main path: timed train steps in bf16 and in f32, the fine-tune's
    # default precision
    timing = {}
    for name, eng in (("bf16", eng16), ("f32", eng32)):
        run = drive_train(torch, eng, data, batches[1:], s2d_conv)
        run["profile"] = profile_train(torch, eng, data, batches[1:],
                                       s2d_conv)
        # the profiler slows the host, so its idle share is an upper bound;
        # the profiled device time over the unprofiled step is the estimate
        run["device_idle_share_unprofiled"] = (
            1.0 - run["profile"]["device_ms_per_step"] / run["ms_per_step"])
        timing[name] = run
        emit({"phase": "train", "precision": name, **run,
              "workload": f"{TRAIN_FRAMES} frames {SIZE[0]}x{SIZE[1]}, "
                          f"{n_pairs} pairs, batch {TRAIN_BATCH}",
              "nvidia_smi": smi})
        require(run["skipped"] == 0, f"{name}: {run['skipped']} timed steps "
                "skipped")
        require(run["same_conv_launches"] == per_forward * run["steps"]
                and run["grad_input_launches"]
                == (per_forward - 1) * run["steps"],
                f"{name}: {run['same_conv_launches']} / "
                f"{run['grad_input_launches']} launches in "
                f"{run['steps']} steps")
        require(all(run["route_counts"][k] == v * run["steps"]
                    for k, v in routes[name].items()),
                f"{name}: routes {run['route_counts']} in {run['steps']} "
                f"steps, expected {routes[name]} per step")
    return gx_rows, gx_totals, timing


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
        from consistent_depth_tpu_torch import training
        from consistent_depth_tpu_torch.flow import correlation as corr
        from consistent_depth_tpu_torch.flow.runner import TorchFlowBackend
        from consistent_depth_tpu_torch.io import image_io
        from consistent_depth_tpu_torch.models import hourglass
        from consistent_depth_tpu_torch.models.registry import (
            create_depth_model)
        from consistent_depth_tpu_torch.ops import _cuda, s2d_conv
        from consistent_depth_tpu_torch.ops.consistency import (
            consistent_flow_masks)
        from consistent_depth_tpu_torch.ops.flow_viz import (
            flow_to_image_torch)
        from consistent_depth_tpu_torch.ops.losses import LossWeights
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
        row = check_conv(torch, s2d_conv, "forward", xs, ws, has_bias, seed=i)
        row["per_forward"] = count
        rows.append(row)
        emit({"phase": "kernel", **row})
    totals = conv_totals(rows, "per_forward")
    emit({"phase": "kernels", "classes": len(rows),
          "launches_per_forward": sum(classes.values()),
          "expected_per_forward": per_forward,
          "per_forward_ms": totals, "nvidia_smi": smi,
          "pass": all(r["pass"] for r in rows)})
    require(all(r["pass"] for r in rows), "kernel disagrees with plain")
    require(sum(classes.values()) == per_forward,
            f"{sum(classes.values())} same_conv calls per forward, "
            f"expected {per_forward}")

    # the ragged cases and the train phase's 64x96 classes, both directions
    added = check_added_cases(torch, s2d_conv, create_depth_model)
    emit({"phase": "conv_cases", "cases": len(added),
          "routes": Counter(f"{r['direction']}_{r[dt]['route']}"
                            for r in added for dt in ("f32", "bf16")),
          "max_rel_err": {dt: max(r[dt]["max_rel_err"] for r in added)
                          for dt in ("f32", "bf16")},
          "tol_rel": {"f32": TOL_F32, "bf16": TOL_BF16},
          "failed": [r for r in added if not r["pass"]],
          "pass": all(r["pass"] for r in added)})
    require(all(r["pass"] for r in added),
            "kernel disagrees with plain on an added case")
    require(all(any(r[dt]["route"] == "fma" for r in added)
                for dt in ("f32", "bf16")),
            "no added case took the FMA template in both dtypes")

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
    s2d_conv.reset_counts()
    corr.launches = 0
    t0 = time.perf_counter()
    out = server.infer_videos(videos)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = s2d_conv.launches
    serve_routes = dict(s2d_conv.route_counts)
    serve_corr_launches = corr.launches
    want_routes = {f"forward_{r}": n * n_batches for r, n in expected_routes(
        s2d_conv, classes, torch.bfloat16, False).items()}

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
        "route_counts": serve_routes, "expected_routes": want_routes,
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
    require(all(serve_routes[k] == v for k, v in want_routes.items()),
            f"serving took routes {serve_routes}, expected {want_routes}")
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

    # -- 7-8. the train path ---------------------------------------------
    del backend
    torch.cuda.empty_cache()
    gx_rows, gx_totals, timing = train_path(
        torch, smi, classes, training, s2d_conv, create_depth_model,
        LossWeights)

    # the launches by route from the timed train runs, by precision; each
    # conv entry sums its classes per batch-8 forward (phase 3) or per
    # train step (phase 7), for each route the plan gives a class of the
    # main path (the FMA template, for the shapes the tensor-core kernels
    # do not take, has none at present)
    conv_tpu = "consistent_depth_tpu/ops/s2d_conv.py:168"
    vjp_tpu = "consistent_depth_tpu/models/layers.py:321"
    entries = []
    for dt in ("bf16", "f32"):
        counts = timing[dt]["route_counts"]
        for route in s2d_conv.ROUTES:
            suffix = ("" if dt == "bf16" else "_f32") + (
                "_fma" if route == "fma" else "")
            entries += [
                conv_entry("same_conv" + suffix, conv_tpu,
                           counts["forward_" + route], rows, "per_forward",
                           dt, route),
                conv_entry("same_conv_grad_input" + suffix, vjp_tpu,
                           counts["grad_input_" + route], gx_rows,
                           "per_step", dt, route)]
    entries.append(
        {"name": "correlation", "route": "cuda",
         "source": "consistent_depth_tpu_torch/csrc/correlation.cu",
         "replaces": "consistent_depth_tpu/flow/correlation.py:116",
         "launches": flow_launches,
         "max_abs_err": max(r["max_abs_err"] for r in corr_rows),
         "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
         "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
         "library_ms": None})
    print(smi, flush=True)
    emit({"kernels": [e for e in entries if e is not None]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
