#!/usr/bin/env python3
"""The k x k conv's wgmma kernels alone on one H100: bf16's ``"wgmma"``
(``consistent_depth_tpu_torch/csrc/same_conv_wgmma.cu``) or, with ``--dtype
f32``, f32's ``"wgmma_tf32"`` (``csrc/same_conv_wgmma_tf32.cu``, 3xTF32);
build, check and time it before the whole ``chip_smoke.py``.

1. build: the port's library (every source, as ``ops/_cuda.py`` builds it),
   then the wgmma source once more with ``-Xptxas -v``: registers, spills
   and shared memory per instantiation;
2. smoke: small cases that reach every instantiation (bf16: output-channel
   block 16/32/64/128 x direction x one or two m64 tiles per warpgroup x 16,
   32 or 64 reduction channels per chunk; f32: block 16/32/64 x direction
   x one or two m64 tiles x one or two chunks), k = 3 and 11, ragged rows,
   columns and channels, a split reduction and a forward into 2 channels,
   each launched alone and synchronised, against ``same_conv_reference``
   (or its grad-input) within TOL[dtype] of max |ref| (2^-7 in bf16; 2e-5
   in f32, against the plain version in f32 with TF32 off); in f32 also
   the weight split against ``split_tf32_reference``, bit for bit. A wait
   on an mbarrier that never completes traps in the kernel (about 10 s),
   so a fault of the ring ends the run with a CUDA error rather than a
   hang;
3. classes (unless ``--smoke``): every conv class of one batch-8 forward
   at 224x384 of ``mc``, ``midas2`` and ``monodepth2`` (traced on the meta
   device) in the dtype, forward and grad-input: the plan's route, and for
   each tensor-core route of the dtype that takes the class (bf16:
   ``"wgmma"`` and ``"tc"``; f32: ``"wgmma_tf32"`` and ``"tf32"``) its
   error against plain, its CUDA-event time and its device time alone
   (``chip_smoke.queued_ms``: calls queued behind a sleep kernel) with its
   share of the class's bound (the operations over 989 TFLOP/s in bf16,
   three times them over 495 TFLOP/s in f32, or the bytes over 3.35 TB/s,
   the larger); the plain version's and cuDNN's times (fprop; dgrad for
   the grad-input; TF32 off); then totals per model and direction, on the
   plan's mix and on each route alone.

With ``--variants``, instead of 3: text-edited copies of the wgmma
source and of ``same_conv_wgmma.cuh`` (each edit must match exactly once in
the two), each built with a one-function stub of the library's error
strings into its own library under
``build/conv_wgmma_variants/``, all builds at once, and timed (device time
alone) in turns on the dtype's variant classes through the same wrapper.
bf16: ``committed``; ``no_mma`` (the consumers skip the wgmmas: the
copies, the barriers and the A loads alone); ``no_ldmatrix`` (zero A
fragments: the copies, the barriers and the wgmmas); ``neither``; on
``neither``, the consumers polling with ``test_wait``
(``neither_test_wait``), the producer prefetching both tensor maps
(``neither_prefetch``) and the weight stages completed by an arrival with
no copy (``neither_no_weight_tma``); their outputs are wrong by design and
only timed. f32: ``committed`` (a partial per tap row), ``flush_tap`` (a
partial per tap), ``chained`` (every product onto one partial, added to the
accumulator at the end), ``chunk16`` (16 channels a chunk everywhere),
``chunk32_k5`` (32 at k = 5 too), ``no_smem_split`` (every A fragment split
in registers), ``smem_split_th16`` (each chunk's halo split once in shared
memory at every 16-row tile) and ``cvt_round`` (the TF32 rounding by
``cvt.rna``), each also held against plain (the error of each way of
summing); a variant that does not fit a class reports its CUDA error.
Both: the tile heights the plan did not pick (one m64 tile per warpgroup
against two), on the committed source.

One JSON line per result; exits non-zero if a case disagrees. Usage, from
the root of a checkout on the card: ``python3 tools/torch_conv_wgmma.py
[--dtype bf16|f32] [--smoke | --variants]``.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from consistent_depth_tpu_torch.models.registry import (  # noqa: E402
    get_depth_model)
from consistent_depth_tpu_torch.ops import _cuda, s2d_conv  # noqa: E402

HEADER = _cuda.CSRC_DIR / "same_conv_wgmma.cuh"
SOURCES = {"bf16": _cuda.CSRC_DIR / "same_conv_wgmma.cu",
           "f32": _cuda.CSRC_DIR / "same_conv_wgmma_tf32.cu"}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# each dtype's wgmma route and the tensor-core route timed beside it
ROUTES = {"bf16": ("wgmma", "tc"), "f32": ("wgmma_tf32", "tf32")}
# the band of each dtype's wgmma route against plain, in max |d| / max
# |ref|: bf16's of the card's checks; f32's the 3xTF32 kernel's own
TOL = {"bf16": cs.TOL_BF16, "f32": 2e-5}
# the peak (chip_smoke.ROUTE_PEAK) each dtype's bound is taken against
BOUND_ROUTE = {"bf16": "tc", "f32": "tf32"}
MODELS = ("mc", "midas2", "monodepth2")
# (name, direction, (N, H, W, C of x or ct), (k, k, Ci, Co), bias)
SMOKE = [
    ("fwd_k3_16to16", "forward", (1, 9, 20, 16), (3, 3, 16, 16), True),
    ("fwd_k11_32to32", "forward", (1, 13, 21, 32), (11, 11, 32, 32), True),
    ("fwd_k3_64to64", "forward", (2, 8, 16, 64), (3, 3, 64, 64), True),
    ("fwd_k5_72to130", "forward", (1, 7, 19, 72), (5, 5, 72, 130), True),
    ("fwd_k3_64to2", "forward", (1, 8, 17, 64), (3, 3, 64, 2), True),
    ("fwd_k7_48to24", "forward", (1, 12, 30, 48), (7, 7, 48, 24), False),
    ("gx_k3_16to64", "grad_input", (1, 9, 20, 16), (3, 3, 64, 16), False),
    ("gx_k3_32to16", "grad_input", (1, 9, 20, 32), (3, 3, 16, 32), False),
    ("gx_k11_32to32", "grad_input", (1, 13, 21, 32), (11, 11, 32, 32),
     False),
    ("gx_k3_64to128", "grad_input", (1, 8, 18, 64), (3, 3, 128, 64), False),
    ("gx_k5_256to256", "grad_input", (1, 6, 11, 256), (5, 5, 256, 256),
     False),
]
# f32 only: a reduction of 4 and 12 channels (one ragged chunk), a
# grad-input into 4 channels, three chunks (the last ragged) into 16
SMOKE_F32 = [
    ("fwd_k3_4to16", "forward", (1, 9, 20, 4), (3, 3, 4, 16), True),
    ("fwd_k5_12to40", "forward", (1, 10, 18, 12), (5, 5, 12, 40), True),
    ("gx_k3_16to4", "grad_input", (1, 9, 20, 16), (3, 3, 4, 16), False),
    ("fwd_k7_40to16", "forward", (1, 19, 23, 40), (7, 7, 40, 16), True),
]
# tiles the plan would not pick at these sizes, and splits: (case name,
# tile_h, split); in f32 the 16-row k >= 7 tiles split the halo in shared
# memory
FORCED = [("fwd_k11_32to32", 16, 1), ("fwd_k11_32to32", 8, 3),
          ("gx_k11_32to32", 16, 2), ("gx_k5_256to256", 8, 1)]
FORCED_F32 = [("fwd_k7_40to16", 16, 1), ("fwd_k7_40to16", 16, 4)]


def instantiation_cases(dt):
    """One k=3 case per instantiation of the dtype's kernel, forced to its
    tile: output-channel block x direction x one or two m64 tiles a
    warpgroup (16-row tiles) x, in bf16, 16/32/64 reduction channels a
    chunk (f32's chunk is 16: reductions of 16 and 32 channels, one chunk
    and two). (name, direction, shape of x or ct, w shape, bias, tile_h,
    split)"""
    dtype = DTYPES[dt]
    if dt == "bf16":
        blocks, reds = s2d_conv.WGMMA_CO_BLOCKS, s2d_conv.WGMMA_CHUNKS
    else:
        blocks, reds = s2d_conv.WGMMA_TF32_CO_BLOCKS, (16, 32)
    cases = []
    for direction in ("forward", "grad_input"):
        for cob in blocks:
            for red in reds:
                for th in (8, 16):
                    if th == 16 and cob > s2d_conv._wgmma_tall_max(dtype):
                        continue
                    out = cob - 8 if cob > 16 else cob
                    ci, co = (out, red) if direction == "grad_input" else (
                        red, out)
                    cases.append((f"{direction}_n{cob}_k{red}_th{th}",
                                  direction, (1, 9, 20, red), (3, 3, ci, co),
                                  direction == "forward", th, 1))
    return cases


# (name, direction, (N, H, W, C of x or ct), (k, k, Ci, Co), bias): mc's
# heaviest classes in each direction and midas2's widest
VARIANT_CLASSES = [
    ("mc_fwd_224x384_k11", "forward", (8, 224, 384, 64), (11, 11, 64, 16),
     True),
    ("mc_fwd_224x384_k3", "forward", (8, 224, 384, 64), (3, 3, 64, 16), True),
    ("mc_fwd_112x192_k11", "forward", (8, 112, 192, 64), (11, 11, 64, 32),
     True),
    ("mc_gx_224x384_k11", "grad_input", (8, 224, 384, 16), (11, 11, 64, 16),
     False),
    ("mc_gx_112x192_k11", "grad_input", (8, 112, 192, 16), (11, 11, 32, 16),
     False),
    ("midas2_fwd_56x96", "forward", (8, 56, 96, 256), (3, 3, 256, 256),
     False),
]
# f32: mc's k=11 classes of 64 channels into 64 and into 16 (the classes
# where the way of summing shows most), its heaviest grad-input, midas2's
# widest, mc's thin classes at k=3 and of 32 channels, a monodepth2 class
VARIANT_CLASSES_F32 = [
    ("mc_fwd_56x96_k11_64to64", "forward", (8, 56, 96, 64),
     (11, 11, 64, 64), True),
    ("mc_fwd_224x384_k11_64to16", "forward", (8, 224, 384, 64),
     (11, 11, 64, 16), True),
    ("mc_fwd_112x192_k11_64to32", "forward", (8, 112, 192, 64),
     (11, 11, 64, 32), True),
    ("mc_gx_224x384_k11_16to64", "grad_input", (8, 224, 384, 16),
     (11, 11, 64, 16), False),
    ("midas2_fwd_56x96", "forward", (8, 56, 96, 256), (3, 3, 256, 256),
     False),
    ("mc_fwd_224x384_k3_64to16", "forward", (8, 224, 384, 64),
     (3, 3, 64, 16), True),
    ("mc_fwd_112x192_k11_32to16", "forward", (8, 112, 192, 32),
     (11, 11, 32, 16), True),
    ("monodepth2_gx_80x256", "grad_input", (8, 80, 256, 64), (3, 3, 64, 64),
     False),
]
ZERO_A = ("          ldsm4(a[B][j][t][kk], hbase + (off ^ ((off >> 3) & "
          "p.a_swz)));\n",
          "          a[B][j][t][kk][0] = a[B][j][t][kk][1] = "
          "a[B][j][t][kk][2] = a[B][j][t][kk][3] = off & 0u;\n")
NO_MMA = ("          Wgmma<COB>::template mma<GRAD ? 1 : 0>(\n"
          "              acc[t], a[B][j][t][kk], desc + ((kk * p.b_kk_bytes) "
          ">> 4));\n",
          "          acc[t][0] += __uint_as_float(a[B][j][t][kk][0] & 1u) + "
          "(desc & 1u);\n")
TEST_WAIT = ("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;",
             "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;")
PREFETCH = ("    if (tid >= 32) return;\n    // the weight stage of tap",
            "    if (tid >= 32) return;\n"
            "    asm volatile(\"prefetch.tensormap [%0];\" :: "
            "\"l\"(reinterpret_cast<uint64_t>(&xmap)) : \"memory\");\n"
            "    asm volatile(\"prefetch.tensormap [%0];\" :: "
            "\"l\"(reinterpret_cast<uint64_t>(&wmap)) : \"memory\");\n"
            "    // the weight stage of tap")
# the producer completes each weight stage by an arrival alone, with no
# copy: the barriers' handshake without the weights' TMA
NO_WEIGHT_TMA = [("      mbar_expect_tx(full, stage_tx);\n",
                  "      mbar_arrive(full);\n"),
                 ("      load_stage(sm.w + sl * p.stage_bytes, full, chunk, "
                  "r, lane);\n", "")]
NEITHER = [ZERO_A, NO_MMA]
# f32: the TF32 rounding by cvt.rna.tf32.f32 (the conversion pipe) in place
# of the two integer instructions
CVT_ROUND = ("  return (v + 0x1000u) & 0xFFFFE000u;\n",
             "  uint32_t r;\n"
             "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : "
             "\"f\"(__uint_as_float(v)));\n"
             "  return r;\n")
# f32: the source's rules for the partial sums' flush, the chunk and the
# split of the halo in shared memory
FLUSH = "constexpr int FLUSH = FLUSH_ROW;"
WIDE_CHUNK = ("  return K == 3 && Cr > 16 && tile_h < 16 && (Cr + 31) / 32 * "
              "K >= split\n")
SMEM_SPLIT = ("bool smem_split_of(int K, int tile_h) { return tile_h == 16 && "
              "K >= 7; }\n")
VARIANTS = {
    "bf16": {"committed": [], "no_mma": [NO_MMA], "no_ldmatrix": [ZERO_A],
             "neither": NEITHER,
             "neither_test_wait": NEITHER + [TEST_WAIT],
             "neither_prefetch": NEITHER + [PREFETCH],
             "neither_no_weight_tma": NEITHER + NO_WEIGHT_TMA},
    "f32": {"committed": [],
            "flush_tap": [(FLUSH, FLUSH.replace("FLUSH_ROW", "FLUSH_TAP"))],
            "chained": [(FLUSH, FLUSH.replace("FLUSH_ROW", "FLUSH_NEVER"))],
            "chunk16": [(WIDE_CHUNK, "  return false\n")],
            "chunk32_k5": [(WIDE_CHUNK, WIDE_CHUNK.replace("K == 3",
                                                           "K <= 5"))],
            "no_smem_split": [(SMEM_SPLIT, "bool smem_split_of(int K, int "
                               "tile_h) { return false; }\n")],
            "smem_split_th16": [(SMEM_SPLIT, SMEM_SPLIT.replace(
                " && K >= 7", ""))],
            "cvt_round": [CVT_ROUND]},
}
VARIANT_DIR = REPO / "build" / "conv_wgmma_variants"


def emit(obj):
    print(json.dumps(obj), flush=True)


def ptxas_report(source):
    """nvcc -Xptxas -v on a wgmma source: one line per kernel."""
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
           "/dev/null", str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lines = [ln.strip() for ln in proc.stderr.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln
             or "warning" in ln.lower() or "Performance Loss" in ln]
    return proc.returncode, lines


def model_classes(name, batch=8, size=(224, 384)):
    """{(x shape, w shape, has bias): count} of the routed convs of one
    forward of ``name``, traced on the meta device."""
    cls = get_depth_model(name)
    model = object.__new__(cls)
    with torch.device("meta"):
        model.net = model._make_module()
    model.net.to(memory_format=torch.channels_last)
    model.to("meta", torch.bfloat16)
    seen = Counter()

    def record(x, w, bias=None):
        seen[(tuple(x.shape), tuple(w.shape), bias is not None)] += 1
        return x.new_empty((*x.shape[:3], w.shape[3]))

    orig = s2d_conv.same_conv
    s2d_conv.same_conv = record
    try:
        with torch.no_grad():
            model.apply(torch.empty((batch, 1, *size, 3), device="meta"))
    finally:
        s2d_conv.same_conv = orig
    return seen


@contextmanager
def forced_plan(route, tile_h=None, split=None):
    """The conv wrappers take ``route`` (with the given tile and split, else
    the plan's for that route) inside the block."""
    orig = s2d_conv._plan

    def plan(*args, **kwargs):
        got = orig(*args, route=route, **kwargs)
        return (route, tile_h or got[1], split or got[2])

    s2d_conv._plan = plan
    try:
        yield
    finally:
        s2d_conv._plan = orig


def inputs(direction, ashape, wshape, has_bias, seed, dtype):
    """Operands of ``dtype`` with the main path's strides: channels_last
    NHWC views and an HWIO view of an OIHW channels_last weight."""
    N, H, W, C = ashape
    k, _, Ci, Co = wshape
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((N, C, H, W), generator=g, device="cuda").to(
        dtype, memory_format=torch.channels_last).permute(0, 2, 3, 1)
    w = (torch.randn((Co, Ci, k, k), generator=g, device="cuda")
         / math.sqrt(k * k * Ci)).to(
             dtype, memory_format=torch.channels_last).permute(2, 3, 1, 0)
    b = (0.1 * torch.randn((Co,), generator=g, device="cuda")).to(
        dtype) if has_bias and direction == "forward" else None
    return a, w, b


def calls(direction, a, w, b):
    """(kernel, plain, cuDNN, f32 reference) of one class."""
    k = w.shape[0]
    if direction == "forward":
        ref = s2d_conv.same_conv_reference(
            a.float(), w.float(), b.float() if b is not None else None)
        return (lambda: s2d_conv.same_conv(a, w, b),
                lambda: s2d_conv.same_conv_reference(a, w, b),
                lambda: s2d_conv.same_conv_reference(a, w, b), ref)
    N, H, W, _ = a.shape
    ref = s2d_conv.same_conv_grad_input_reference(a.float(), w.float())
    return (lambda: s2d_conv.same_conv_grad_input(a, w),
            lambda: s2d_conv.same_conv_grad_input_reference(a, w),
            lambda: torch.nn.grad.conv2d_input(
                (N, w.shape[2], H, W), w.permute(3, 2, 0, 1),
                a.permute(0, 3, 1, 2), padding=(k - 1) // 2), ref)


def rel_err(got, ref):
    return ((got.float() - ref).abs().max().item()
            / max(ref.abs().max().item(), 1e-30))


def check_split(dt):
    """f32: the weight-split kernel against split_tf32_reference, bit for
    bit, in both layouts, on a weight with the main path's strides."""
    if dt != "f32":
        return True
    _, w, _ = inputs("forward", (1, 4, 4, 64), (11, 11, 64, 16), False, 7,
                     torch.float32)
    ok = True
    for grad in (False, True):
        got = s2d_conv.split_tf32(w, grad)
        want = s2d_conv.split_tf32_reference(w, grad)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        ok = ok and same
        emit({"phase": "split_weight", "grad_input": grad,
              "shape": list(got.shape), "bitwise_equal": same})
    return ok


def smoke(dt):
    dtype, (route, _) = DTYPES[dt], ROUTES[dt]
    rows, ok = [], check_split(dt)
    base = SMOKE + (SMOKE_F32 if dt == "f32" else [])
    cases = [(name, d, a, w, b, None, None) for name, d, a, w, b in base]
    by_name = {c[0]: c for c in base}
    cases += [(f"{name}_th{th}_split{sp}", *by_name[name][1:], th, sp)
              for name, th, sp in FORCED + (FORCED_F32 if dt == "f32"
                                            else [])]
    cases += instantiation_cases(dt)
    for i, (name, direction, ashape, wshape, has_bias, th, sp) in enumerate(
            cases):
        a, w, b = inputs(direction, ashape, wshape, has_bias, i, dtype)
        kernel, _, _, ref = calls(direction, a, w, b)
        emit({"phase": "smoke_start", "case": name})
        with forced_plan(route, th, sp):
            s2d_conv.reset_counts()
            got = kernel()
            torch.cuda.synchronize()
            counts = dict(s2d_conv.route_counts)
        err = rel_err(got, ref)
        good = (math.isfinite(err) and err <= TOL[dt]
                and counts[f"{direction}_{route}"] == 1)
        ok = ok and good
        row = {"phase": "smoke", "case": name, "direction": direction,
               "shape": list(ashape), "w": list(wshape), "tile_h": th,
               "split": sp, "max_rel_err": err, "tol": TOL[dt],
               "routes": {k: v for k, v in counts.items() if v},
               "pass": good}
        rows.append(row)
        emit(row)
    return ok


def route_takes(dtype, route, N, H, W, Ci, Co, k, grad):
    """Whether ``route`` takes the class (a plan for it exists)."""
    try:
        s2d_conv._plan(dtype, N, H, W, Ci, Co, k, grad_input=grad,
                       route=route)
    except ValueError:
        return False
    return True


def classes(dt, smi):
    dtype, routes = DTYPES[dt], ROUTES[dt]
    ok = True
    totals = {}
    seed = 100
    for model in MODELS:
        fwd = model_classes(model)
        for direction in ("forward", "grad_input"):
            rows = []
            for (xs, ws, has_bias), count in sorted(fwd.items()):
                k, _, Ci, Co = ws
                N, H, W, _ = xs
                grad = direction == "grad_input"
                ashape = (N, H, W, Co) if grad else xs
                if grad and Ci % s2d_conv._unit(dtype):
                    continue    # no kernel takes it (the stem's input)
                plan = s2d_conv._plan(dtype, N, H, W, Ci, Co, k,
                                      grad_input=grad)
                a, w, b = inputs(direction, ashape, ws, has_bias, seed,
                                 dtype)
                seed += 1
                kernel, plain, library, ref = calls(direction, a, w, b)
                gflop, bound, by = cs.conv_bound(direction, N, H, W, k, Ci,
                                                 Co, dtype.itemsize,
                                                 BOUND_ROUTE[dt])
                row = {"phase": "class", "model": model,
                       "direction": direction, "shape": list(ashape),
                       "w": list(ws), "count": count, "route": plan[0],
                       "tile_h": plan[1], "split": plan[2], "gflop": gflop,
                       "bound_ms": bound, "bound_by": by, "nvidia_smi": smi}
                t = [cs.cuda_ms(torch, plain), cs.cuda_ms(torch, plain)]
                row["plain_ms"] = sum(t) / 2
                row["library_ms"] = (row["plain_ms"] if not grad else
                                     (cs.cuda_ms(torch, library)
                                      + cs.cuda_ms(torch, library)) / 2)
                good = True
                for rt in routes:
                    if not route_takes(dtype, rt, N, H, W, Ci, Co, k, grad):
                        continue
                    with forced_plan(rt):
                        err = rel_err(kernel(), ref)
                        r = {"max_rel_err": err,
                             "ms": (cs.cuda_ms(torch, kernel)
                                    + cs.cuda_ms(torch, kernel)) / 2,
                             "device_ms": cs.queued_ms(torch, kernel)[0],
                             "plan": list(s2d_conv._plan(
                                 dtype, N, H, W, Ci, Co, k,
                                 grad_input=grad))}
                    r["bound_share"] = bound / r["device_ms"]
                    tol = TOL[dt] if rt == routes[0] else cs.TOL_F32 if (
                        dt == "f32") else cs.TOL_BF16
                    good = good and math.isfinite(err) and err <= tol
                    row[rt] = r
                row["pass"] = good
                ok = ok and good
                rows.append(row)
                emit(row)
            tot = {"launches": sum(r["count"] for r in rows),
                   "routes": dict(Counter(r["route"] for r in rows
                                          for _ in range(r["count"])))}
            for key in ("library_ms", "plain_ms", "bound_ms", "gflop"):
                tot[key] = sum(r[key] * r["count"] for r in rows)
            # the plan's mix, and each route alone on the classes it takes
            tot["plan_device_ms"] = sum(r[r["route"]]["device_ms"]
                                        * r["count"] for r in rows)
            for rt in routes:
                mine = [r for r in rows if rt in r]
                tot[f"{rt}_device_ms"] = sum(r[rt]["device_ms"] * r["count"]
                                             for r in mine)
                tot[f"{rt}_classes"] = len(mine)
            tot["plan_bound_share"] = tot["bound_ms"] / tot["plan_device_ms"]
            totals[f"{model}_{direction}"] = tot
    emit({"phase": "totals", "dtype": dt, **totals, "nvidia_smi": smi})
    return ok


# the library's error strings, which ops/_cuda.py reads every entry's
# errors through, for a variant library that holds one route's source alone
ERROR_STRING_STUB = """#include <cuda_runtime.h>
extern "C" const char* same_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


def build_variants(dt):
    """Build every variant library of the dtype at once; {name: path}."""
    source = SOURCES[dt]
    procs, paths = [], {}
    texts = {source.name: source.read_text(), HEADER.name: HEADER.read_text()}
    for name, edits in VARIANTS[dt].items():
        files = dict(texts)
        for old, new in edits:
            hits = {f: t.count(old) for f, t in files.items()}
            if sum(hits.values()) != 1:
                raise SystemExit(f"variant {name}: edit matches {hits}: "
                                 f"{old!r}")
            f = next(f for f, n in hits.items() if n)
            files[f] = files[f].replace(old, new)
        d = VARIANT_DIR / dt / name
        d.mkdir(parents=True, exist_ok=True)
        for f, t in files.items():
            (d / f).write_text(t)
        (d / "error_string.cu").write_text(ERROR_STRING_STUB)
        lib = d / "libvariant.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(d / source.name), str(d / "error_string.cu")]
        procs.append((name, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        paths[name] = lib
    for name, cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed:\n{' '.join(cmd)}\n{err}")
    return paths


def load_variant(path, route):
    """A variant library with the argtypes of ``ops/_cuda.py``."""
    lib = ctypes.CDLL(str(path))
    for direction, types in (("forward", _cuda.ROUTED_FORWARD_ARGTYPES),
                             ("grad_input",
                              _cuda.ROUTED_GRAD_INPUT_ARGTYPES)):
        fn = getattr(lib, f"same_conv_{route}_{direction}")
        fn.argtypes, fn.restype = types, ctypes.c_int
    lib.same_conv_error_string.argtypes = [ctypes.c_int]
    lib.same_conv_error_string.restype = ctypes.c_char_p
    return lib


@contextmanager
def library(lib):
    """The conv wrappers launch from ``lib`` inside the block."""
    orig = _cuda._lib
    _cuda._lib = lib
    try:
        yield
    finally:
        _cuda._lib = orig


def variants(dt, smi):
    """Each variant and each tile height on the dtype's variant classes, in
    turns; in f32 each variant's error against plain as well."""
    dtype, (route, _) = DTYPES[dt], ROUTES[dt]
    libs = {name: load_variant(path, route)
            for name, path in build_variants(dt).items()}
    chosen = VARIANT_CLASSES if dt == "bf16" else VARIANT_CLASSES_F32
    for i, (name, direction, ashape, wshape, has_bias) in enumerate(chosen):
        a, w, b = inputs(direction, ashape, wshape, has_bias, 500 + i,
                         dtype)
        kernel, _, _, ref = calls(direction, a, w, b)
        N, H, W, _ = ashape
        k, _, Ci, Co = wshape
        grad = direction == "grad_input"
        plan = s2d_conv._plan(dtype, N, H, W, Ci, Co, k, grad_input=grad,
                              route=route)
        cob = s2d_conv.wgmma_co_block(Ci if grad else Co, dtype)
        runs = [(v, libs[v], None) for v in VARIANTS[dt]]
        runs += [(f"committed_th{th}", libs["committed"], th)
                 for th in s2d_conv.TILE_HEIGHTS if th != plan[1]
                 and (th < 16 or cob <= s2d_conv._wgmma_tall_max(dtype))]
        times, errs, failed = {}, {}, {}
        for order in (runs, runs[::-1]):
            for v, lib, th in order:
                if v in failed:
                    continue
                with library(lib), forced_plan(route, th):
                    try:
                        if dt == "f32" and v not in errs:
                            errs[v] = rel_err(kernel(), ref)
                        times.setdefault(v, []).append(
                            cs.queued_ms(torch, kernel)[0])
                    except RuntimeError as e:
                        failed[v] = str(e)
        gflop, bound, _ = cs.conv_bound(direction, N, H, W, k, Ci, Co,
                                        dtype.itemsize, BOUND_ROUTE[dt])
        emit({"phase": "variants", "dtype": dt, "class": name,
              "plan": list(plan), "bound_ms": bound,
              "device_ms": {v: sum(t) / len(t) for v, t in times.items()},
              "max_rel_err": errs, "failed": failed, "nvidia_smi": smi})


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                        help="bf16: the \"wgmma\" kernel; f32: "
                        "\"wgmma_tf32\"")
    parser.add_argument("--smoke", action="store_true",
                        help="build and the small cases only")
    parser.add_argument("--variants", action="store_true",
                        help="time the design variants instead of the "
                        "classes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv_wgmma: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "dtype": args.dtype})
    _cuda.library()
    rc, lines = ptxas_report(SOURCES[args.dtype])
    emit({"phase": "ptxas", "rc": rc, "lines": lines})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = smoke(args.dtype)
    if ok and args.variants:
        variants(args.dtype, smi)
    elif ok and not args.smoke:
        ok = classes(args.dtype, smi)
    emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
