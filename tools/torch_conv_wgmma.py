#!/usr/bin/env python3
"""The bf16 k x k conv's ``"wgmma"`` kernel
(``consistent_depth_tpu_torch/csrc/same_conv_wgmma.cu``) alone on one H100:
build, check and time it before the whole ``chip_smoke.py``.

1. build: the port's library (every source, as ``ops/_cuda.py`` builds it),
   then the wgmma source once more with ``-Xptxas -v``: registers, spills
   and shared memory per instantiation;
2. smoke: small cases that reach every instantiation (output-channel block
   16/32/64/128 x direction x one or two m64 tiles per warpgroup x 16, 32
   or 64 reduction channels per chunk), every
   reduction chunk (16/32/64 channels), k = 3 and 11, ragged rows, columns
   and channels, a split reduction and a forward into 2 channels, each
   launched alone and synchronised, against ``same_conv_reference`` (or its
   grad-input) within 2^-7 of max |ref|; a wait on an mbarrier that never
   completes traps in the kernel (about 10 s), so a fault of the ring ends
   the run with a CUDA error rather than a hang;
3. classes (unless ``--smoke``): every bf16 conv class of one batch-8
   forward at 224x384 of ``mc``, ``midas2`` and ``monodepth2`` (traced on
   the meta device), forward and grad-input: the plan's route, the error
   against plain, and CUDA-event times of the plan's kernel, of ``"tc"`` (the
   earlier design) on the same inputs, of cuDNN (fprop; dgrad for the
   grad-input), the kernels' device times alone (``chip_smoke.queued_ms``:
   calls queued behind a sleep kernel), with the class's bound (its operations over 989 TFLOP/s or
   its bytes over 3.35 TB/s, the larger) and share; then totals per model
   and direction.

With ``--variants``, instead of 2-3: text-edited copies of the wgmma
source (each edit must match exactly once), each built with ``same_conv.cu``
into its own library under ``build/conv_wgmma_variants/``, all builds at
once, and timed in turns on ``VARIANT_CLASSES`` through the same wrapper:
``committed``; ``no_mma`` (the consumers skip the wgmmas: the copies, the
barriers and the A loads alone); ``no_ldmatrix`` (zero A fragments: the
copies, the barriers and the wgmmas); ``neither``; on ``neither``, the
consumers polling with ``test_wait`` (``neither_test_wait``), the producer
prefetching both tensor maps (``neither_prefetch``) and the weight stages
completed by an arrival with no copy (``neither_no_weight_tma``); and the
tile heights the plan did not pick, on the committed source. Their outputs are wrong by
design and only timed.

One JSON line per result; exits non-zero if a case disagrees. Usage, from
the root of a checkout on the card: ``python3 tools/torch_conv_wgmma.py
[--smoke | --variants]``.
"""

import argparse
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

SOURCE = _cuda.CSRC_DIR / "same_conv_wgmma.cu"
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
# tiles the plan would not pick at these sizes, and splits: (case name,
# tile_h, split)
FORCED = [("fwd_k11_32to32", 16, 1), ("fwd_k11_32to32", 8, 3),
          ("gx_k11_32to32", 16, 2), ("gx_k5_256to256", 8, 1)]


def instantiation_cases():
    """One k=3 case per instantiation of the kernel, forced to its tile:
    output-channel block 16/32/64/128 x direction x one or two m64 tiles a
    warpgroup (16-row tiles) x 16/32/64 reduction channels a chunk.
    (name, direction, shape of x or ct, w shape, bias, tile_h, split)"""
    cases = []
    for direction in ("forward", "grad_input"):
        for cob in s2d_conv.WGMMA_CO_BLOCKS:
            for chunk in s2d_conv.WGMMA_CHUNKS:
                for th in (8, 16):
                    if th == 16 and cob > s2d_conv.WGMMA_TALL_MAX_CO_BLOCK:
                        continue
                    out, red = cob - 8 if cob > 16 else cob, chunk
                    ci, co = (out, red) if direction == "grad_input" else (
                        red, out)
                    cases.append((f"{direction}_n{cob}_k{chunk}_th{th}",
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
PREFETCH = ("    if (tid != 0) return;\n",
            "    if (tid != 0) return;\n"
            "    asm volatile(\"prefetch.tensormap [%0];\" :: "
            "\"l\"(reinterpret_cast<uint64_t>(&xmap)) : \"memory\");\n"
            "    asm volatile(\"prefetch.tensormap [%0];\" :: "
            "\"l\"(reinterpret_cast<uint64_t>(&wmap)) : \"memory\");\n")
# the producer completes each weight stage by an arrival alone, with no
# copy: the barriers' handshake without the weights' TMA
NO_WEIGHT_TMA = [("        mbar_expect_tx(full, stage_tx);\n",
                  "        mbar_arrive(full);\n"),
                 ("        if (!GRAD) {\n          tma_load_4d(dst, &wmap,",
                  "        if (stage_tx == 0) {\n          tma_load_4d(dst, "
                  "&wmap,"),
                 ("          for (int a = 0; a < p.b_atoms; ++a)\n",
                  "          for (int a = 0; a < p.b_atoms * 0; ++a)\n")]
NEITHER = [ZERO_A, NO_MMA]
VARIANTS = {"committed": [], "no_mma": [NO_MMA], "no_ldmatrix": [ZERO_A],
            "neither": NEITHER,
            "neither_test_wait": NEITHER + [TEST_WAIT],
            "neither_prefetch": NEITHER + [PREFETCH],
            "neither_no_weight_tma": NEITHER + NO_WEIGHT_TMA}
VARIANT_DIR = REPO / "build" / "conv_wgmma_variants"


def emit(obj):
    print(json.dumps(obj), flush=True)


def ptxas_report():
    """nvcc -Xptxas -v on the wgmma source: one line per kernel."""
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
           "/dev/null", str(SOURCE)]
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


def inputs(direction, ashape, wshape, has_bias, seed):
    """bf16 operands with the main path's strides: channels_last NHWC views
    and an HWIO view of an OIHW channels_last weight."""
    N, H, W, C = ashape
    k, _, Ci, Co = wshape
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((N, C, H, W), generator=g, device="cuda").to(
        torch.bfloat16, memory_format=torch.channels_last).permute(0, 2, 3, 1)
    w = (torch.randn((Co, Ci, k, k), generator=g, device="cuda")
         / math.sqrt(k * k * Ci)).to(
             torch.bfloat16, memory_format=torch.channels_last).permute(
                 2, 3, 1, 0)
    b = (0.1 * torch.randn((Co,), generator=g, device="cuda")).to(
        torch.bfloat16) if has_bias and direction == "forward" else None
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


def smoke():
    rows, ok = [], True
    cases = [(name, d, a, w, b, None, None) for name, d, a, w, b in SMOKE]
    by_name = {c[0]: c for c in SMOKE}
    cases += [(f"{name}_th{th}_split{sp}", *by_name[name][1:], th, sp)
              for name, th, sp in FORCED]
    cases += instantiation_cases()
    for i, (name, direction, ashape, wshape, has_bias, th, sp) in enumerate(
            cases):
        a, w, b = inputs(direction, ashape, wshape, has_bias, seed=i)
        kernel, _, _, ref = calls(direction, a, w, b)
        emit({"phase": "smoke_start", "case": name})
        with forced_plan("wgmma", th, sp):
            s2d_conv.reset_counts()
            got = kernel()
            torch.cuda.synchronize()
            counts = dict(s2d_conv.route_counts)
        err = rel_err(got, ref)
        good = (math.isfinite(err) and err <= cs.TOL_BF16
                and counts[f"{direction}_wgmma"] == 1)
        ok = ok and good
        row = {"phase": "smoke", "case": name, "direction": direction,
               "shape": list(ashape), "w": list(wshape), "tile_h": th,
               "split": sp, "max_rel_err": err, "tol": cs.TOL_BF16,
               "routes": {k: v for k, v in counts.items() if v},
               "pass": good}
        rows.append(row)
        emit(row)
    return ok


def classes(smi):
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
                plan = s2d_conv._plan(torch.bfloat16, N, H, W, Ci, Co, k,
                                      grad_input=grad)
                if plan[0] == "fma":
                    continue
                a, w, b = inputs(direction, ashape, ws, has_bias, seed)
                seed += 1
                kernel, plain, library, ref = calls(direction, a, w, b)
                err = rel_err(kernel(), ref)
                t = [cs.cuda_ms(torch, plain), cs.cuda_ms(torch, kernel),
                     cs.cuda_ms(torch, kernel), cs.cuda_ms(torch, plain)]
                row = {"phase": "class", "model": model,
                       "direction": direction, "shape": list(ashape),
                       "w": list(ws), "count": count, "route": plan[0],
                       "tile_h": plan[1], "split": plan[2],
                       "max_rel_err": err, "ms": (t[1] + t[2]) / 2,
                       "plain_ms": (t[0] + t[3]) / 2}
                row["device_ms"] = cs.queued_ms(torch, kernel)[0]
                if plan[0] == "wgmma":
                    with forced_plan("tc"):
                        row["tc_max_rel_err"] = rel_err(kernel(), ref)
                        row["tc_ms"] = (cs.cuda_ms(torch, kernel)
                                        + cs.cuda_ms(torch, kernel)) / 2
                        row["tc_device_ms"] = cs.queued_ms(torch, kernel)[0]
                else:
                    row["tc_max_rel_err"], row["tc_ms"] = err, row["ms"]
                    row["tc_device_ms"] = row["device_ms"]
                row["library_ms"] = (row["plain_ms"] if not grad else
                                     (cs.cuda_ms(torch, library)
                                      + cs.cuda_ms(torch, library)) / 2)
                gflop, bound, by = cs.conv_bound(direction, N, H, W, k, Ci,
                                                 Co, 2, "tc")
                row.update({"gflop": gflop, "bound_ms": bound,
                            "bound_by": by, "bound_share": bound / row["ms"],
                            "tc_bound_share": bound / row["tc_ms"],
                            "nvidia_smi": smi})
                row["pass"] = (err <= cs.TOL_BF16
                               and row["tc_max_rel_err"] <= cs.TOL_BF16)
                ok = ok and row["pass"]
                rows.append(row)
                emit(row)
            tot = {key: sum(r[key] * r["count"] for r in rows)
                   for key in ("ms", "tc_ms", "device_ms", "tc_device_ms",
                               "library_ms", "plain_ms", "bound_ms",
                               "gflop")}
            tot["bound_share"] = tot["bound_ms"] / tot["ms"]
            tot["tc_bound_share"] = tot["bound_ms"] / tot["tc_ms"]
            tot["launches"] = sum(r["count"] for r in rows)
            tot["routes"] = dict(Counter(r["route"] for r in rows
                                         for _ in range(r["count"])))
            totals[f"{model}_{direction}"] = tot
    emit({"phase": "totals", **totals, "nvidia_smi": smi})
    return ok


def build_variants():
    """Build every VARIANTS library at once; {name: path}."""
    procs, paths = [], {}
    text = SOURCE.read_text()
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: edit matches "
                                 f"{src.count(old)} times: {old!r}")
            src = src.replace(old, new)
        d = VARIANT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE.name).write_text(src)
        lib = d / "libvariant.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(d / SOURCE.name), str(_cuda.CSRC_DIR / "same_conv.cu")]
        procs.append((name, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        paths[name] = lib
    for name, cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed:\n{' '.join(cmd)}\n{err}")
    return paths


def load_variant(path):
    """A variant library with the argtypes of ``ops/_cuda.py``."""
    import ctypes
    lib = ctypes.CDLL(str(path))
    for direction, types in (("forward", _cuda.ROUTED_FORWARD_ARGTYPES),
                             ("grad_input",
                              _cuda.ROUTED_GRAD_INPUT_ARGTYPES)):
        fn = getattr(lib, f"same_conv_wgmma_{direction}")
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


def variants(smi):
    """Each variant and each tile height on VARIANT_CLASSES, in turns."""
    libs = {name: load_variant(path)
            for name, path in build_variants().items()}
    for i, (name, direction, ashape, wshape, has_bias) in enumerate(
            VARIANT_CLASSES):
        a, w, b = inputs(direction, ashape, wshape, has_bias, seed=500 + i)
        kernel, _, _, _ = calls(direction, a, w, b)
        N, H, W, _ = ashape
        k, _, Ci, Co = wshape
        grad = direction == "grad_input"
        plan = s2d_conv._plan(torch.bfloat16, N, H, W, Ci, Co, k,
                              grad_input=grad)
        runs = [(v, libs[v], None) for v in VARIANTS]
        runs += [(f"committed_th{th}", libs["committed"], th)
                 for th in s2d_conv.TILE_HEIGHTS if th != plan[1]
                 and (th < 16 or s2d_conv.wgmma_co_block(Ci if grad else Co)
                      <= s2d_conv.WGMMA_TALL_MAX_CO_BLOCK)]
        times = {}
        for order in (runs, runs[::-1]):
            for v, lib, th in order:
                with library(lib), forced_plan("wgmma", th):
                    times.setdefault(v, []).append(cs.cuda_ms(torch, kernel))
        gflop, bound, _ = cs.conv_bound(direction, N, H, W, k, Ci, Co, 2,
                                        "tc")
        emit({"phase": "variants", "class": name, "plan": list(plan),
              "bound_ms": bound,
              "ms": {v: sum(t) / len(t) for v, t in times.items()},
              "nvidia_smi": smi})


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
          "cuda": torch.version.cuda})
    _cuda.library()
    rc, lines = ptxas_report()
    emit({"phase": "ptxas", "rc": rc, "lines": lines})
    torch.backends.cudnn.allow_tf32 = False
    ok = smoke()
    if ok and args.variants:
        variants(smi)
    elif ok and not args.smoke:
        ok = classes(smi)
    emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
