#!/usr/bin/env python3
"""Design variants of the port's f32 conv kernel (3xTF32,
``consistent_depth_tpu_torch/csrc/same_conv_tf32.cu``) on one H100, timed
against the committed kernel in one process.

Each variant is the committed ``csrc/`` with checked text substitutions in
``same_conv_tf32.cu`` (each must match exactly once), built into its own
library under ``build/conv_variants/``, all builds at once:

- ``committed``: the sources as they are;
- ``chained``: each tap's three MMAs accumulate straight into the running
  accumulator instead of a zeroed partial that the FP32 pipes add;
- ``register_split``: operands split in registers after every fragment
  load, instead of once per step in shared memory;
- ``co_block_64``: output-channel blocks of up to 64, as in bf16.

With ``--parent DIR`` (a checkout of another commit, e.g. the parent
unpacked with ``git archive`` into ``build/parent``) a ``parent_bf16``
library is built from the committed sources with that checkout's
``same_conv_tc.cu``, and the bf16 kernel is timed against it.

It prints each variant's f32 source's registers and spill bytes per
instantiation (``nvcc -Xptxas -v``), then for every conv class of the main
path (one batch-8 forward at 224x384 and the 67 grad-inputs of a train
step), on the mma.sync route of each dtype (``"tf32"``, ``"tc"``) whatever
route the plan gives the class, each variant's CUDA-event time and its error against plain (max |d| /
max |ref|, cuDNN with TF32 off), timed in turns (a, b, c, c, b, a), and the
totals weighted by the classes' counts, one JSON line each.

Usage, from the root of a checkout on the card:
``python3 tools/torch_conv_variants.py [--parent build/parent]``
"""

import argparse
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from consistent_depth_tpu_torch.models.registry import (  # noqa: E402
    create_depth_model)
from consistent_depth_tpu_torch.ops import _cuda, s2d_conv  # noqa: E402

TF32 = "same_conv_tf32.cu"
# each dtype's mma.sync route, timed here whatever the plan's route
TC_ROUTE = {"f32": "tf32", "bf16": "tc"}
OUT_DIR = REPO / "build" / "conv_variants"

CHAINED = [("""  float t0[4] = {0.f, 0.f, 0.f, 0.f};
  float t1[4] = {0.f, 0.f, 0.f, 0.f};
  mma1688(t0, as[0], bb0, bb1);
  mma1688(t1, as[1], bb0, bb1);
  mma1688(t0, ab[0], bs0, bs1);
  mma1688(t1, ab[1], bs0, bs1);
  mma1688(t0, ab[0], bb0, bb1);
  mma1688(t1, ab[1], bb0, bb1);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d0[q] += t0[q];
    d1[q] += t1[q];
  }
""", """  mma1688(d0, as[0], bb0, bb1);
  mma1688(d1, as[1], bb0, bb1);
  mma1688(d0, ab[0], bs0, bs1);
  mma1688(d1, ab[1], bs0, bs1);
  mma1688(d0, ab[0], bb0, bb1);
  mma1688(d1, ab[1], bb0, bb1);
""")]
REGISTER_SPLIT = [
    ("static constexpr bool SPLIT = true;",
     "static constexpr bool SPLIT = false;"),
    ("      ldsm4(as[m], a[m] + a2);\n",
     "#pragma unroll\n      for (int q = 0; q < 4; ++q)\n"
     "        split(ab[m][q], ab[m][q], as[m][q]);\n"),
    ("        ldsm4(bs, addr + w2);\n",
     "#pragma unroll\n        for (int q = 0; q < 4; ++q)\n"
     "          split(bb[q], bb[q], bs[q]);\n"),
    ("""        mma3(acc[0][j], acc[1][j], ab, as, lds32(addr0), lds32(addr1),
             lds32(addr0 + w2), lds32(addr1 + w2));
""", """        uint32_t bb0, bb1, bs0, bs1;
        split(lds32(addr0), bb0, bs0);
        split(lds32(addr1), bb1, bs1);
        mma3(acc[0][j], acc[1][j], ab, as, bb0, bb1, bs0, bs1);
"""),
]
CO_BLOCK_64 = [("static constexpr int MAX_COB = 32;",
                "static constexpr int MAX_COB = 64;")]
F32_VARIANTS = {"committed": [], "chained": CHAINED,
                "register_split": REGISTER_SPLIT, "co_block_64": CO_BLOCK_64}


def build_variant(name, edits, tc_source=None):
    """Build the committed sources with ``edits`` to the f32 source (and
    ``tc_source`` in place of same_conv_tc.cu); return the library path and
    the f32 source's registers and spills."""
    root = OUT_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_cuda.CSRC_DIR, root / "csrc")
    src = root / "csrc" / TF32
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: edit does not match once: {old[:60]}")
        text = text.replace(old, new)
    src.write_text(text)
    if tc_source:
        shutil.copy(tc_source, root / "csrc" / "same_conv_tc.cu")
    _cuda.CSRC_DIR, _cuda.BUILD_DIR = root / "csrc", root / "cuda"
    return str(_cuda.build()), ptxas_summary(str(src))


def ptxas_summary(src):
    """``Used N registers`` and spills of each tensor-core kernel in
    ``src``, by (k, Co block, grad-input)."""
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
           os.devnull, src]
    lines = subprocess.run(cmd, capture_output=True, text=True,
                           check=True).stderr.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"conv_tc_kernel\D*Li(\d+)ELi(\d+)ELb(\d)", line)
        if "Compiling entry function" in line and m:
            info = " ".join(lines[i + 1:i + 5])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            out[f"k{m[1]}_cob{m[2]}_{'grad' if m[3] == '1' else 'fwd'}"] = (
                int(regs[1]) if regs else None, int(spill[1]) if spill else 0)
    return out


def load(path):
    _cuda._lib = None
    real = _cuda.build
    _cuda.build = lambda: Path(path)
    try:
        return _cuda.library()
    finally:
        _cuda.build = real


def class_inputs(direction, xs, ws, has_bias, seed):
    """Inputs of one class with the main path's strides (as chip_smoke)."""
    N, H, W, _ = xs
    k, _, Ci, Co = ws
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = Ci if direction == "forward" else Co
    a = torch.randn((N, C, H, W), generator=g, device="cuda").to(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    w = (torch.randn((Co, Ci, k, k), generator=g, device="cuda")
         / (k * k * Ci) ** 0.5).to(
             memory_format=torch.channels_last).permute(2, 3, 1, 0)
    b = (0.1 * torch.randn((Co,), generator=g, device="cuda")
         if has_bias and direction == "forward" else None)
    return a, w, b


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="checkout whose same_conv_tc.cu "
                        "the bf16 kernel is timed against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_variants: no CUDA device")

    def emit(obj):
        print(json.dumps(obj), flush=True)

    smi = cs.nvidia_smi_line()
    builds = dict(F32_VARIANTS.items())
    by_dtype = {"f32": list(F32_VARIANTS), "bf16": ["committed"]}
    tc_parent = None
    if args.parent:
        tc_parent = str(Path(args.parent).resolve() / "consistent_depth_tpu_torch"
                        / "csrc" / "same_conv_tc.cu")
        builds["parent_bf16"] = []
        by_dtype["bf16"].append("parent_bf16")
    with ProcessPoolExecutor(
            len(builds), mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {n: ex.submit(build_variant, n, e,
                             tc_parent if n == "parent_bf16" else None)
                for n, e in builds.items()}
        built = {n: f.result() for n, f in futs.items()}
    libs = {n: load(path) for n, (path, _) in built.items()}
    emit({"ptxas_f32": {n: regs for n, (_, regs) in built.items()
                        if n in F32_VARIANTS}, "nvidia_smi": smi})

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    probe = create_depth_model("mc", checkpoint="", device="cuda",
                               dtype=torch.bfloat16)
    classes = cs.record_conv_classes(torch, s2d_conv, probe)
    del probe
    totals = {}
    for i, ((xs, ws, hb), count) in enumerate(sorted(classes.items())):
        for direction in ("forward", "grad_input"):
            if direction == "grad_input" and xs[3] == 3:
                continue       # the stem's input needs no gradient
            a32, w32, b32 = class_inputs(direction, xs, ws, hb, seed=i)
            row = {"direction": direction, "x": list(xs), "w": list(ws),
                   "count": count}
            for dt, names in by_dtype.items():
                tdt = torch.float32 if dt == "f32" else torch.bfloat16
                a, w = a32.to(tdt), w32.to(tdt)
                b = b32.to(tdt) if b32 is not None else None
                if direction == "forward":
                    def fn():
                        return s2d_conv.same_conv(a, w, b)
                    ref = s2d_conv.same_conv_reference(
                        a.float(), w.float(), b.float() if b is not None
                        else None)
                else:
                    def fn():
                        return s2d_conv.same_conv_grad_input(a, w)
                    ref = s2d_conv.same_conv_grad_input_reference(
                        a.float(), w.float())
                scale = ref.abs().max().item()
                ms, err = dict.fromkeys(names, 0.0), {}
                # the mma.sync kernels of the dtype, whatever the plan's
                # route: "tf32" (the source the variants edit) and "tc"
                with cs.forced_route(s2d_conv, TC_ROUTE[dt]):
                    for n in names + names[::-1]:
                        _cuda._lib = libs[n]
                        s2d_conv.MAX_CO_BLOCK[torch.float32] = (
                            64 if n == "co_block_64" else 32)
                        if n not in err:
                            err[n] = ((fn().float() - ref).abs().max().item()
                                      / scale)
                        ms[n] += cs.cuda_ms(torch, fn) / 2
                s2d_conv.MAX_CO_BLOCK[torch.float32] = 32
                for n in names:
                    key = f"{direction}_{dt}_{n}"
                    row[key] = {"ms": ms[n], "err": err[n]}
                    t = totals.setdefault(key, {"ms": 0.0, "max_err": 0.0})
                    t["ms"] += ms[n] * count
                    t["max_err"] = max(t["max_err"], err[n])
            emit(row)
    emit({"totals": totals, "nvidia_smi": smi})


if __name__ == "__main__":
    main()
