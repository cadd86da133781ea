#!/usr/bin/env python3
"""Where the banded correlation kernel's time goes, on one H100.

Builds ``consistent_depth_tpu_torch/csrc/correlation.cu`` as it is and with
one part of the banded kernel switched off by a checked text substitution
(each must match exactly once), each into its own library under
``build/corr_parts/``, all builds at once:

- ``committed``: the source as it is;
- ``no_store``: the epilogue's stores are skipped (kept only behind a test
  that never holds, so the sums are still computed);
- ``no_compute``: the FMAs are skipped; staging and stores stay;
- ``no_stage``: only chunk 0 is copied; the later chunks compute on what
  the ring holds;
- ``compute_only``: neither the later chunks' copies nor the stores.

It prints the committed source's registers and spill bytes per banded
instantiation (``nvcc -Xptxas -v``), then, at FlowNet2's (1, 56, 128, 256)
with r = 10 on NHWC views of channels_last tensors, each part's device time
per call (``chip_smoke.queued_ms``: CUDA events around calls queued
behind a sleep kernel), in turns
(committed first and last), one JSON line each. Only ``committed`` computes
the cost volume; its error against ``correlation_reference`` is printed.

Usage, from the root of a checkout on the card:
``python3 tools/torch_corr_parts.py``
"""

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from consistent_depth_tpu_torch.flow import correlation as corr  # noqa: E402
from consistent_depth_tpu_torch.ops import _cuda  # noqa: E402

OUT_DIR = REPO / "build" / "corr_parts"
SHAPE = (1, 56, 128, 256)
R = 10

NO_STORE = [("o[j] = acc[k][j] / rc;",
             "if (acc[k][j] == 1234.5f) o[j] = 0.f;")]
NO_COMPUTE = [("    if (active) {\n      const float4* a_base",
               "    if (active && C < 0) {\n      const float4* a_base")]
NO_STAGE = [("    if (ch + 1 < nchunks)\n      stage(ch + 1);",
             "    if (ch + 1 < nchunks && C < 0)\n      stage(ch + 1);")]
PARTS = {"committed": [], "no_store": NO_STORE, "no_compute": NO_COMPUTE,
         "no_stage": NO_STAGE, "compute_only": NO_STAGE + NO_STORE}


def build(name, edits):
    src = (_cuda.CSRC_DIR / "correlation.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: edit does not match once: {old!r}")
        src = src.replace(old, new)
    cu = OUT_DIR / f"{name}.cu"
    so = OUT_DIR / f"{name}.so"
    cu.write_text(src)
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr}")
    return so, proc.stderr


def ptxas_summary(log):
    """{instantiation: [registers, spill store bytes]} for the banded
    kernels in an ``-Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"correlation_banded_kernelILi(\d+)ELi(\d+)E",
                          m.group(1))
            name = f"r{k.group(1)}_G{k.group(2)}" if k else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if name and m:
            out[name] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out[name][0] = int(m.group(1))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_corr_parts: no CUDA device")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(PARTS)) as ex:
        built = dict(zip(PARTS, ex.map(lambda kv: build(*kv), PARTS.items())))
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line(), "ptxas":
                      ptxas_summary(built["committed"][1])}), flush=True)

    B, H, W, C = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    f1, f2 = (torch.randn((B, C, H, W), generator=g, device="cuda").to(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for _ in range(2))
    ref = corr.correlation_reference(f1, f2, 2 * R, 2)
    out = torch.empty_like(ref)
    fns = {}
    for name, (so, _) in built.items():
        fn = ctypes.CDLL(str(so)).correlation_banded_forward
        fn.argtypes = _cuda.CORRELATION_BANDED_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn

    order = list(PARTS)
    for name in order + order[::-1]:
        row = {"part": name}

        def run(fn=fns[name]):
            err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C,
                     R, *f1.stride()[:3], *f2.stride()[:3],
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")
        run()
        torch.cuda.synchronize()
        if name == "committed":
            row["max_rel_err"] = ((out - ref).abs().max()
                                  / ref.abs().max()).item()
        row["ms"], row["queue_hid_host"] = cs.queued_ms(torch, run)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
