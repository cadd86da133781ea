#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics from a traced run (``--trace 1``) as the last line of standard
output, one JSON object; each number of the output check beside its limit
as the last lines of standard error. Exits non-zero, printing no result,
without a CUDA card (or with fewer than the cell asks for), and when a
module of jax, jaxlib, flax or the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its kernels into build/cuda/ there itself)."""
    root = REPO / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_compute_cache")):
        os.environ[var] = str(root / sub)
    # a library that would load JAX by itself does not
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _caches()
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark.harness import runner, spec

    if not torch.cuda.is_available():
        print("run.py: no CUDA card; the benchmark measures only on one",
              file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda")
    found = runner.forbidden_modules(sys.modules)
    if found:
        print(f"run.py: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    smi = power_limit()
    out.result["device"]["power_limit"] = smi
    print(f"card: {smi}", file=sys.stderr)
    print("setup phases (s): " + ", ".join(
        f"{name} {s:.3f}" for name, s in out.record["setup_phases"]),
        file=sys.stderr)
    calls = out.record["calls"]
    host = [t for _, t in calls]
    first = host[:max(len(host) // 4, 1)]
    print(f"window: {len(calls)} calls, host s per call {min(host):.4f}-"
          f"{max(host):.4f}, median {statistics.median(host):.4f}, first "
          f"quarter's mean {statistics.mean(first):.4f}, units per call "
          f"{min(u for u, _ in calls)}-{max(u for u, _ in calls)}",
          file=sys.stderr)
    for name, c in out.result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
