#!/usr/bin/env python3
"""The readings the output check's limits are set from, many seeds in one
process (the kernels are built once):

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--seconds 5] [--control tf32] [--fault unchanged|half_batch|altered]

For each seed, a run of the cell with a short window (``--seconds``) and
its check: the program against the f32 reference, or with ``--control``
the reference at that rounding in the program's place, or with ``--fault``
the program with the fault planted. One JSON line per seed on standard
output. The benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", choices=("tf32",))
    p.add_argument("--fault")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark.harness import faults, runner, spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        cell = spec.load_cell(args.workload)
        t0 = time.perf_counter()
        with faults.planted(args.fault):
            out = runner.run_cell(cell, seed, args.seconds, False,
                                  args.device, rounding=args.control)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": args.control, "fault": args.fault,
            "readings": {k: c["value"]
                         for k, c in out.result["checks"].items()},
            "units": out.record["units"], "setup_s": out.record["setup_s"],
            "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
