"""One run of one cell: set-up, the measured window, the optional profiled
span, the output check against the reference, and the result line.

An entry module (``benchmark/entries/<entry>.py``) provides:

- ``KIND``: "train" or "eval", which metric readers key on;
- ``setup(run) -> state``: data, weights and the program's objects, with
  every shape the cell uses warmed up;
- ``call(state) -> Work``: one call of the program's entry, as the window
  drives it, queued and not waited for where the entry allows;
- ``close(state) -> int``: after the window's synchronize, the units that
  failed;
- ``release(state)``: drop the program's objects;
- ``check(state, rounding=None) -> {name: reading}``: the readings compared
  with the workload's limits, of the program against the f32 reference, or
  with ``rounding`` of the control (the reference at that rounding) in the
  program's place.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from . import trace as trace_mod
from .roofline import PEAK_TFLOPS
from .spec import Cell

WINDOW = "bench.window"


@dataclass
class Work:
    """What one call did: units of the cell's rate (pairs or frames),
    model FLOP of those units, train steps, and the least seconds of its
    work by class (``roofline.bounds_s``: "kxk", "linear", "attention")."""

    units: int = 0
    flop: float = 0.0
    steps: int = 0
    bounds_s: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Work") -> None:
        self.units += other.units
        self.flop += other.flop
        self.steps += other.steps
        for k, v in other.bounds_s.items():
            self.bounds_s[k] = self.bounds_s.get(k, 0.0) + v


@dataclass
class Run:
    cell: Cell
    seed: int
    device: torch.device
    # (phase, host seconds at its end) of the set-up, for the run's log
    marks: List[Tuple[str, float]] = field(default_factory=list)

    def mark(self, phase: str) -> None:
        self.sync()
        self.marks.append((phase, time.perf_counter()))

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic

    @property
    def precision(self) -> str:
        return self.cell.precision

    @property
    def reference(self):
        return self.cell.reference

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Outcome:
    result: dict
    record: dict


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, rounding: Optional[str] = None) -> Outcome:
    """Run ``cell`` once. With ``rounding`` the check reads the control in
    the program's place (calibration only)."""
    entry = cell.entry
    run = Run(cell, int(seed), torch.device(device))
    t0 = time.perf_counter()
    run.marks.append(("start", t0))
    state = entry.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t0
    run.marks.append(("warm-up", t0 + setup_s))

    work, issue_s, calls = Work(), 0.0, []
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        a = time.perf_counter()
        w = entry.call(state)
        b = time.perf_counter()
        work.add(w)
        issue_s += b - a
        calls.append((w.units, b - a))
        if b >= deadline:
            break
    run.sync()
    window_s = time.perf_counter() - start

    summary, span = None, Work()
    if trace:
        summary, span = _profiled_spans(
            run, entry, state, int(cell.workload.get("trace_calls", 2)))
    info = device_info(run.device, cell.chips)
    failed = entry.close(state)
    entry.release(state)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = entry.check(state, rounding)

    record = {
        "kind": entry.KIND, "setup_s": setup_s, "window_s": window_s,
        "calls": calls, "units": work.units, "steps": work.steps,
        "flop": work.flop, "issue_s": issue_s,
        "peak_flops": PEAK_TFLOPS[cell.precision] * 1e12,
        "trace": None,
    }
    if summary is not None:
        record["trace"] = dict(summary, bounds_s=span.bounds_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader.read(record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    limits = cell.workload["limits"]
    checks = {k: {"value": readings.get(k, math.nan), "limit": limits[k]}
              for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    result = {"correct": correct, "attempted": work.units,
              "failed": int(failed), "metrics": metrics, "device": info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    record["setup_phases"] = [
        (name, t - run.marks[i][1])
        for i, (name, t) in enumerate(run.marks[1:])]
    return Outcome(result, record)


def _profiled_spans(run: Run, entry, state, calls: int):
    """``calls`` more calls profiled with device activity alone, then one
    with the host's ops too and the program's spans on. Returns (the trace
    summary or None, the second span's Work)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    try:
        from consistent_depth_tpu_torch.utils.tracing import enabled
    except ImportError:       # a program without spans: none to read
        enabled = contextlib.nullcontext
    device = ([ProfilerActivity.CUDA] if run.device.type == "cuda"
              else [ProfilerActivity.CPU])
    run.sync()
    with profile(activities=device) as prof:
        for _ in range(calls):
            entry.call(state)
        run.sync()
    steady = trace_mod.steady(prof)
    span = Work()
    with profile(activities=sorted({ProfilerActivity.CPU, *device},
                                   key=lambda a: a.value)) as prof:
        with record_function(WINDOW):
            with enabled():
                span.add(entry.call(state))
            run.sync()
    attributed = trace_mod.attribution(prof, WINDOW)
    if steady is None or attributed is None:
        return None, span
    return dict(steady, **attributed), span


FORBIDDEN = ("jax", "jaxlib", "flax", "consistent_depth_tpu")


def forbidden_modules(modules) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
