"""Finding a cell's parts by name. Each lives in a file of its own, so that
a configuration, a traffic mix, a cell or a metric is added by adding
files:

- ``BENCHMARK.json`` at the repository root: the cells and the metrics;
- ``benchmark/workloads/<cell>.json``: the cell's configuration, traffic,
  entry, precision, chips and the limits of its output check;
- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters;
- ``benchmark/entries/<entry>.py``: the program's entry the window drives;
- ``benchmark/reference/<config>.py``: the plain reference network;
- ``benchmark/metrics/<metric>.py``: one metric's reader.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Mapping, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent
WORKLOAD_KEYS = {"config", "traffic", "entry", "precision", "chips", "why",
                 "limits"}


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _mangle(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclass
class Metric:
    name: str
    unit: str
    source: str
    workloads: Optional[List[str]]
    reader: ModuleType


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    entry: ModuleType
    reference: ModuleType
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    @property
    def precision(self) -> str:
        return self.workload["precision"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def reference_module(config: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``reference/<config>.py`` as a module of the ``reference`` package
    (it imports ``reference/common.py`` beside it)."""
    importlib.import_module("benchmark.reference")
    return _load(bench_dir / "reference" / f"{config}.py",
                 f"benchmark.reference.{_mangle(config)}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _load(bench_dir / "metrics" / f"{name}.py",
                 f"benchmark_metric_{_mangle(name)}")


def _metrics(entries, cell: str, bench_dir: Path) -> List[Metric]:
    return [Metric(m["name"], m["unit"], m["source"], m.get("workloads"),
                   metric_reader(m["name"], bench_dir))
            for m in entries if m.get("workloads") is None
            or cell in m["workloads"]]


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              benchmark: Optional[Mapping] = None) -> Cell:
    """The cell ``name``: its workload file and what it names. Its metrics
    are those of ``benchmark`` (default: the repository's BENCHMARK.json)
    that apply to it."""
    wl = _json(bench_dir / "workloads" / f"{name}.json")
    missing = WORKLOAD_KEYS - set(wl)
    if missing:
        raise ValueError(f"workload {name}: missing {sorted(missing)}")
    if benchmark is None:
        path = bench_dir.parent / "BENCHMARK.json"
        benchmark = _json(path) if path.is_file() else {}
    listed = [w for w in benchmark.get("workloads", []) if w["name"] == name]
    for w in listed:
        for key in ("config", "traffic", "chips"):
            if w[key] != wl[key]:
                raise ValueError(f"workload {name}: BENCHMARK.json says "
                                 f"{key}={w[key]!r}, the file {wl[key]!r}")
    return Cell(
        name=name, workload=wl,
        config=_json(bench_dir / "configs" / f"{wl['config']}.json"),
        traffic=_json(bench_dir / "traffic" / f"{wl['traffic']}.json"),
        entry=_load(bench_dir / "entries" / f"{wl['entry']}.py",
                    f"benchmark_entry_{_mangle(wl['entry'])}"),
        reference=reference_module(wl["config"], bench_dir),
        end_to_end=_metrics(benchmark.get("end_to_end", []), name, bench_dir),
        per_layer=_metrics(benchmark.get("per_layer", []), name, bench_dir))


def cell_names(bench_dir: Path = BENCH_DIR) -> List[str]:
    return sorted(p.stem for p in (bench_dir / "workloads").glob("*.json"))


def configs_of(bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    return {p.stem: _json(p)
            for p in sorted((bench_dir / "configs").glob("*.json"))}
