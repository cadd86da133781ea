"""Every cell's parts resolve by name, a cell is added by adding files, and
BENCHMARK.json keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness import spec

BENCH = json.loads((spec.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    for attr in ("setup", "call", "close", "release", "check", "KIND"):
        assert hasattr(cell.entry, attr)
    for attr in ("build", "depth", "tame"):
        assert hasattr(cell.reference, attr)
    # each cell reports setup_s, one more end-to-end and one per-layer metric
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    # every limit of the check is a positive number
    assert all(v > 0 for v in cell.workload["limits"].values())


def test_every_workload_file_is_a_cell():
    assert sorted(CELLS) == spec.cell_names()


def test_dropped_in_workload_is_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = json.loads((bench / "workloads" / "mc-eval-f32.json").read_text())
    wl.update(traffic="demo244-train", entry="train_epoch")
    (bench / "workloads" / "mc-new-cell.json").write_text(json.dumps(wl))
    cell = spec.load_cell("mc-new-cell", bench_dir=bench, benchmark={})
    assert cell.entry.KIND == "train"
    assert cell.traffic["steps_per_call"] > 0
    assert "mc-new-cell" in spec.cell_names(bench)


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert json.loads((spec.REPO / c["file"]).read_text())["name"] == \
            c["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        # the cells it lists report the metric it moves
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metric_reader_returns_nothing_for_other_kinds():
    record = {"kind": "eval", "window_s": 1.0, "units": 10, "flop": 1e12,
              "peak_flops": 1e15, "steps": 0, "issue_s": 1.0, "setup_s": 2.0,
              "trace": None}
    assert spec.metric_reader("train_pairs_per_s").read(record) is None
    assert spec.metric_reader("mfu.train").read(record) is None
    assert spec.metric_reader("device_idle.eval").read(record) is None
    assert spec.metric_reader("host_issue_ms.train").read(record) is None
    assert spec.metric_reader("eval_pairs_per_s").read(record) == 10.0
    assert spec.metric_reader("mfu.eval").read(record) == pytest.approx(0.1)
