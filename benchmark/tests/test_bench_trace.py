"""The traced run's readings: a span's device time by the union rule, and the
metric readers of the program's spans on a made-up record."""

from __future__ import annotations

import pytest

from benchmark.harness import spec, trace

TRAIN_SPANS = {
    "engine.step": {"device_s": 0.0, "count": 4},
    "kxk.forward": {"device_s": 0.030, "count": 272},
    "kxk.grad_input": {"device_s": 0.020, "count": 268},
    "kxk.grad_weight": {"device_s": 0.2, "count": 272},
    "step.loss": {"device_s": 0.0028, "count": 4},
    "step.optimizer": {"device_s": 0.0016, "count": 4},
}


def _record(kind, spans, bounds_s=None):
    return {"kind": kind, "window_s": 1.0, "units": 16, "flop": 1e12,
            "peak_flops": 1e15, "steps": 4, "issue_s": 0.5, "setup_s": 2.0,
            "trace": {"window_s": 0.6, "busy_s": 0.5, "device_ops": [],
                      "idle_gaps": [], "spans": spans,
                      "bounds_s": bounds_s or {"kxk": 0.0175, "linear": 0.0,
                                               "attention": 0.0}}}


def test_covered_counts_each_moment_once():
    busy = [(0.0, 2.0), (3.0, 5.0), (6.0, 7.0)]
    # two overlapping ranges over the first two kernels, one past the end
    assert trace.covered(busy, [(1.0, 4.0), (1.5, 3.5), (6.5, 9.0)]) == \
        pytest.approx(1.0 + 1.0 + 0.5)
    assert trace.covered(busy, []) == 0.0
    assert trace.covered(busy, [(2.0, 3.0)]) == 0.0


def _read(metric, record):
    return spec.metric_reader(metric).read(record)


def test_span_metrics_read_per_step():
    rec = _record("train", TRAIN_SPANS)
    assert _read("kxk_wgrad_device_ms.train", rec) == pytest.approx(50.0)
    assert _read("loss_device_ms.train", rec) == pytest.approx(0.7)
    assert _read("optimizer_device_ms.train", rec) == pytest.approx(0.4)
    # the k x k bound over the forward and grad-input spans' device time
    assert _read("kxk_conv_roofline.train", rec) == pytest.approx(35.0)
    # no grouped conv, no eval batch: nothing to read
    assert _read("grouped_wgrad_device_ms.train", rec) is None
    assert _read("loss_device_ms.eval", rec) is None
    grouped = dict(TRAIN_SPANS, **{
        "grouped.grad_weight": {"device_s": 0.0118, "count": 132}})
    assert _read("grouped_wgrad_device_ms.train",
                 _record("train", grouped)) == pytest.approx(2.95)


def test_span_metrics_read_per_eval_batch():
    rec = _record("eval", {"eval.batch": {"device_s": 0.0, "count": 8},
                           "eval.loss": {"device_s": 0.0054, "count": 8}})
    assert _read("loss_device_ms.eval", rec) == pytest.approx(0.675)
    assert _read("loss_device_ms.train", rec) is None


@pytest.mark.parametrize("drop", ["engine.step", "step.loss"])
def test_span_metrics_none_without_the_span(drop):
    spans = {k: v for k, v in TRAIN_SPANS.items() if k != drop}
    assert _read("loss_device_ms.train", _record("train", spans)) is None


def test_span_metrics_none_without_a_count_or_device_time():
    spans = dict(TRAIN_SPANS, **{"engine.step": {"device_s": 0.0,
                                                 "count": 0}})
    assert _read("optimizer_device_ms.train", _record("train", spans)) is None
    spans = dict(TRAIN_SPANS, **{"step.loss": {"device_s": 0.0, "count": 4}})
    assert _read("loss_device_ms.train", _record("train", spans)) is None


def test_kxk_roofline_needs_its_spans_and_bound():
    spans = {k: v for k, v in TRAIN_SPANS.items() if not k.startswith("kxk")}
    assert _read("kxk_conv_roofline.train", _record("train", spans)) is None
    no_bound = {"kxk": 0.0, "linear": 0.0, "attention": 0.0}
    assert _read("kxk_conv_roofline.train",
                 _record("train", TRAIN_SPANS, no_bound)) is None
    untraced = dict(_record("train", TRAIN_SPANS), trace=None)
    assert _read("kxk_conv_roofline.train", untraced) is None


class _Prof:
    """A profile's events, made up: host ops and spans, the device-side
    ranges of the spans, and kernels (times in us)."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _event(name, device, start, end, annotation=False):
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end))


def test_attribution_reads_the_spans():
    ev = [_event("bench.window", False, 0, 100, True),
          _event("engine.step", False, 1, 50, True),
          _event("engine.step", False, 50, 99, True),
          _event("kxk.forward", False, 2, 5, True),
          _event("kxk.forward", False, 52, 55, True),
          _event("aten::add", False, 20, 30),
          # device-side ranges of the spans, and the kernels
          _event("kxk.forward", True, 10, 30, True),
          _event("kxk.forward", True, 25, 40, True),
          _event("kxk.forward", True, 60, 70, True),
          _event("conv_kernel", True, 10, 20),
          _event("conv_kernel", True, 15, 38),
          _event("conv_kernel", True, 60, 70),
          _event("elementwise", True, 80, 90)]
    out = trace.attribution(_Prof(ev), "bench.window")
    assert out["spans"]["kxk.forward"] == {"device_s": pytest.approx(38e-6),
                                           "count": 2}
    assert out["spans"]["engine.step"] == {"device_s": 0.0, "count": 2}
    assert "bench.window" not in out["spans"]
    # idle from 0 to 10 (no host op yet), then 38 to 60, 70 to 80 and 90 to
    # 100, each under a step (the add has ended by 38)
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"engine.step": 42e-6, "no host op": 10e-6})
