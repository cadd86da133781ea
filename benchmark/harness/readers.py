"""What the metric readers (``benchmark/metrics/<metric>.py``) share. Each
takes the run's record (``runner.run_cell``) and returns a number, or None
where the run has nothing for it to read: a reader never stands in a 0."""

from __future__ import annotations

from typing import Optional


def rate(record: dict, kind: str) -> Optional[float]:
    """Units of a ``kind`` cell completed per second over the whole
    window, its closing synchronize included."""
    if record["kind"] != kind or record["window_s"] <= 0:
        return None
    return record["units"] / record["window_s"]


def mfu(record: dict, kind: str) -> Optional[float]:
    """The model FLOP of the window's completed work over its time and the
    precision's peak, in %."""
    if record["kind"] != kind or record["flop"] <= 0:
        return None
    return 100.0 * record["flop"] / record["window_s"] / record["peak_flops"]


def device_idle(record: dict, kind: str) -> Optional[float]:
    """The device's idle share of the profiled span, in %."""
    tr = record["trace"]
    if record["kind"] != kind or tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kxk_roofline(record: dict, kind: str) -> Optional[float]:
    """The least time of the attributed call's k x k conv work over the
    device time of the program's ``kxk.forward`` and ``kxk.grad_input``
    spans, in %."""
    tr = record["trace"]
    if record["kind"] != kind or tr is None:
        return None
    spans = [tr["spans"].get(s) for s in ("kxk.forward", "kxk.grad_input")]
    device_s = sum(s["device_s"] for s in spans if s is not None)
    bound_s = tr["bounds_s"].get("kxk", 0.0)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def span_ms(record: dict, kind: str, span: str, per: str) -> Optional[float]:
    """ms of device time in the program's span ``span`` of the attributed
    call, per entry into the span ``per`` ("engine.step" for a train step,
    "eval.batch" for an eval batch); None where either span is absent,
    ``per`` was never entered or ``span`` holds no device time."""
    tr = record["trace"]
    if record["kind"] != kind or tr is None:
        return None
    s, p = tr["spans"].get(span), tr["spans"].get(per)
    if s is None or p is None or p["count"] <= 0 or s["device_s"] <= 0:
        return None
    return 1e3 * s["device_s"] / p["count"]
