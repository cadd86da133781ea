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
    """The least time of the profiled span's k x k conv work over the
    device time of the kernels in the program's conv ranges, in %."""
    tr = record["trace"]
    if (record["kind"] != kind or tr is None
            or tr["span_kxk_device_s"] <= 0 or tr["span_kxk_bound_s"] <= 0):
        return None
    return 100.0 * tr["span_kxk_bound_s"] / tr["span_kxk_device_s"]
