"""Reading the ``torch.profiler`` traces of a traced run's two spans.

Recording every host op slows the host by tens of microseconds an op, and
a step that the host issues near the device's pace then idles the device
for the profiler's sake. So :func:`steady` reads a span profiled with
device activity alone (busy time, idle share, the device ops), and
:func:`attribution` a second span with the host's ops too: the device time
of the kernels inside each named range, placed by the device-side spans the
profiler draws for the range, so that a kernel is attributed whatever
launched it (the conv kernels go out through ctypes, not through a torch
op), and the idle gaps named by the innermost host op running when each
began. Both are ``chip_smoke.py::trace_summary`` split in two.

:func:`conv_ranges` names the program's k x k conv entry points for the
span only; a program without them leaves the ranges empty.
"""

from __future__ import annotations

import contextlib
from bisect import bisect_left, bisect_right
from collections import Counter
from typing import Dict, Iterable, Optional

FORWARD_RANGE = "bench.kxk_forward"
GRAD_INPUT_RANGE = "bench.kxk_grad_input"


@contextlib.contextmanager
def conv_ranges():
    """Inside the block the port's k x k conv forward and grad-input run
    in ranges named FORWARD_RANGE and GRAD_INPUT_RANGE."""
    from torch.profiler import record_function

    from consistent_depth_tpu_torch.ops import s2d_conv

    names = (("_forward", FORWARD_RANGE),
             ("same_conv_grad_input", GRAD_INPUT_RANGE))
    saved = {a: getattr(s2d_conv, a) for a, _ in names
             if hasattr(s2d_conv, a)}

    def named(label, fn):
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    try:
        for attr, label in names:
            if attr in saved:
                setattr(s2d_conv, attr, named(label, saved[attr]))
        yield
    finally:
        for attr, fn in saved.items():
            setattr(s2d_conv, attr, fn)


def _union(intervals, lo, hi):
    """Busy length and idle gaps [(start, end)] of sorted intervals clipped
    to [lo, hi]."""
    busy, gaps, cur_s, cur_e = 0.0, [], None, lo
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    return busy, gaps


def _kernels(events, exclude=()):
    """The device activity of ``events``: kernels, copies and sets, not the
    device-side spans the profiler draws for the named ranges."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in exclude
            and not e.name.startswith("Optimizer.")]


def steady(prof) -> Optional[Dict]:
    """From a span profiled with device activity alone (the host runs at
    its own pace): its length from the first kernel's start to the last
    one's end, the device's busy time in it (the union of the kernels'
    intervals) and the ten device ops that took most time, in s. None
    without device activity."""
    device = _kernels(prof.events())
    if not device:
        return None
    kernels = sorted((e.time_range.start, e.time_range.end) for e in device)
    lo, hi = kernels[0][0], max(e for _, e in kernels)
    busy, _ = _union(kernels, lo, hi)
    by_name = Counter()
    for e in device:
        by_name[e.name] += e.time_range.end - e.time_range.start
    us = 1e-6
    return {"window_s": (hi - lo) * us, "busy_s": busy * us,
            "device_ops": [[n, t * us] for n, t in by_name.most_common(10)]}


def attribution(prof, window: str, ranges: Iterable[str]) -> Optional[Dict]:
    """From a span named ``window`` profiled with host and device activity:
    the device seconds of the kernels inside each named range of
    ``ranges``, and the idle seconds by the host op running at each gap's
    start. None when the trace holds no device activity in the span."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in cpu if e.name == window]
    labels = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device = _kernels(events, labels | {window})
    kernels = sorted((e.time_range.start, e.time_range.end) for e in device)
    if not win or not kernels:
        return None
    lo, hi = win[0].time_range.start, win[0].time_range.end
    _, gaps = _union(kernels, lo, hi)
    starts = [s for s, _ in kernels]
    in_ranges = dict.fromkeys(ranges, 0.0)
    for e in on_device:
        if e.name not in in_ranges:
            continue
        lo_r, hi_r = e.time_range.start, e.time_range.end
        i = max(bisect_left(starts, lo_r) - 1, 0)
        while i < len(kernels) and kernels[i][0] < hi_r:
            in_ranges[e.name] += max(
                0.0, min(kernels[i][1], hi_r) - max(kernels[i][0], lo_r))
            i += 1
    # the idle gaps by the innermost host op covering each gap's start:
    # of the ops that began before it, the latest that is still running
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if e.name != window), key=lambda t: t[0])
    host_starts = [h[0] for h in host]
    idle = Counter()
    for g0, g1 in gaps:
        name = "no host op"
        j = bisect_right(host_starts, g0) - 1
        for s, e, n in reversed(host[max(0, j - 4000):j + 1]):
            if e > g0:
                name = n
                break
        idle[name] += g1 - g0
    us = 1e-6
    return {"ranges_s": {k: v * us for k, v in in_ranges.items()},
            "idle_gaps": [[n, t * us] for n, t in idle.most_common(10)]}
