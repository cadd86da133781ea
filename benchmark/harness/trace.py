"""Reading the ``torch.profiler`` traces of a traced run's two spans.

Recording every host op slows the host by tens of microseconds an op, and
a step that the host issues near the device's pace then idles the device
for the profiler's sake. So :func:`steady` reads a span profiled with
device activity alone (busy time, idle share, the device ops), and
:func:`attribution` a second span with the host's ops and the program's
own spans on (``consistent_depth_tpu_torch.utils.tracing``): for each span
name, its host count and the device time of the kernels inside its
device-side ranges, which the profiler draws from the first to the last
kernel launched while the span is innermost on its thread, so that a
kernel is attributed whatever launched it (the conv kernels go out through
ctypes, not through a torch op); and the idle gaps named by the innermost
host op running when each began. Both are ``chip_smoke.py::trace_summary``
split in two.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


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


def _merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def covered(busy: Sequence[Interval], ranges: Sequence[Interval]) -> float:
    """The length of ``busy`` (sorted disjoint intervals: the union of the
    kernels) inside the union of ``ranges``: a span's device time, each
    moment counted once however many of its ranges or kernels overlap."""
    starts = [s for s, _ in busy]
    total = 0.0
    for lo, hi in _merge(ranges):
        i = max(bisect_left(starts, lo) - 1, 0)
        while i < len(busy) and busy[i][0] < hi:
            total += max(0.0, min(busy[i][1], hi) - max(busy[i][0], lo))
            i += 1
    return total


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


def attribution(prof, window: str) -> Optional[Dict]:
    """From a span named ``window`` profiled with host and device activity
    and the program's spans on: ``spans``, {span name: {"device_s": the
    device seconds of the kernels in the union of its device-side ranges,
    "count": how often the host entered it}} for every named range but
    ``window``, and ``idle_gaps``, the idle seconds by the host op running
    at each gap's start. None when the trace holds no device activity in
    the span."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in cpu if e.name == window]
    labels = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    device = _kernels(events, labels | {window})
    kernels = sorted((e.time_range.start, e.time_range.end) for e in device)
    if not win or not kernels:
        return None
    lo, hi = win[0].time_range.start, win[0].time_range.end
    _, gaps = _union(kernels, lo, hi)
    busy = _merge(kernels)
    ranges = defaultdict(list)
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name in labels:
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    counts = Counter(e.name for e in cpu if e.name in labels)
    us = 1e-6
    spans = {name: {"device_s": covered(busy, ranges[name]) * us,
                    "count": counts[name]}
             for name in sorted(labels - {window})}
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
    return {"spans": spans,
            "idle_gaps": [[n, t * us] for n, t in idle.most_common(10)]}
