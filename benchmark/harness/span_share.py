"""A class of work's share of its roofline in the traced call, read from the
program's spans: the least time of the class's work (``bounds_s``) over the
device time of the spans that run it. For the classes whose spans
``readers.kxk_roofline`` does not read: ``"linear"`` (``linear.forward``,
``linear.backward``) and ``"attention"`` (``attention.forward``,
``attention.backward``), the transformer's spans
(``consistent_depth_tpu_torch/ops/transformer.py``)."""

from __future__ import annotations

from typing import Optional

SPANS = {"linear": ("linear.forward", "linear.backward"),
         "attention": ("attention.forward", "attention.backward")}


def roofline(record: dict, kind: str, work: str) -> Optional[float]:
    """``bounds_s[work]`` over the device time of ``SPANS[work]`` in the
    attributed call, in %; None without a trace, the spans or the bound."""
    tr = record["trace"]
    if record["kind"] != kind or tr is None:
        return None
    spans = [tr["spans"].get(s) for s in SPANS[work]]
    device_s = sum(s["device_s"] for s in spans if s is not None)
    bound_s = tr["bounds_s"].get(work, 0.0)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
