"""Named spans at the port's boundaries, as ``torch.profiler`` ranges.

Off by default: :func:`span` then returns one shared no-op context, so a
span costs a flag test and enters no ``record_function`` (which costs
microseconds through the dispatcher even with no profiler running). On
(:func:`enable`, or :func:`enabled` for a block), a span is a
``record_function`` range: it lands in whatever profiler is running, on
the profiler's host clock, with the device-side range the profiler draws
around the kernels launched inside it, and nests under the span open on
its thread. Writing the spans out is the profiler's job.

The span names are the constants below; readers import them.
"""

from __future__ import annotations

import contextlib

from torch.profiler import record_function

TRAIN_EPOCH = "engine.train_epoch"
STEP = "engine.step"
STEP_GATHER = "step.gather"
STEP_FORWARD = "step.forward"
STEP_LOSS = "step.loss"
STEP_BACKWARD = "step.backward"
STEP_OPTIMIZER = "step.optimizer"
EVAL_EPOCH = "engine.eval_epoch"
EVAL_BATCH = "eval.batch"
EVAL_FORWARD = "eval.forward"
EVAL_LOSS = "eval.loss"
EVAL_DEPTH_SCATTER = "eval.depth_scatter"
KXK_FORWARD = "kxk.forward"
KXK_GRAD_INPUT = "kxk.grad_input"
KXK_GRAD_WEIGHT = "kxk.grad_weight"
GROUPED_GRAD_WEIGHT = "grouped.grad_weight"

_on = False
_OFF = contextlib.nullcontext()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


@contextlib.contextmanager
def enabled(on: bool = True):
    """Tracing set to ``on`` inside the block, restored after it."""
    global _on
    was, _on = _on, on
    try:
        yield
    finally:
        _on = was


def span(name: str, args=None):
    """A context for the span ``name``, with ``args`` (shown as text) in
    the profiler's record; the shared no-op context while tracing is
    off."""
    if not _on:
        return _OFF
    return record_function(name, None if args is None else str(args))
