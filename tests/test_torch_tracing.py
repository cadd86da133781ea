"""The port's spans (``consistent_depth_tpu_torch/utils/tracing.py``) on
the CPU, on the synthetic scene of tests/synthetic.py (4 frames at 16x32,
five pairs) with a seeded ``mc``, prediction head scaled by 0.05, as
tests/test_torch_epoch.py builds it: a 2-step ``train_epoch``, a paired and
a deduplicated ``eval_epoch`` of three batches.

- Tracing off (the default), the passes enter no ``record_function`` of
  the program.
- Tracing on, under ``torch.profiler``, every span appears as often as the
  pass runs its part and inside its parent on the main thread (on the CPU
  the backward runs there too), and the outputs, parameters, batch-norm
  statistics and optimizer state are bitwise those of the run with tracing
  off.
- On a shallow MiDaS v2 (one bottleneck per stage) at 32x64, a 2-step
  ``train_epoch``: ``grouped.grad_weight`` appears, inside
  ``step.backward``, as often as ``grouped_conv.launch_count()`` counts,
  once per step for each of its 4 grouped convs, and not at all with
  tracing off.
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import synthetic
from consistent_depth_tpu_torch.models import layers, midas_v2
from consistent_depth_tpu_torch.models.mannequin_challenge import (
    MannequinChallengeModel)
from consistent_depth_tpu_torch.ops import grouped_conv
from consistent_depth_tpu_torch.ops.losses import LossWeights
from consistent_depth_tpu_torch.training import (
    TrainingEngine, create_optimizer)
from consistent_depth_tpu_torch.utils import tracing

H, W = 16, 32
IDX = np.array([[0, 1], [2, 3]], np.int32)
VALID = np.ones((2, 2), np.float32)
EVAL_IDX = np.array([[0, 1], [2, 3], [4, 4]], np.int32)
EVAL_VALID = np.array([[1, 1], [1, 1], [1, 0]], np.float32)
# mc's k x k conv calls per forward: 68 (tests/test_torch_s2d_conv.py::
# test_same_conv2d_routing; the two heads run as one conv), each with a
# grad-weight, and a grad-input but for the stem's, whose input is the
# images
KXK_CALLS = 68
CASES = ("train", "eval_paired", "eval_dedup")
SPANS = {v for k, v in vars(tracing).items()
         if k.isupper() and not k.startswith("_")}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads, as tests/test_torch_epoch.py runs its passes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_data():
    scene = synthetic.make_scene(num_frames=4, H=H, W=W)
    return synthetic.build_pair_arrays(scene, synthetic.make_pairs(4))


@pytest.fixture(scope="module")
def tamed_state():
    model = MannequinChallengeModel(checkpoint="", device="cpu")
    state = copy.deepcopy(model.net.state_dict())
    for name, t in state.items():
        if name.startswith("pred_layer."):
            t.mul_(0.05)
    return state


def _engine(state, case):
    model = MannequinChallengeModel(checkpoint="", device="cpu")
    model.net.load_state_dict(state, strict=True)
    return TrainingEngine(model, create_optimizer("Adam", 4e-4),
                          LossWeights(), eval_dedup=case == "eval_dedup")


def _run(engine, data, case):
    if case == "train":
        return engine.train_epoch(data, IDX, VALID)
    return engine.eval_epoch(data, EVAL_IDX, EVAL_VALID)


def _spans(prof):
    """The program's spans of a profile: (name, start, end, thread)."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name in SPANS]


def _inside(spans, child, parent):
    """Whether each ``child`` span lies inside a ``parent`` span of its
    thread."""
    parents = [s for s in spans if s[0] == parent]
    return all(any(p[1] <= c[1] and c[2] <= p[2] and p[3] == c[3]
                   for p in parents)
               for c in spans if c[0] == child)


def _raise(*args, **kwargs):
    raise AssertionError("a span entered record_function with tracing off")


def test_span_helper():
    assert not tracing._on
    off = tracing.span(tracing.STEP, 3)
    assert off is tracing.span(tracing.KXK_FORWARD)
    with tracing.enabled():
        assert isinstance(tracing.span(tracing.STEP, 3), record_function)
        with pytest.raises(RuntimeError), tracing.enabled(False):
            assert tracing.span(tracing.STEP) is off
            raise RuntimeError
        assert tracing._on
    assert not tracing._on
    tracing.enable()
    try:
        assert tracing._on
    finally:
        tracing.disable()
    assert not tracing._on


@pytest.mark.parametrize("case", CASES)
def test_tracing_off_enters_no_record_function(scene_data, tamed_state,
                                               case, monkeypatch):
    monkeypatch.setattr(tracing, "record_function", _raise)
    engine = _engine(tamed_state, case)
    out = _run(engine, engine.put_data(scene_data), case)
    assert torch.isfinite(out["loss"]).all()


@pytest.mark.parametrize("case", CASES)
def test_tracing_on_nests_and_leaves_outputs(scene_data, tamed_state, case):
    plain = _engine(tamed_state, case)
    want = _run(plain, plain.put_data(scene_data), case)
    traced = _engine(tamed_state, case)
    data = traced.put_data(scene_data)
    with tracing.enabled(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        got = _run(traced, data, case)
    assert not tracing._on

    spans = _spans(prof)
    counts = {n: sum(s[0] == n for s in spans) for n in SPANS}
    steps, batches = len(IDX), len(EVAL_IDX)
    if case == "train":
        want_counts = {
            tracing.TRAIN_EPOCH: 1, tracing.STEP: steps,
            tracing.STEP_GATHER: steps, tracing.STEP_FORWARD: steps,
            tracing.STEP_LOSS: steps, tracing.STEP_BACKWARD: steps,
            tracing.STEP_OPTIMIZER: steps,
            tracing.KXK_FORWARD: steps * KXK_CALLS,
            tracing.KXK_GRAD_INPUT: steps * (KXK_CALLS - 1),
            tracing.KXK_GRAD_WEIGHT: steps * KXK_CALLS}
        nesting = [(tracing.STEP, tracing.TRAIN_EPOCH),
                   (tracing.STEP_GATHER, tracing.STEP),
                   (tracing.STEP_FORWARD, tracing.STEP),
                   (tracing.STEP_LOSS, tracing.STEP),
                   (tracing.STEP_BACKWARD, tracing.STEP),
                   (tracing.STEP_OPTIMIZER, tracing.STEP),
                   (tracing.KXK_FORWARD, tracing.STEP_FORWARD),
                   (tracing.KXK_GRAD_INPUT, tracing.STEP_BACKWARD),
                   (tracing.KXK_GRAD_WEIGHT, tracing.STEP_BACKWARD)]
    elif case == "eval_paired":
        want_counts = {
            tracing.EVAL_EPOCH: 1, tracing.EVAL_BATCH: batches,
            tracing.EVAL_FORWARD: batches, tracing.EVAL_LOSS: batches,
            tracing.EVAL_DEPTH_SCATTER: batches,
            tracing.KXK_FORWARD: batches * KXK_CALLS}
        nesting = [(tracing.EVAL_BATCH, tracing.EVAL_EPOCH),
                   (tracing.EVAL_FORWARD, tracing.EVAL_BATCH),
                   (tracing.EVAL_LOSS, tracing.EVAL_BATCH),
                   (tracing.EVAL_DEPTH_SCATTER, tracing.EVAL_BATCH),
                   (tracing.KXK_FORWARD, tracing.EVAL_FORWARD)]
    else:
        # phase 1 forwards the 4 frames as one chunk of two pairs' shape,
        # phase 2 joins each pair batch against the depths
        want_counts = {
            tracing.EVAL_EPOCH: 1, tracing.EVAL_BATCH: batches,
            tracing.EVAL_FORWARD: 1, tracing.EVAL_LOSS: batches,
            tracing.KXK_FORWARD: KXK_CALLS}
        nesting = [(tracing.EVAL_BATCH, tracing.EVAL_EPOCH),
                   (tracing.EVAL_FORWARD, tracing.EVAL_EPOCH),
                   (tracing.EVAL_LOSS, tracing.EVAL_BATCH),
                   (tracing.KXK_FORWARD, tracing.EVAL_FORWARD)]
    assert counts == {n: want_counts.get(n, 0) for n in SPANS}
    for child, parent in nesting:
        assert _inside(spans, child, parent), (child, parent)
    main = {s[3] for s in spans if s[0] in (tracing.TRAIN_EPOCH,
                                            tracing.EVAL_EPOCH)}
    assert len(main) == 1 and {s[3] for s in spans} == main

    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in plain.model.net.state_dict().items():
        assert torch.equal(traced.model.net.state_dict()[k], v), k
    assert traced.step == plain.step
    opt, opt_want = (e.optimizer.state_dict()["state"]
                     for e in (traced, plain))
    assert opt.keys() == opt_want.keys()
    for i in opt_want:
        for k in opt_want[i]:
            assert torch.equal(opt[i][k], opt_want[i][k]), (i, k)


class _ShallowMidas(midas_v2.MidasV2Model):
    def _make_module(self):
        return midas_v2.MidasNet(blocks=(1, 1, 1, 1))


def test_grouped_grad_weight_span_and_count(monkeypatch):
    scene = synthetic.make_scene(num_frames=4, H=32, W=64)
    data = synthetic.build_pair_arrays(scene, synthetic.make_pairs(4))
    model = _ShallowMidas(checkpoint="", device="cpu")
    grouped = sum(m.grouped for m in model.net.modules()
                  if isinstance(m, layers.SameConv2d))
    assert grouped == 4
    engine = TrainingEngine(
        model, create_optimizer("Adam", model.learning_rate),
        LossWeights(lambda_view_baseline=model.lambda_view_baseline))
    resident = engine.put_data(data)

    grouped_conv.reset_counts()
    with monkeypatch.context() as m:
        m.setattr(tracing, "record_function", _raise)
        engine.train_epoch(resident, IDX, VALID)
    assert grouped_conv.launch_count() == grouped * len(IDX)

    grouped_conv.reset_counts()
    with tracing.enabled(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        engine.train_epoch(resident, IDX, VALID)
    spans = _spans(prof)
    n = sum(s[0] == tracing.GROUPED_GRAD_WEIGHT for s in spans)
    assert n == grouped_conv.launch_count() == grouped * len(IDX)
    assert grouped_conv.route_counts["kernel"] == 0
    assert _inside(spans, tracing.GROUPED_GRAD_WEIGHT, tracing.STEP_BACKWARD)
    assert sum(s[0] == tracing.KXK_GRAD_WEIGHT for s in spans) > 0
