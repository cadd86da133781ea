"""The port's epoch engine against the JAX engine, on the synthetic scene of
tests/synthetic.py (4 frames at 16x32, five pairs) with the JAX seed-0
weights, prediction head scaled by 0.05 (as ``_tame`` in
tests/test_torch_train_step.py), crossed over by
``torch_import.state_dict_from_jax_variables``. f32 on both sides.

Bands:

- ``train_epoch``, Adam 4e-4, three steps: the step-0 loss within 1e-5
  relative (measured 1.4-2.4e-6; it is one train-mode forward and loss,
  whose band across the packages is tests/test_torch_train_step.py's 1e-5,
  where JAX's scan against its own steps agrees to 1e-6), step 1 within
  1e-2, every step within 8e-2, the final parameters within 5e-2
  relative L2 (the bands of tests/test_train_epoch.py, where JAX against
  itself spreads that far: train-mode BN at random init amplifies
  rounding); ``skipped_nan`` and ``step`` equal; the captured depth of
  step 0 within 1e-4 relative. The step-1 band is twice the largest gap
  that ``tools/torch_epoch_band_probe.py`` measured on a CPU host: JAX
  against itself under 1e-7 relative weight noise, ten seeds, 1.9e-3 to
  4.0e-3; the port against JAX at 1, 2 and 4 torch threads, 3.0e-3,
  4.1e-3 and 3.8e-3. Adam's first update moves every parameter by about
  lr times the sign of its gradient, so gradients near zero whose sign
  differs by rounding move by the whole lr, and the step-1 loss spreads
  that far whichever package runs it. The band catches, from the same
  probe, lr x 1.5 (gap 0.22) and Adam without its bias correction
  (0.75); it does not catch Adam's eps at 1e-6 (3.0e-3, inside the
  spread; the former 1e-3 band failed it and the unfaulted port alike).
  It holds at 1, 2 and 4 torch threads
  (``test_train_epoch_matches_jax_at_threads``);
- each eval pass (paired, deduplicated): per-pair losses and
  ``depth_frames`` within 1e-4 relative, ``frames_seen`` equal, the BN
  running stats after the pass within rtol = atol = 1e-4 (measured
  2.8e-5 after three batches; one batch agrees to 1e-5,
  tests/test_torch_train_step.py: JAX takes the variance as
  E[x^2] - E[x]^2, torch in two passes);
- ``infer`` on random BN running stats: within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import synthetic
from consistent_depth_tpu.models.mannequin_challenge import (
    MannequinChallengeModel as JaxMC)
from consistent_depth_tpu.ops.losses import LossWeights as JaxLossWeights
from consistent_depth_tpu.training import TrainingEngine as JaxEngine
from consistent_depth_tpu.training import create_optimizer as jax_optimizer
from consistent_depth_tpu_torch.models import torch_import
from consistent_depth_tpu_torch.models.mannequin_challenge import (
    MannequinChallengeModel)
from consistent_depth_tpu_torch.ops.losses import LossWeights
from consistent_depth_tpu_torch.training import (
    TrainingEngine, create_optimizer)

H, W = 16, 32
IDX = np.array([[0, 1], [2, 3], [4, 0]], np.int32)
VALID = np.ones((3, 2), np.float32)
CAPTURE = np.array([0, -1, 1], np.int32)
# eval batches of two pairs: the first repeats frame 1 ((0, 1), (1, 2)),
# the last is padded by repeating pair 4 with valid 0, as dispatch_eval does
EVAL_IDX = np.array([[0, 1], [2, 3], [4, 4]], np.int32)
EVAL_VALID = np.array([[1, 1], [1, 1], [1, 0]], np.float32)



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's small CPU runs. The suite runs
    files in parallel workers, and with torch's default of one thread per
    core beside another worker's XLA compile, the port's steps here ran
    ~50 times slower than alone (measured: 4 s -> 206 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def scene_data():
    scene = synthetic.make_scene(num_frames=4, H=H, W=W)
    return synthetic.build_pair_arrays(scene, synthetic.make_pairs(4))


@pytest.fixture(scope="module")
def jax_variables():
    variables = jax.tree_util.tree_map(
        np.asarray, JaxMC(checkpoint="", seed=0).variables)
    params = dict(variables["params"])
    params["pred_layer"] = {k: v * np.float32(0.05)
                            for k, v in params["pred_layer"].items()}
    return {**variables, "params": params}


def _port_engine(variables, eval_dedup=None, lr=4e-4):
    model = MannequinChallengeModel(checkpoint="", device="cpu")
    sd = torch_import.state_dict_from_jax_variables(variables)
    model.net.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}, strict=True)
    return TrainingEngine(model, create_optimizer("Adam", lr), LossWeights(),
                          eval_dedup=eval_dedup)


def _jax_engine(variables, eval_dedup=None):
    model = JaxMC(variables=jax.tree_util.tree_map(jnp.asarray, variables))
    return JaxEngine(model, jax_optimizer("Adam", 4e-4), JaxLossWeights(),
                     eval_dedup=eval_dedup)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _assert_stats_match(engine, jax_stats, tol):
    want = torch_import.state_dict_from_jax_variables(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, jax_stats)})
    sd = engine.model.net.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_epoch(jax_variables, scene_data):
    jeng = _jax_engine(jax_variables)
    jstate, jm = jeng.train_epoch(jeng.init_state(),
                                  jeng.put_data(scene_data), IDX, VALID,
                                  CAPTURE)
    params = torch_import.state_dict_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    return int(jstate.step), params, jax.tree_util.tree_map(np.asarray, jm)


def _check_train_epoch(jax_variables, scene_data, jax_epoch):
    j_step, want, jm = jax_epoch
    eng = _port_engine(jax_variables)
    m = eng.train_epoch(eng.put_data(scene_data), IDX, VALID, CAPTURE)

    j_loss = jm["loss"]
    loss = m["loss"].numpy()
    np.testing.assert_allclose(loss[0], j_loss[0], rtol=1e-5)
    np.testing.assert_allclose(loss[1], j_loss[1], rtol=1e-2)
    np.testing.assert_allclose(loss, j_loss, rtol=8e-2)
    np.testing.assert_array_equal(m["skipped_nan"].numpy(),
                                  jm["skipped_nan"])
    assert eng.step == j_step == 3
    assert m["reprojection"].shape == m["disparity"].shape == (3, 2)

    got = {k: p.detach().numpy() for k, p in eng.params.items()}
    assert got.keys() == want.keys()
    va = np.concatenate([np.ravel(got[k]) for k in sorted(want)])
    vb = np.concatenate([np.ravel(want[k]) for k in sorted(want)])
    assert np.linalg.norm(va - vb) / np.linalg.norm(vb) < 5e-2

    cap, j_cap = m["captured_depth"], jm["captured_depth"]
    assert cap.shape == j_cap.shape == (TrainingEngine.CAPTURE_SLOTS, 2, 2,
                                        H, W)
    assert cap.dtype == torch.float32
    assert _rel(cap[0].numpy(), j_cap[0]) < 1e-4
    # slot 1 holds step 2's depths, the other slots stay empty
    assert bool((cap[1] > 0).all()) and not bool(cap[2:].any())


def test_train_epoch_matches_jax(jax_variables, scene_data, jax_epoch):
    _check_train_epoch(jax_variables, scene_data, jax_epoch)


@pytest.mark.parametrize("threads", [1, 4])
def test_train_epoch_matches_jax_at_threads(jax_variables, scene_data,
                                            jax_epoch, threads):
    """The same bands at other torch thread counts, which move the port's
    step-1 gap (the module runs at 2)."""
    torch.set_num_threads(threads)
    try:
        _check_train_epoch(jax_variables, scene_data, jax_epoch)
    finally:
        torch.set_num_threads(2)


def _eval_case(jax_variables, scene_data, dedup, idx, valid):
    jeng = _jax_engine(jax_variables, eval_dedup=dedup)
    jstate, jm = jeng.eval_epoch(jeng.init_state(),
                                 jeng.put_data(scene_data), idx, valid)
    eng = _port_engine(jax_variables, eval_dedup=dedup)
    assert eng.eval_dedup == dedup
    before = {k: p.detach().clone() for k, p in eng.params.items()}
    m = eng.eval_epoch(eng.put_data(scene_data), idx, valid)
    assert set(m) == set(jm)
    for k in ("loss", "reprojection", "disparity", "depth_frames"):
        assert tuple(m[k].shape) == np.shape(jm[k]), k
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-4, atol=1e-30, err_msg=k)
    np.testing.assert_array_equal(m["pair_ids"].numpy(),
                                  np.asarray(jm["pair_ids"]))
    np.testing.assert_array_equal(m["frames_seen"].numpy(),
                                  np.asarray(jm["frames_seen"]))
    _assert_stats_match(eng, jstate.batch_stats, 1e-4)
    for k, p in eng.params.items():
        assert torch.equal(p.detach(), before[k]), k
    return m


def test_paired_eval_matches_jax(jax_variables, scene_data):
    m = _eval_case(jax_variables, scene_data, False, EVAL_IDX, EVAL_VALID)
    assert m["frames_seen"].all()


def test_dedup_eval_matches_jax(jax_variables, scene_data):
    """The deduplicated pass with frame 3 in no valid pair (pairs 2 = (2, 3)
    and 4 = (1, 3) masked): deviation (a), frame 3's row holds a real
    depth though it is not seen; deviation (b), the BN running stats moved
    by every resident frame and the chunk padding, are those of the JAX
    pass."""
    valid = EVAL_VALID.copy()
    valid[1, 0] = 0.0
    valid[2, 0] = 0.0
    m = _eval_case(jax_variables, scene_data, True, EVAL_IDX, valid)
    seen = m["frames_seen"].numpy()
    np.testing.assert_array_equal(seen, [True, True, True, False])
    assert bool((m["depth_frames"][3] > 0).all())


def test_paired_eval_first_valid_occurrence_wins(jax_variables, scene_data):
    """The indexed write keeps, for each frame, its first valid occurrence
    in pass order: a repeat in the same batch, a padding entry before a
    valid one, and a later batch all leave it as it is. Each position's
    depth is made distinct by a stand-in batch pass."""
    eng = _port_engine(jax_variables)
    data = eng.put_data(scene_data)
    calls = []

    def fake_batch(data_, idx, valid):
        s = len(calls)
        calls.append(s)
        # depth of (step s, pair b, side k) = 100 s + 10 b + k + 1
        code = (100 * s + 10 * torch.arange(idx.shape[0])[:, None]
                + torch.arange(2)[None, :] + 1).float()
        return {"loss": torch.zeros(()), "pair_ids": data_["pair_ids"][idx],
                "depth": code[..., None, None].expand(-1, -1, H, W),
                "reprojection": torch.zeros(idx.shape[0]),
                "disparity": torch.zeros(idx.shape[0])}

    eng._eval_batch = fake_batch
    # pairs: 0 = (0, 1), 1 = (1, 2), 2 = (2, 3), 3 = (0, 2), 4 = (1, 3)
    idx = np.array([[4, 1], [0, 3], [2, 2]], np.int32)
    valid = np.array([[0, 1], [1, 1], [1, 0]], np.float32)
    m = eng.eval_epoch(data, idx, valid)
    got = m["depth_frames"][:, 0, 0].numpy()
    # frame 1: pair 4 side 0 is padding, pair 1 side 0 (code 11) wins;
    # frame 2: pair 1 side 1 (12); frame 0: step 1 pair 0 side 0 (101);
    # frame 3: step 2 pair 0 side 1 (202), its padding repeat ignored
    np.testing.assert_array_equal(got, [101, 11, 12, 202])
    assert m["frames_seen"].all()


def test_infer_matches_jax(jax_variables):
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda v: rng.normal(0, 0.1, v.shape).astype(np.float32),
        jax_variables["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.abs(v) + 0.5).astype(np.float32)
        if p[-1].key == "var" else v, stats)
    variables = {**jax_variables, "batch_stats": stats}
    images = rng.random((3, 1, H, W, 3), dtype=np.float32)
    jeng = _jax_engine(variables)
    want = np.asarray(jeng.infer(jeng.init_state(), jnp.asarray(images)))
    eng = _port_engine(variables)
    got = eng.infer(images)
    assert tuple(got.shape) == want.shape == (3, 1, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    # eval mode leaves the running stats alone
    _assert_stats_match(eng, stats, 0)


def _state(eng):
    params = {k: p.detach().clone() for k, p in eng.params.items()}
    opt = {k: {n: v.clone() for n, v in s.items()}
           for k, s in eng.optimizer.state_dict()["state"].items()}
    return params, opt


def _assert_same_state(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert a[1].keys() == b[1].keys()
    for k, s in a[1].items():
        for n, v in s.items():
            assert torch.equal(v, b[1][k][n]), (k, n)


@pytest.mark.parametrize("fault", ["loss", "grad"])
def test_nan_skip_inside_an_epoch(jax_variables, scene_data, fault):
    """A non-finite loss (NaN flow in pair 4), or a finite loss with one
    non-finite gradient, at step 1 of an epoch: that step leaves the
    parameters and Adam's state bitwise as step 0 left them, only it is
    flagged, and step 2 applies as if step 1 had not been there (train-mode
    BN normalises by the batch, so the running stats step 1 moved do not
    enter step 2)."""
    steps = {"s0": [0, 1], "bad": [4, 4], "s2": [2, 3]}

    def run(names):
        eng = _port_engine(jax_variables)
        data = eng.put_data(scene_data)
        if fault == "loss":
            data["flows"] = data["flows"].clone()
            data["flows"][4] = float("nan")
        else:
            calls = []
            bad_call = names.index("bad") + 1 if "bad" in names else 0

            def hook(g):
                calls.append(1)
                return g * float("inf") * 0.0 if len(calls) == bad_call else g

            eng.params["pred_layer.bias"].register_hook(hook)
        idx = np.array([steps[n] for n in names], np.int32)
        m = eng.train_epoch(data, idx, np.ones(idx.shape, np.float32))
        return eng, m

    a, _ = run(["s0"])
    b, mb = run(["s0", "bad"])
    c, mc = run(["s0", "bad", "s2"])
    d, _ = run(["s0", "s2"])
    np.testing.assert_array_equal(mb["skipped_nan"].numpy(), [False, True])
    np.testing.assert_array_equal(mc["skipped_nan"].numpy(),
                                  [False, True, False])
    if fault == "grad":
        assert bool(torch.isfinite(mc["loss"]).all())
    _assert_same_state(_state(a), _state(b))
    assert int(b.optimizer.state_dict()["state"][0]["step"]) == 1
    _assert_same_state(_state(c), _state(d))
    assert c.step == 3 and d.step == 2
    assert not torch.equal(c.model.net.seq[1].running_mean,
                           d.model.net.seq[1].running_mean)
    assert not all(torch.equal(p, q) for p, q in zip(
        _state(a)[0].values(), _state(c)[0].values()))
