"""The port's train step on the monodepth2 and MiDaS v2 backbones against the
JAX engine's, on the CPU: the synthetic scene of tests/synthetic.py (four
frames, five pairs, a batch of four), the same seeded JAX weights carried
across, f32, one ``TrainingEngine.train_step``.

- monodepth2 at full width and depth on 32x48 frames through a 128x256
  feed (bicubic up, and back down for the disparity); MiDaS as the shallow
  net of tests/test_torch_backbones.py (one bottleneck per stage) on 64x96
  frames, its output bias raised by 5 (tests/test_engine_backbones.py's
  taming: a seeded MiDaS emits ReLU'd ~zero disparity, and depth =
  1/disparity then makes the loss NaN).
- Under Adam and under AdamW (optax's decay 1e-4) at lr 1e-2, a rate at
  which AdamW's decay of a parameter with a zero gradient, p * (1 - lr *
  wd), is visible in f32: loss rtol 1e-5, per-pair losses rtol 1e-4, BN
  running stats rtol = atol = 1e-5; the gradients (the port's ``.grad``
  against ``jax.grad`` of the JAX engine's train-mode loss) within a
  relative L2 of 1e-2 over all parameters, measured 4.1e-3 (monodepth2)
  and 2.2e-3 (MiDaS). Train-mode BN divides by the batch sigma at every
  layer, which amplifies rounding (tests/test_torch_train_step.py): the
  port's f32 gradients differ from its own f64 ones by 2.7e-3 and
  1.3e-3, the JAX ones from the port's f64 by 4.3e-3 and 1.7e-3. At a
  64x128 feed monodepth2's deepest BN sees 2x4 pixels and the port's f32
  gradients are 1.0e-2 from its own f64 ones, so the feed is 128x256.
- The update (old minus new parameters): Adam's first step is lr g /
  (|g| + eps), a sign wherever |g| >> eps, so an element whose gradient
  sits at rounding level may flip; the JAX step's own gradient flips some
  against ``jax.grad`` of the same loss compiled apart. At most 1% of the
  elements may differ by more than 1e-3 lr; measured 0.34% (monodepth2)
  and 0.033% (MiDaS).
- Parameters outside the loss: MiDaS's ``scratch.refinenet4.resConfUnit1``,
  never called, and monodepth2's disparity heads of scales 1-3, computed
  and not read. JAX gives them an exact zero gradient; the port's engine
  does the same, so they stay exactly as they were under Adam and are
  decayed, as optax decays them, under AdamW (a ``None`` gradient would
  have left them unchanged there): within 3e-7 relative of the JAX
  values, where the decay moves them by 1e-6.
- The NaN-skip at the untamed MiDaS init: the JAX loss is not finite
  either; the port's step is skipped and leaves the parameters and
  Adam's state bitwise unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import synthetic
from consistent_depth_tpu.models import monodepth2 as jax_monodepth2
from consistent_depth_tpu.ops.losses import LossWeights as JaxLossWeights
from consistent_depth_tpu.training import TrainingEngine as JaxEngine
from consistent_depth_tpu.training import create_optimizer as jax_optimizer
from consistent_depth_tpu.training.engine import gather_batch as jax_gather
from consistent_depth_tpu_torch.models import monodepth2, torch_import
from consistent_depth_tpu_torch.ops.losses import LossWeights
from consistent_depth_tpu_torch.training import (
    TrainingEngine, create_optimizer)
from test_torch_backbones import (
    FEED, JaxShallowMidas, ShallowMidas, load_port, numpy_variables,
    randomize_batch_stats, tame_midas)

IDX = np.array([0, 1, 2, 3], np.int32)
VALID = np.ones(4, np.float32)
LR = 1e-2
# the parameters outside the loss: MiDaS's refinenet4.resConfUnit1, never
# called, and monodepth2's disparity heads of scales 1-3, which the
# adapter computes and does not read
UNUSED = {"midas2": ("scratch.refinenet4.resConfUnit1.",),
          "monodepth2": ("decoder.11.", "decoder.12.", "decoder.13.")}
TOL_GRADS = 1e-2
TOL_FLIPPED = 1e-2


def _scene(H, W):
    scene = synthetic.make_scene(num_frames=4, H=H, W=W)
    return synthetic.build_pair_arrays(scene, synthetic.make_pairs(4))


@pytest.fixture(scope="module")
def backbones():
    """Per backbone: the JAX adapter at its (tamed) seeded weights with
    random BN stats, a maker of the port adapter on those weights, the
    scene, and the JAX train-mode loss and gradients at those weights."""
    out = {}
    jmd = jax_monodepth2.Monodepth2Model(checkpoint="", seed=0,
                                         feed_size=FEED)
    jmd.variables = randomize_batch_stats(numpy_variables(jmd.variables))
    out["monodepth2"] = (jmd, lambda: monodepth2.Monodepth2Model(
        checkpoint="", device="cpu", feed_size=FEED), _scene(32, 48))
    jmi = JaxShallowMidas(checkpoint="", seed=0)
    untamed = randomize_batch_stats(numpy_variables(jmi.variables))
    jmi.variables = tame_midas(untamed)
    out["midas2"] = (jmi, lambda: ShallowMidas(checkpoint="", device="cpu"),
                     _scene(64, 96))
    result = {}
    for name, (jmodel, make_port, data) in out.items():
        jeng = JaxEngine(jmodel, jax_optimizer("SGD", LR), JaxLossWeights(
            lambda_view_baseline=jmodel.lambda_view_baseline))
        state = jeng.init_state()
        batch = jax_gather(jeng.put_data(data), jnp.asarray(IDX))

        def loss_fn(params, stats=state.batch_stats):
            return jeng._loss(params, stats, batch, jnp.asarray(VALID),
                              True)[0]

        grad = jax.jit(jax.value_and_grad(loss_fn))
        loss, grads = grad(state.params)
        entry = {"jax": jmodel, "port": make_port, "data": data,
                 "loss": float(loss),
                 "grads": torch_import.released_midas_keys(
                     torch_import.state_dict_from_jax_variables(
                         {"params": numpy_variables(grads)}))}
        if name == "midas2":
            entry["untamed"] = untamed
            entry["untamed_loss"] = float(grad(jax.tree_util.tree_map(
                jnp.asarray, untamed["params"]))[0])
        result[name] = entry
    return result


def _rel(a, b):
    va = np.concatenate([np.ravel(a[k]) for k in sorted(b)])
    vb = np.concatenate([np.ravel(b[k]) for k in sorted(b)])
    return float(np.linalg.norm(va - vb) / np.linalg.norm(vb))


def _flipped(update, want):
    """The share of elements whose updates differ by more than 1e-3 lr."""
    diff = np.concatenate([np.ravel(update[k] - want[k])
                           for k in sorted(want)])
    return float(np.mean(np.abs(diff) > 1e-3 * LR))


def _port_engine(entry, variables, optimizer):
    model = load_port(entry["port"](), variables)
    return TrainingEngine(model, create_optimizer(optimizer, LR), LossWeights(
        lambda_view_baseline=model.lambda_view_baseline))


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
@pytest.mark.parametrize("backbone", ["monodepth2", "midas2"])
def test_train_step_matches_jax(backbones, backbone, optimizer):
    entry = backbones[backbone]
    jmodel = entry["jax"]
    jeng = JaxEngine(jmodel, jax_optimizer(optimizer, LR), JaxLossWeights(
        lambda_view_baseline=jmodel.lambda_view_baseline))
    state = jeng.init_state()
    p_before = numpy_variables(state.params)
    new_state, metrics = jeng.train_step(state, jeng.put_data(entry["data"]),
                                         IDX, VALID)
    np.testing.assert_allclose(float(metrics["loss"]), entry["loss"],
                               rtol=1e-6)
    sd = torch_import.state_dict_from_jax_variables
    want_update = torch_import.released_midas_keys(sd({"params": (
        jax.tree_util.tree_map(lambda a, b: a - np.asarray(b), p_before,
                               new_state.params))}))

    eng = _port_engine(entry, jmodel.variables, optimizer)
    before = {k: p.detach().clone() for k, p in eng.params.items()}
    out = eng.train_step(eng.put_data(entry["data"]), IDX, VALID)
    assert not bool(out["skipped_nan"]) and eng.step == 1
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    for k in ("reprojection", "disparity"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(metrics[k]),
                                   rtol=1e-4, err_msg=k)
    grads = {k: p.grad.numpy() for k, p in eng.params.items()}
    assert grads.keys() == entry["grads"].keys()
    assert _rel(grads, entry["grads"]) <= TOL_GRADS, _rel(
        grads, entry["grads"])
    update = {k: (before[k] - p.detach()).numpy()
              for k, p in eng.params.items()}
    flips = _flipped(update, want_update)
    assert flips <= TOL_FLIPPED, flips
    stats = torch_import.released_midas_keys(sd(
        {"batch_stats": numpy_variables(new_state.batch_stats)}))
    net_sd = eng.model.net.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(net_sd[k].numpy(), v, rtol=1e-5,
                                   atol=1e-5, err_msg=k)

    # the parameters outside the loss: an exact zero gradient in both
    # packages; unchanged under Adam, decayed as optax decays them under
    # AdamW
    unused = sorted(k for k in eng.params if k.startswith(UNUSED[backbone]))
    assert unused == sorted(k for k, g in entry["grads"].items()
                            if not g.any())
    assert len(unused) == {"midas2": 4, "monodepth2": 6}[backbone]
    new_params = torch_import.released_midas_keys(
        sd({"params": numpy_variables(new_state.params)}))
    for k in unused:
        assert not grads[k].any() and not entry["grads"][k].any(), k
        got, old = eng.params[k].detach(), before[k]
        np.testing.assert_allclose(got.numpy(), new_params[k], rtol=3e-7,
                                   atol=0, err_msg=k)
        if optimizer == "Adam":
            assert torch.equal(got, old), k
        else:
            # the biases are 0 at the seeded init, so decay leaves them so
            assert k.endswith("bias") or not torch.equal(got, old), k
            # lr * wd = 1e-6 of each value; the two packages round
            # p (1 - lr wd) and p - lr (wd p) to within 3e-7
            np.testing.assert_allclose(
                got.numpy(), old.numpy() * (1 - LR * 1e-4), rtol=3e-7,
                err_msg=k)


def test_midas_nan_skip_is_bitwise(backbones):
    entry = backbones["midas2"]
    assert not np.isfinite(entry["untamed_loss"])
    eng = _port_engine(entry, entry["untamed"], "Adam")
    data = eng.put_data(entry["data"])
    # Adam's moments and step count exist after a first, productive step
    # at the tamed weights
    tame = load_port(entry["port"](), entry["jax"].variables).net
    with torch.no_grad():
        eng.model.net.scratch.output_conv[4].bias.copy_(
            tame.scratch.output_conv[4].bias)
    assert not bool(eng.train_step(data, IDX, VALID)["skipped_nan"])
    with torch.no_grad():
        eng.model.net.scratch.output_conv[4].bias.sub_(5.0)
    params = {k: p.detach().clone() for k, p in eng.params.items()}
    opt = {k: {n: v.clone() for n, v in s.items()}
           for k, s in eng.optimizer.state_dict()["state"].items()}
    out = eng.train_step(data, IDX, VALID)
    assert not bool(torch.isfinite(out["loss"]))
    assert bool(out["skipped_nan"]) and eng.step == 2
    for k, p in eng.params.items():
        assert torch.equal(p.detach(), params[k]), k
    state = eng.optimizer.state_dict()["state"]
    assert state.keys() == opt.keys()
    for k, s in state.items():
        for n, v in s.items():
            assert torch.equal(v, opt[k][n]), (k, n)
    assert int(state[0]["step"]) == 1
