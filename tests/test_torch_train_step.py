"""The port's train step against the JAX package's, on the synthetic
scene of tests/synthetic.py (32x48, five pairs) with the JAX seed-0
weights crossed by ``torch_import.state_dict_from_jax_variables``
(gradients map by the same keys).

Tolerances, f32:

- train-mode forward: rtol = atol = 1e-4 on log-depth and confidence (the
  hourglass band of tests/test_hourglass.py), BN running stats rtol =
  atol = 1e-5;
- parameter gradients with eval-mode BN: relative L2 over all parameters
  <= 1e-5 (tests/test_engine.py's bound for a like case), every tensor
  within rtol = 1e-3 of its own norm;
- one train-mode SGD(1.0) step from the tame init (the prediction head
  scaled by 0.05, as tests/test_bf16.py does): loss rtol = 1e-5, per-pair
  losses rtol = 1e-4, BN running stats rtol = atol = 1e-5; the gradients
  (old minus new parameters) within a relative L2 of 1e-2, measured
  4.5e-3. Train-mode BN divides by the batch sigma at each of ~70 layers,
  which at random init amplifies rounding differences, as
  tests/test_engine.py explains: the port's own f32 gradients differ from
  its f64 gradients by 2.4e-3 here (1.0e-2 without the tame head);
- the optimizers against optax over 5 steps: rtol = atol = 1e-6.
"""

import numpy as np
import optax
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
from consistent_depth_tpu.training.engine import gather_batch as jax_gather
from consistent_depth_tpu_torch.models import torch_import
from consistent_depth_tpu_torch.models.mannequin_challenge import (
    MannequinChallengeModel)
from consistent_depth_tpu_torch.ops.losses import LossWeights
from consistent_depth_tpu_torch.training import (
    TrainingEngine, create_optimizer, gather_batch)

IDX = np.array([0, 1, 2, 3], np.int32)
VALID = np.ones(4, np.float32)


@pytest.fixture(scope="module")
def scene_data():
    scene = synthetic.make_scene(num_frames=6, H=32, W=48)
    return synthetic.build_pair_arrays(scene, synthetic.make_pairs(6))


@pytest.fixture(scope="module")
def jax_variables():
    return jax.tree_util.tree_map(
        np.asarray, JaxMC(checkpoint="", seed=0).variables)


def _random_stats(variables, seed=0):
    """Copy of ``variables`` with random BN running stats, so that a fault
    in how eval mode uses them cannot hide behind the init values."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else (
            rng.normal(0, 0.1, v.shape) if k == "mean"
            else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in tree.items()}

    return {**variables, "batch_stats": fill(variables["batch_stats"])}


def _port_model(variables):
    model = MannequinChallengeModel(checkpoint="", device="cpu")
    sd = torch_import.state_dict_from_jax_variables(variables)
    model.net.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}, strict=True)
    return model


def _jax_engine(variables, opt="SGD", lr=1.0):
    model = JaxMC(variables=jax.tree_util.tree_map(jnp.asarray, variables))
    return JaxEngine(model, jax_optimizer(opt, lr), JaxLossWeights())


def _as_torch_layout(tree):
    return torch_import.state_dict_from_jax_variables({"params": tree})


def _rel(a, b):
    va = np.concatenate([np.ravel(a[k]) for k in sorted(b)])
    vb = np.concatenate([np.ravel(b[k]) for k in sorted(b)])
    return float(np.linalg.norm(va - vb) / np.linalg.norm(vb))


def test_train_forward_and_bn_stats_match_jax(jax_variables):
    jmodel = JaxMC(variables=jax_variables)
    x = np.random.default_rng(0).random((4, 32, 48, 3), dtype=np.float32)
    (j_pred, j_conf), mutated = jax.jit(
        lambda v, x_: jmodel.module.apply(
            v, x_, train=True, mutable=["batch_stats"]))(
        jax.tree_util.tree_map(jnp.asarray, jax_variables), jnp.asarray(x))
    model = _port_model(jax_variables)
    net = model.net.train()
    with torch.no_grad():
        t_pred, t_conf = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(t_pred[:, 0].numpy(),
                               np.asarray(j_pred)[..., 0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t_conf[:, 0].numpy(),
                               np.asarray(j_conf)[..., 0], rtol=1e-4,
                               atol=1e-4)
    want = torch_import.state_dict_from_jax_variables(
        {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                               mutated["batch_stats"])})
    got = net.state_dict()
    assert len(want) == 2 * (1 + 22 * 7)  # every BN's mean and var
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # apply(train=True) is the same forward on (B, N, H, W, 3) images
    model2 = _port_model(jax_variables)
    with torch.no_grad():
        depth = model2.apply(torch.from_numpy(x).reshape(2, 2, 32, 48, 3),
                             train=True)
    np.testing.assert_allclose(depth.reshape(4, 32, 48).numpy(),
                               np.exp(t_pred[:, 0].numpy()), rtol=1e-5)
    torch.testing.assert_close(model2.net.seq[1].running_var,
                               net.seq[1].running_var, rtol=0, atol=0)


def test_eval_mode_gradients_match_jax(jax_variables, scene_data):
    variables = _random_stats(jax_variables)
    jeng = _jax_engine(variables)
    state = jeng.init_state()
    dev = jeng.put_data(scene_data)

    def loss_fn(params):
        batch = jax_gather(dev, jnp.asarray(IDX))
        loss, _ = jeng._loss(params, state.batch_stats, batch,
                             jnp.asarray(VALID), False)
        return loss

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    want = _as_torch_layout(jax.tree_util.tree_map(np.asarray, j_grads))

    eng = TrainingEngine(_port_model(variables), create_optimizer("SGD", 1.0),
                         LossWeights())
    data = eng.put_data(scene_data)
    idx, valid = eng._indices(IDX, VALID)
    loss, _, _ = eng._loss(gather_batch(data, idx), valid, train=False)
    loss.backward()
    got = {k: p.grad.numpy() for k, p in eng.params.items()}
    assert got.keys() == want.keys()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert _rel(got, want) <= 1e-5, _rel(got, want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 1e-3 * np.linalg.norm(want[k]) + 1e-12, k


def _tame(variables):
    """The prediction head scaled by 0.05 (tests/test_bf16.py): a random
    init emits extreme log-depths, and exp() then turns 1e-5 differences
    in them into percent-level depth differences, where a pretrained net
    predicts O(1) depths."""
    params = dict(variables["params"])
    params["pred_layer"] = {k: v * np.float32(0.05)
                            for k, v in params["pred_layer"].items()}
    return {**variables, "params": params}


def test_train_step_sgd_matches_jax(jax_variables, scene_data):
    jax_variables = _tame(jax_variables)
    jeng = _jax_engine(jax_variables)
    state = jeng.init_state()
    p_before = jax.tree_util.tree_map(np.asarray, state.params)
    # the JAX step donates its state
    new_state, metrics = jeng.train_step(
        state, jeng.put_data(scene_data), IDX, VALID)
    j_grads = jax.tree_util.tree_map(
        lambda a, b: a - np.asarray(b), p_before, new_state.params)
    want = _as_torch_layout(j_grads)

    eng = TrainingEngine(_port_model(jax_variables),
                         create_optimizer("SGD", 1.0), LossWeights())
    before = {k: p.detach().clone().numpy() for k, p in eng.params.items()}
    out = eng.train_step(eng.put_data(scene_data), IDX, VALID)
    assert not bool(out["skipped_nan"]) and eng.step == 1
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    for k in ("reprojection", "disparity"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(metrics[k]),
                                   rtol=1e-4)
    got = {k: before[k] - p.detach().numpy() for k, p in eng.params.items()}
    assert _rel(got, want) <= 1e-2, _rel(got, want)
    # the BN running stats after the step
    stats = torch_import.state_dict_from_jax_variables(
        {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                               new_state.batch_stats)})
    sd = eng.model.net.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_eval_step_matches_jax(jax_variables, scene_data):
    """The validation pass: train-mode BN with running-stat updates and no
    parameter change. Loss rtol = 1e-5, per-pair losses and depth rtol =
    1e-4, BN running stats rtol = atol = 1e-5."""
    jax_variables = _tame(jax_variables)
    jeng = _jax_engine(jax_variables)
    new_state, metrics = jeng.eval_step(
        jeng.init_state(), jeng.put_data(scene_data), IDX, VALID)

    eng = TrainingEngine(_port_model(jax_variables),
                         create_optimizer("SGD", 1.0), LossWeights())
    before = {k: p.detach().clone() for k, p in eng.params.items()}
    out = eng.eval_step(eng.put_data(scene_data), IDX, VALID)
    assert eng.step == 0 and out["loss"].grad_fn is None
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    for k in ("reprojection", "disparity", "depth"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(metrics[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(out["pair_ids"].numpy(),
                                  np.asarray(metrics["pair_ids"]))
    for k, p in eng.params.items():
        assert torch.equal(p.detach(), before[k]), k
    stats = torch_import.state_dict_from_jax_variables(
        {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                               new_state.batch_stats)})
    sd = eng.model.net.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["Adam", "SGD", "AdamW"])
def test_optimizers_match_optax(name):
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]

    tx = jax_optimizer(name, 1e-2)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    opt = create_optimizer(name, 1e-2)(tparams.values())
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(params[k]), rtol=1e-6,
                                   atol=1e-6)


def test_adamw_weight_decay_is_optax_default():
    opt = create_optimizer("AdamW", 1e-3)([torch.nn.Parameter(torch.ones(2))])
    assert opt.defaults["weight_decay"] == 1e-4
    assert opt.defaults["eps"] == 1e-8


@pytest.mark.parametrize("fault", ["loss", "grad"])
def test_nan_skip(jax_variables, scene_data, fault):
    """A batch whose loss is not finite, or whose loss is finite but one
    gradient is not, leaves the parameters and Adam's state (moments and
    step count) bitwise unchanged; the BN running stats keep the forward's
    update and the step counter advances."""
    eng = TrainingEngine(_port_model(jax_variables),
                         create_optimizer("Adam", 4e-4), LossWeights())
    data = eng.put_data(scene_data)
    first = eng.train_step(data, IDX, VALID)
    assert not bool(first["skipped_nan"])
    params = {k: p.detach().clone() for k, p in eng.params.items()}
    opt = {k: {n: v.clone() for n, v in s.items()}
           for k, s in eng.optimizer.state_dict()["state"].items()}
    bn = eng.model.net.seq[1].running_mean.clone()
    if fault == "loss":
        bad = dict(data)
        bad["flows"] = data["flows"].clone()
        bad["flows"][0] = float("nan")
        out = eng.train_step(bad, np.array([0, 0, 0, 0], np.int32), VALID)
    else:
        # a 0 * inf gradient behind a finite loss, in one parameter only
        hook = eng.params["pred_layer.bias"].register_hook(
            lambda g: g * float("inf") * 0.0)
        out = eng.train_step(data, IDX, VALID)
        hook.remove()
        assert bool(torch.isfinite(out["loss"]))
    assert bool(out["skipped_nan"])
    assert eng.step == 2
    for k, p in eng.params.items():
        assert torch.equal(p.detach(), params[k]), k
    state = eng.optimizer.state_dict()["state"]
    assert state.keys() == opt.keys()
    for k, s in state.items():
        for n, v in s.items():
            assert torch.equal(v, opt[k][n]), (k, n)
    assert int(state[0]["step"]) == 1
    assert not torch.equal(eng.model.net.seq[1].running_mean, bn)


def test_bf16_step_close_to_f32(jax_variables, scene_data):
    """The bf16 compute dtype keeps f32 parameters and gives the f32
    step's loss within 0.05 (tests/test_bf16.py's band), from a tame
    init: the prediction head scaled by 0.05, as a pretrained net predicts
    O(1) depths."""
    out, dtypes = {}, {}
    for precision in ("f32", "bf16"):
        model = _port_model(jax_variables)
        with torch.no_grad():
            model.net.pred_layer.weight.mul_(0.05)
            model.net.pred_layer.bias.mul_(0.05)
        eng = TrainingEngine(model, create_optimizer("Adam", 4e-4),
                             LossWeights(), precision=precision)
        out[precision] = eng.train_step(eng.put_data(scene_data), IDX, VALID)
        dtypes[precision] = {p.dtype for p in eng.params.values()}
        assert not bool(out[precision]["skipped_nan"])
    assert dtypes["bf16"] == {torch.float32}
    l32, l16 = float(out["f32"]["loss"]), float(out["bf16"]["loss"])
    assert abs(l16 - l32) <= 0.05 * abs(l32), (l16, l32)


def test_engine_refuses_bf16_parameters():
    model = MannequinChallengeModel(checkpoint="", device="cpu",
                                    dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TrainingEngine(model, create_optimizer("Adam", 1e-3), LossWeights())
