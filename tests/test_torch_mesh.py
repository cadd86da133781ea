"""The port's data mesh (``consistent_depth_tpu_torch.parallel``) on two gloo
ranks on the CPU, against the JAX package's one program over the global
batch and against the port's own one-process passes.

Two ranks start in the background with ``torch.multiprocessing`` and a
``file://`` store under the test's temporary directory, one torch thread
each, and run every case of this file in turn, writing each result as it is
done (a case that needs the JAX seed-0 weights waits for its arguments);
their bodies are in ``tests/torch_mesh_worker.py``, which imports no jax. The references run here, on the global batch, while the ranks run. The
data make the global reductions show: the focal lengths differ per pair (a
local focal mean would differ), and the one padded pair of the train batch
sits on rank 1 only (a local valid count would differ).

Bands, each with the value measured here (on an 8-core CPU host) and,
after "Fault", the value it read on a scratch copy of the port with that
fault injected, on the same inputs:

1. mesh functions: ``shard_batch``/``all_gather_batch`` round-trip exactly;
   ``all_reduce_sum``'s gradient equals the one-process gradient of the
   summed objective (rtol 1e-6); an odd batch raises.
2. ``GlobalBatchNorm2d`` with different data on each rank, against JAX
   ``fused_batch_norm_pure`` on the concatenation: y and both running stats
   within 1e-6 of max |ref| (measured 2.5e-7, 1.9e-7, 1.9e-7), the input
   gradient within relative L2 1e-5 (2.1e-7). Fault, local statistics: y
   0.84; fault, the running variance unbiased by the local n: 2.1e-3.
3. the loss on two ranks against JAX ``consistency_loss`` and ``joint_loss``
   (``lambda_parameter`` 0.5) on the global batch: the scalar at rtol 1e-6
   (measured 4.6e-8 for the sum of the ranks' consistency shares, 0 for the
   joint value), the gathered per-pair losses within 1e-6 of max |ref|
   (1.1e-7), the gradients w.r.t. depths and params within relative L2 1e-5
   (3.0e-6, 0). Fault, a local focal mean: per-pair disparity 0.12; fault,
   a local valid count: consistency scalar 1.03; fault, the parameter loss
   counted on every rank: joint scalar 0.37 (its gradient 1.0).
4. the ``mc`` train step (the JAX seed-0 weights with the head scaled by
   0.05, 32x48, global batch 4). Against the JAX one-device step, with
   ``tests/test_torch_train_step.py``'s bands: loss rtol 1e-5 (measured
   9.0e-8), per-pair rtol 1e-4 (3.2e-5), the SGD(1.0) update within
   relative L2 1e-2 (5.9e-3), BN stats rtol = atol = 1e-5 (5.7e-6 abs).
   Against the port's one-process step, with ``tests/test_engine.py``'s
   bands for the JAX mesh: loss rtol 1e-5 (2.7e-7), parameters after the
   step within relative L2 5e-2 (2.6e-3), eval-mode gradients within 1e-5
   (1.4e-7), BN running stats within 1e-4 (1.7e-6). Faults against the
   one-process step: local BN statistics, loss 4.1e-3, parameters 0.16, BN
   stats 2.9e-2; the variance unbiased by the local n, BN stats 2.3e-3; a
   local focal mean, loss 2.5e-3, eval-mode gradients 1.7e-3; a local valid
   count, loss 1.09, eval-mode gradients 1.07. After three Adam steps both
   ranks' parameters, buffers and optimizer state are bitwise equal. A NaN
   loss from rank 1's block and a finite loss with a non-finite gradient on
   rank 1 alone skip the step on both ranks. Fault, the NaN flag taken
   before the gradient all-reduce: rank 0 did not skip the second, and the
   replicas parted.
5. ``train_epoch`` (Adam 4e-4, three steps of 4 pairs at 16x32) and both
   eval passes on two ranks against the port's one-process passes, with
   ``tests/test_torch_epoch.py``'s bands: the losses of steps 0 and 1 at
   rtol 1e-5 and 1e-3 (measured 2.0e-7, 3.0e-4; step 1 follows the first
   Adam update, which moves a parameter whose gradient's sign rounding
   decides by the whole lr: a two-step variant of this case, its second
   batch padded on rank 1, read 1.5e-3 there, so this band sits near the
   noise), every step within 8e-2 (3.8e-2, step 2), the final parameters
   within relative L2 5e-2 (8.7e-3),
   the captured depth of step 0 within 1e-4 (7.7e-6); per-pair losses and
   ``depth_frames`` of each eval pass within 1e-4 relative (paired 3.1e-5,
   dedup 2.3e-5), the BN running stats within 1e-4 (3.2e-5, 6.0e-6). Per-pair
   scales make each occurrence of a frame in a batch give another depth, so
   the paired pass's first-occurrence rule shows across the ranks' blocks;
   the capture slots hold the global batch.
6. serving: the two-rank server's depths against the one-process server's
   (relative L2 1e-5; measured 0), in the same order on both ranks, the
   ranks' depths equal; a batch size that is not a multiple of 2 raises.
7. the CLI on two ranks at ``--batch_size 8`` (global 16) on the golden
   fixture, with the goldens' untamed seed-0 weights, and a ``--resume``
   from its epoch 1 (bitwise the uninterrupted second epoch). Against
   ``tests/golden/e2e`` (8 devices at ``--batch_size 2``, also global 16)
   with ``test_golden_parity``'s bands: the initial depth (RMSE max < 1e-3,
   measured 2.2e-7), the scales (rtol 1e-3) and the pre-training eval (1e-3,
   measured 1.8e-6). The post-training bands were checked first with
   ``tools/torch_cli_noise_probe.py --head 1 --lr 0 --batch_size 16
   --threads 2 1 4 --noise 1e-7 1e-6 --seeds 0 1 2``: the port against
   itself under 1e-7 relative weight noise spreads by 0.0188, 0.0274 and
   0.0816 in the post-training eval means and by 0.0104, 0.0069 and 0.0037
   in the final depth's RMSE max (seeds 0-2; at one and four threads 0.0613
   and 0.0349, 0.0144 and 0.0136). ``test_golden_parity``'s 0.05 and 0.02
   are not twice the largest (0.163, 0.0207). So the post-training eval and
   the final depth are held against the port's one-process run at
   ``--batch_size 16``, the same computation without the collectives, with
   bands of twice that spread: 0.17 (measured 7.8e-3) and 0.025 (7.3e-3).
   Against the goldens the two-rank run read 0.0123 and 0.0066, inside
   ``test_golden_parity``'s bands, which the noise does not let a test
   hold.
"""

import concurrent.futures
import glob
import json
import os
import sys
from os.path import join as pjoin

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import synthetic
import torch_mesh_worker as worker
from consistent_depth_tpu.models import torch_import as jax_torch_import
from consistent_depth_tpu.models.layers import fused_batch_norm_pure
from consistent_depth_tpu.models.mannequin_challenge import (
    MannequinChallengeModel as JaxMC)
from consistent_depth_tpu.ops import losses as jax_losses
from consistent_depth_tpu.training import TrainingEngine as JaxEngine
from consistent_depth_tpu.training import create_optimizer as jax_optimizer
from consistent_depth_tpu_torch.cli import main as cli_main
from consistent_depth_tpu_torch.io import metadata_io
from consistent_depth_tpu_torch.models import torch_import
from consistent_depth_tpu_torch.ops.losses import LossWeights
from consistent_depth_tpu_torch.parallel import make_mesh
from consistent_depth_tpu_torch.serving import DepthServer, ServeConfig
from consistent_depth_tpu_torch.training import (
    TrainingEngine, create_optimizer, gather_batch)

sys.path.insert(0, pjoin(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import compare_artifacts as ca  # noqa: E402

GOLDEN_DIR = pjoin(os.path.dirname(__file__), "golden", "e2e")
RANGE = "R_hierarchical2_mc"
# the train batch: its padded pair lies in rank 1's block
IDX = np.array([0, 1, 2, 3], np.int32)
VALID = np.array([1, 1, 1, 0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(worker.THREADS)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    """Relative L2 distance of two {name: array} maps over b's names."""
    va = np.concatenate([np.ravel(a[k]) for k in sorted(b)])
    vb = np.concatenate([np.ravel(b[k]) for k in sorted(b)])
    return float(np.linalg.norm(va - vb) / np.linalg.norm(vb))


def _max_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _per_pair_focal(data):
    """``data`` with each pair's focal lengths scaled by its own factor."""
    data = dict(data)
    scale = 1 + 0.15 * np.arange(len(data["pair_ids"]), dtype=np.float32)
    data["intrinsics"] = data["intrinsics"].copy()
    data["intrinsics"][..., :2] *= scale[:, None, None]
    return data


# -- the inputs ---------------------------------------------------------------
def _bn_inputs():
    rng = np.random.default_rng(3)
    # each rank's block has its own mean and spread
    x = np.concatenate([rng.normal(0.0, 1.0, (2, 6, 5, 7)),
                        rng.normal(3.0, 2.0, (2, 6, 5, 7))]).astype(
                            np.float32)
    return {"x": x, "ct": rng.standard_normal(x.shape).astype(np.float32),
            "mean": rng.normal(0, 0.1, 6).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "bias": rng.normal(0, 0.5, 6).astype(np.float32)}


def _loss_inputs(scene_data):
    rng = np.random.default_rng(4)
    d = {k: scene_data[k][IDX] for k in
         ("intrinsics", "extrinsics", "flows", "masks")}
    d["flows"] = d["flows"] + rng.normal(0, 0.5, d["flows"].shape).astype(
        np.float32)
    d["masks"] = (rng.random(d["masks"].shape) > 0.3).astype(np.float32)
    d["depths"] = rng.uniform(1.5, 2.5, (4, 2, 32, 48)).astype(np.float32)
    d["valid"] = VALID
    d["params"] = {"a": rng.standard_normal((3, 4)).astype(np.float32),
                   "b": rng.standard_normal(5).astype(np.float32)}
    d["params_init"] = {k: v + rng.normal(0, 0.1, v.shape).astype(np.float32)
                        for k, v in d["params"].items()}
    d["lambda_parameter"] = 0.5
    return d


def _random_stats(variables, seed=0):
    """``variables`` with random BN running stats, for the eval-mode
    gradients (tests/test_torch_train_step.py)."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else (
            rng.normal(0, 0.1, v.shape) if k == "mean"
            else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in tree.items()}

    return {**variables, "batch_stats": fill(variables["batch_stats"])}


ADAM_BATCHES = [(np.array([4, 5, 6, 7], np.int32), np.ones(4, np.float32)),
                (np.array([8, 0, 2, 1], np.int32), np.ones(4, np.float32)),
                (IDX, VALID)]
NAN_PAIR = 2     # IDX[2], in rank 1's block

EH, EW = 16, 32
E_IDX = np.array([[0, 1, 2, 3], [4, 0, 1, 2], [3, 4, 0, 1]], np.int32)
E_VALID = np.array([[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 0]], np.float32)
E_CAPTURE = np.array([0, -1, 1], np.int32)
# pairs (0, 1), (1, 2) | (2, 3), (0, 2): frames 0 and 2 in both blocks;
# then pair 4 padded with valid 0, as dispatch_eval pads
EVAL_IDX = np.array([[0, 1, 2, 3], [4, 4, 4, 4]], np.int32)
EVAL_VALID = np.array([[1, 1, 1, 1], [1, 0, 0, 0]], np.float32)

CLI_ARGS = ["--batch_size", "8", "--num_epochs", "2", "--model_type", "mc",
            "--resume"]
CLI_TAG = "B0.1_R1.0_PL1-0_LR0.0004_BS8_Oadam"
# the post-training bands against the one-process run: twice the port's
# spread against itself under 1e-7 weight noise at global batch 16
# (module docstring)
TOL_CLI_POST = 0.17
TOL_CLI_FINAL = 0.025


def _epoch_data():
    scene = synthetic.make_scene(num_frames=4, H=EH, W=EW)
    data = _per_pair_focal(
        synthetic.build_pair_arrays(scene, synthetic.make_pairs(4)))
    # each side of each pair its own scale: every occurrence of a frame in
    # a batch gives another depth
    data["scales"] = (1 + 0.05 * np.arange(10, dtype=np.float32)).reshape(
        5, 2)
    return data


def _jax_refs(runs):
    """The JAX package's references on the global batch, as numpy: the
    batch norm (y, running mean and variance, input gradient), the two
    losses (scalar, per-pair losses, gradients w.r.t. depths and params)
    and the one-device SGD(1.0) step (metrics; the update, the parameters
    before it and the BN stats after it, in the torch layout)."""
    out = {}
    bn = runs["bn"]

    def bn_ref(x_nchw):
        y, m, v = fused_batch_norm_pure(
            jnp.transpose(x_nchw, (0, 2, 3, 1)), jnp.asarray(bn["mean"]),
            jnp.asarray(bn["var"]), train=True)
        y = y * bn["weight"] + bn["bias"]
        return jnp.transpose(y, (0, 3, 1, 2)), m, v

    (y, m, v), vjp = jax.vjp(bn_ref, jnp.asarray(bn["x"]))
    (grad,) = vjp((jnp.asarray(bn["ct"]), jnp.zeros_like(m),
                   jnp.zeros_like(v)))
    out["bn"] = tuple(np.asarray(a) for a in (y, m, v, grad))

    d = runs["loss"]
    weights = jax_losses.LossWeights(
        lambda_view_baseline=0.1, lambda_parameter=d["lambda_parameter"])
    args = [jnp.asarray(d[k]) for k in
            ("intrinsics", "extrinsics", "flows", "masks")]
    valid = jnp.asarray(d["valid"])
    params_init = jax.tree_util.tree_map(jnp.asarray, d["params_init"])
    losses = {
        "consistency": lambda depths, params: jax_losses.consistency_loss(
            depths, *args, weights, valid=valid),
        "joint": lambda depths, params: jax_losses.joint_loss(
            depths, *args, weights, params=params, params_init=params_init,
            valid=valid)}
    out["loss"] = {}
    for name, f in losses.items():
        (scalar, per_pair), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(
            jnp.asarray(d["depths"]),
            jax.tree_util.tree_map(jnp.asarray, d["params"]))
        out["loss"][name] = (
            float(scalar), jax.tree_util.tree_map(np.asarray, per_pair),
            np.asarray(grads[0]),
            jax.tree_util.tree_map(np.asarray, grads[1]))

    model = JaxMC(variables=jax.tree_util.tree_map(jnp.asarray,
                                                   runs["tamed"]))
    jeng = JaxEngine(model, jax_optimizer("SGD", 1.0),
                     jax_losses.LossWeights())
    state = jeng.init_state()
    before = jax.tree_util.tree_map(np.asarray, state.params)
    new_state, metrics = jeng.train_step(
        state, jeng.put_data(runs["scene_data"]), IDX, VALID)
    out["step"] = (
        jax.tree_util.tree_map(np.asarray, metrics),
        torch_import.state_dict_from_jax_variables({
            "params": jax.tree_util.tree_map(
                lambda a, b: a - np.asarray(b), before, new_state.params)}),
        torch_import.state_dict_from_jax_variables({"params": before}),
        torch_import.state_dict_from_jax_variables({
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  new_state.batch_stats)}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank body of this file, on two ranks started in the background
    at once, case by case, so that the references run while the ranks do:
    the mesh functions, the batch norm, the loss, then, once the JAX seed-0
    weights exist, the train step, the epoch and serving (tamed weights)
    and the CLI (the untamed weights as the default checkpoint). The JAX
    references run in a thread (``runs["jax"]``, a future), the port's
    one-process references in the tests."""
    root = tmp_path_factory.mktemp("mesh")
    scene = synthetic.make_scene(num_frames=6, H=32, W=48)
    out = {"scene_data": _per_pair_focal(
        synthetic.build_pair_arrays(scene, synthetic.make_pairs(6))),
        "epoch_data": _epoch_data(), "bn": _bn_inputs(),
        "x": np.random.default_rng(5).standard_normal((2, 3, 5)).astype(
            np.float32),
        "coef": np.array([1.0, 3.0], np.float32),
        "frames": np.random.default_rng(6).random((7, 32, 48, 3),
                                                  dtype=np.float32)}
    out["loss"] = _loss_inputs(out["scene_data"])
    # the cases that need the JAX seed-0 weights get them once they exist
    later = {name: worker.Later(str(root / f"{name}_args.pkl"))
             for name in ("train_step", "epoch", "serve", "cli")}
    launch = out["ranks"] = worker.start(
        str(root), "mesh",
        mesh_functions={"x": out["x"], "coef": out["coef"]},
        batch_norm=out["bn"], loss=out["loss"], **later)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        out["jax_variables"] = jax.tree_util.tree_map(
            np.asarray, JaxMC(checkpoint="", seed=0).variables)
        params = dict(out["jax_variables"]["params"])
        params["pred_layer"] = {k: v * np.float32(0.05)
                                for k, v in params["pred_layer"].items()}
        out["tamed"] = {**out["jax_variables"], "params": params}
        sd = out["sd"] = torch_import.state_dict_from_jax_variables(
            out["tamed"])
        out["eval_sd"] = torch_import.state_dict_from_jax_variables(
            _random_stats(out["tamed"]))
        worker.write_later(later["train_step"], {
            "data": out["scene_data"], "state_dict": sd, "idx": IDX,
            "valid": VALID, "eval_state_dict": out["eval_sd"],
            "adam_batches": ADAM_BATCHES, "nan_pair": NAN_PAIR})
        worker.write_later(later["epoch"], {
            "data": out["epoch_data"], "state_dict": sd, "idx": E_IDX,
            "valid": E_VALID, "capture": E_CAPTURE, "eval_idx": EVAL_IDX,
            "eval_valid": EVAL_VALID})
        worker.write_later(later["serve"], {
            "state_dict": sd, "frames": out["frames"], "batch_size": 4,
            "bad_batch_size": 3})
        ckpt_dir = root / "checkpoints"
        ckpt_dir.mkdir()
        out["ckpt_dir"] = str(ckpt_dir)
        jax_torch_import.save_torch_checkpoint(str(ckpt_dir / "mc.pth"),
                                               out["jax_variables"])
        out["cli_path"] = str(root / "cli")
        os.makedirs(out["cli_path"])
        synthetic.build_e2e_dataset(out["cli_path"])
        worker.write_later(later["cli"], {
            "path": out["cli_path"], "argv": CLI_ARGS,
            "resumed": str(root / "cli_resumed"),
            "tag_dir": pjoin(RANGE, CLI_TAG),
            "checkpoint_dir": out["ckpt_dir"]})
        # the JAX references in a thread of their own (XLA's compile and
        # run release the GIL), beside this process's torch references
        out["jax"] = pool.submit(_jax_refs, out)
        yield out
    finally:
        pool.shutdown(wait=True)
        launch.close()


# -- case 1: the mesh functions ------------------------------------------
def test_mesh_functions(runs):
    x, coef = runs["x"], runs["coef"]
    batch = np.arange(24.0, dtype=np.float32).reshape(4, 6)
    xs = torch.tensor(x, requires_grad=True)
    y = xs.sum(0)
    sum(float(c) * y.square() for c in coef).sum().backward()
    for r, out in enumerate(runs["ranks"].result("mesh_functions")):
        np.testing.assert_array_equal(out["shard0"], batch[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["shard1"],
                                      batch[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["round_trip0"], batch)
        np.testing.assert_array_equal(out["round_trip1"], batch)
        np.testing.assert_array_equal(out["gathered_bool"],
                                      [True, True, False, True])
        assert out["odd_batch_raised"]
        np.testing.assert_allclose(out["y"], y.detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(out["grad"], xs.grad[r].numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out["replicated"], np.ones((2, 3)))


def test_make_mesh_refusals(monkeypatch):
    """More devices than started ranks, and the card's default without a
    card, raise before any process group is joined."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="2 devices"):
        make_mesh(n_devices=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not torch.distributed.is_initialized()


# -- case 4: the train step -----------------------------------------------
def _step_results(runs):
    return runs["ranks"].result("train_step")


def test_train_step_matches_one_process(runs):
    scene_data = runs["scene_data"]
    eng = TrainingEngine(worker.port_model(runs["sd"]),
                         create_optimizer("SGD", 1.0), LossWeights())
    m = eng.train_step(eng.put_data(scene_data), IDX, VALID)
    params = {k: p.detach().numpy() for k, p in eng.params.items()}
    buffers = {k: b.numpy() for k, b in eng.model.net.named_buffers()
               if k.endswith(("running_mean", "running_var"))}
    eng = TrainingEngine(worker.port_model(runs["eval_sd"]),
                         create_optimizer("SGD", 1.0), LossWeights())
    data = eng.put_data(scene_data)
    idx, valid = eng._indices(IDX, VALID)
    loss, _, _ = eng._loss(gather_batch(data, idx), valid, train=False)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in eng.params.items()}
    for out in _step_results(runs):
        sgd = out["sgd"]
        np.testing.assert_allclose(sgd["metrics"]["loss"], float(m["loss"]),
                                   rtol=1e-5)
        assert not sgd["metrics"]["skipped_nan"]
        assert _rel(sgd["params"], params) < 5e-2, _rel(sgd["params"],
                                                        params)
        np.testing.assert_allclose(out["eval"]["loss"], float(loss),
                                   rtol=1e-5)
        assert _rel(out["eval"]["grads"], grads) < 1e-5, _rel(
            out["eval"]["grads"], grads)
        for k, v in buffers.items():
            np.testing.assert_allclose(sgd["buffers"][k], v, rtol=0,
                                       atol=1e-4, err_msg=k)


def _assert_same_state(a, b):
    for part in ("params", "buffers"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k],
                                          err_msg=f"{part} {k}")
    assert a["optimizer"].keys() == b["optimizer"].keys()
    for k in a["optimizer"]:
        for n, v in a["optimizer"][k].items():
            np.testing.assert_array_equal(v, b["optimizer"][k][n],
                                          err_msg=f"optimizer {k} {n}")
    assert a["step"] == b["step"]


def test_replicas_stay_bitwise_equal(runs):
    r0, r1 = _step_results(runs)
    assert r0["adam_losses"] == r1["adam_losses"]
    assert all(np.isfinite(r0["adam_losses"]))
    assert r0["adam"]["step"] == 3
    _assert_same_state(r0["adam"], r1["adam"])


def test_nan_on_one_rank_skips_both(runs):
    """A NaN loss from rank 1's block, then a finite loss whose gradient is
    not finite on rank 1 alone: both ranks skip both steps, leaving the
    parameters and Adam's state as they were; the BN stats move."""
    for out in _step_results(runs):
        before = out["adam"]
        for name in ("nan", "nan_grad"):
            after = {k: v for k, v in out[name].items()
                     if k not in ("skipped", "loss")}
            assert out[name]["skipped"], name
            _assert_same_state(after, dict(before, buffers=after["buffers"],
                                           step=after["step"]))
        assert np.isfinite(out["nan_grad"]["loss"])
        assert out["nan_grad"]["step"] == before["step"] + 2


# -- case 5: the epoch and the eval passes --------------------------------
@pytest.fixture(scope="module")
def epoch_refs(runs):
    """The port's one-process passes on the global batch."""
    data, sd = runs["epoch_data"], runs["sd"]
    ref = {}
    eng = TrainingEngine(worker.port_model(sd),
                         create_optimizer("Adam", 4e-4), LossWeights())
    ref["train"] = {k: v.numpy() for k, v in eng.train_epoch(
        eng.put_data(data), E_IDX, E_VALID, E_CAPTURE).items()}
    ref["train_params"] = {k: p.detach().numpy()
                           for k, p in eng.params.items()}
    for dedup in (False, True):
        eng = TrainingEngine(worker.port_model(sd),
                             create_optimizer("Adam", 4e-4), LossWeights(),
                             eval_dedup=dedup)
        name = "dedup" if dedup else "paired"
        ref[name] = {k: v.numpy() for k, v in eng.eval_epoch(
            eng.put_data(data), EVAL_IDX, EVAL_VALID).items()}
        ref[name + "_buffers"] = {k: b.numpy() for k, b in
                                  eng.model.net.named_buffers()}
    return ref


def _epoch_results(runs):
    return runs["ranks"].result("epoch")


def test_train_epoch_matches_one_process(runs, epoch_refs):
    want = epoch_refs["train"]
    ranks = _epoch_results(runs)
    for out in ranks:
        got = out["train"]
        np.testing.assert_allclose(got["loss"][0], want["loss"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["loss"][1], want["loss"][1],
                                   rtol=1e-3)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=8e-2)
        np.testing.assert_array_equal(got["skipped_nan"],
                                      want["skipped_nan"])
        assert got["reprojection"].shape == E_IDX.shape
        np.testing.assert_allclose(got["reprojection"][0],
                                   want["reprojection"][0], rtol=1e-4)
        # the capture slots hold the global batch of steps 0 and 2
        assert got["captured_depth"].shape == want["captured_depth"].shape
        assert _max_err(got["captured_depth"][0],
                        want["captured_depth"][0]) <= 1e-4
        assert np.abs(got["captured_depth"][1]).min() > 0
        assert not got["captured_depth"][2:].any()
        assert _rel(out["train_state"]["params"],
                    epoch_refs["train_params"]) <= 5e-2
        assert out["train_state"]["step"] == 3
    _assert_same_state(ranks[0]["train_state"], ranks[1]["train_state"])


@pytest.mark.parametrize("name", ["paired", "dedup"])
def test_eval_pass_matches_one_process(runs, epoch_refs, name):
    want = epoch_refs[name]
    for out in _epoch_results(runs):
        got = out[name]
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["pair_ids"], want["pair_ids"])
        np.testing.assert_array_equal(got["frames_seen"],
                                      want["frames_seen"])
        for k in ("loss", "reprojection", "disparity", "depth_frames"):
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
        for k, v in epoch_refs[name + "_buffers"].items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(out[name + "_buffers"][k], v,
                                           rtol=1e-4, atol=1e-4, err_msg=k)


# -- case 6: serving --------------------------------------------------------
def test_serving_matches_one_process(runs):
    frames = runs["frames"]
    server = DepthServer(ServeConfig(precision="f32", device="cpu",
                                     batch_size=4),
                         model=worker.port_model(runs["sd"]))
    order = [k for k, _ in server.serve(enumerate(frames))]
    want = server.infer_frames(frames)
    ranks = runs["ranks"].result("serve")
    for r in ranks:
        assert r["order"] == order
        assert r["bad_batch_raised"]
        assert _rel({"d": r["depth"]}, {"d": want}) <= 1e-5
    np.testing.assert_array_equal(ranks[0]["depth"], ranks[1]["depth"])


# -- case 7: the CLI ----------------------------------------------------------
def _cli_results(runs):
    return runs["ranks"].result("cli")


@pytest.fixture(scope="module")
def one_process_cli(runs, tmp_path_factory):
    """The port's CLI in one process at ``--batch_size 16``: the mesh run's
    computation without the collectives."""
    path = str(tmp_path_factory.mktemp("cli_one_process"))
    synthetic.build_e2e_dataset(path)
    argv = ["--path", path, "--batch_size", "16"] + CLI_ARGS[2:-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDTPU_CHECKPOINT_DIR", runs["ckpt_dir"])
        _, out_dir, _ = cli_main.main(argv, device="cpu")
    return out_dir


def test_cli_against_goldens(runs, one_process_cli):
    ranks = _cli_results(runs)
    initial_depth_dir, out_dir, frames = ranks[0][0]["result"]
    assert ranks[1][0]["result"] == ranks[0][0]["result"]
    assert frames == list(range(6))
    # the tag names the per-rank batch, as the JAX driver's
    assert os.path.basename(out_dir) == CLI_TAG
    for r in ranks:
        assert "Using 2 devices." in r[0]["stdout"]
        assert "Adjusting batch size to 16." in r[0]["stdout"]
    d = ca.compare_depth_dirs(pjoin(GOLDEN_DIR, "initial_depth"),
                              pjoin(initial_depth_dir, "depth"))
    assert d["frames_compared"] == 6 and not d["frames_only_a"]
    assert d["rmse_max"] < 1e-3, d
    golden = metadata_io.read_scales_csv(pjoin(GOLDEN_DIR, "scales.csv"))
    scales = metadata_io.read_scales_csv(
        pjoin(runs["cli_path"], RANGE, "scales.csv"))
    np.testing.assert_array_equal(scales[:, 0], golden[:, 0])
    np.testing.assert_allclose(scales[:, 1], golden[:, 1], rtol=1e-3)
    e = ca.compare_eval_losses(pjoin(GOLDEN_DIR, "eval"),
                               pjoin(out_dir, "eval"))
    assert sorted(e) == sorted(os.listdir(pjoin(GOLDEN_DIR, "eval")))
    for key, v in e["loss_e0000_iter000000.json"].items():
        assert v["rel_diff"] < 1e-3, (key, v)
    # after training, against the same computation in one process: the
    # goldens' bands do not clear twice the noise (module docstring)
    e = ca.compare_eval_losses(pjoin(one_process_cli, "eval"),
                               pjoin(out_dir, "eval"))
    assert len(e) == 3
    for name in e:
        band = 1e-3 if "_e0000_" in name else TOL_CLI_POST
        for key, v in e[name].items():
            assert v["rel_diff"] < band, (name, key, v)
    d = ca.compare_depth_dirs(pjoin(one_process_cli, "depth"),
                              pjoin(out_dir, "depth"))
    assert d["frames_compared"] == 6 and not d["frames_only_a"]
    assert d["rmse_max"] < TOL_CLI_FINAL, d


def test_cli_output_tree(runs):
    """Rank 0 alone wrote: the eval files and the depth maps are the
    goldens', file for file, and there is one event file."""
    initial_depth_dir, out_dir, _ = _cli_results(runs)[0][0]["result"]
    for mine, golden in ((pjoin(out_dir, "eval"), "eval"),
                         (pjoin(out_dir, "depth"), "final_depth"),
                         (pjoin(initial_depth_dir, "depth"),
                          "initial_depth")):
        want = sorted(os.listdir(pjoin(GOLDEN_DIR, golden)))
        assert sorted(f for f in os.listdir(mine)
                      if f.startswith(("loss_", "frame_"))) == want
    events = glob.glob(pjoin(out_dir, "tensorboard", "events.*"))
    assert len(events) == 1, events
    assert sorted(os.listdir(pjoin(out_dir, "checkpoints"))) == [
        "0001.pth", "0002.pth", "full_0001", "full_0002"]


def test_cli_resume_equals_uninterrupted(runs):
    """A ``--resume`` from rank 0's epoch-1 state gives the uninterrupted
    run's second epoch, bitwise."""
    ranks = _cli_results(runs)
    for r in ranks:
        assert "Resumed from" in r[1]["stdout"]
    full, resumed = (os.path.dirname(ranks[0][k]["result"][0]) for k in
                     (0, 1))
    full, resumed = (pjoin(p, RANGE, CLI_TAG) for p in (full, resumed))
    a = torch_import.load_checkpoint(pjoin(full, "checkpoints", "0002.pth"))
    b = torch_import.load_checkpoint(pjoin(resumed, "checkpoints",
                                           "0002.pth"))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    name = "loss_e0002_iter000020.json"
    with open(pjoin(full, "eval", name)) as f, \
            open(pjoin(resumed, "eval", name)) as g:
        assert json.load(f) == json.load(g)
    d = ca.compare_depth_dirs(pjoin(full, "depth"), pjoin(resumed, "depth"))
    assert d["frames_compared"] == 6 and d["rmse_max"] == 0.0


# -- against the JAX package: cases 2, 3 and 4 --------------------------------
# last in the file: their references are computed in a thread meanwhile
# case 2: the batch norm
def test_global_batch_norm_matches_jax(runs):
    y, m, v, grad = runs["jax"].result()["bn"]
    for out in runs["ranks"].result("batch_norm"):
        assert _max_err(out["y"], y) <= 1e-6, _max_err(out["y"], y)
        assert _max_err(out["running_mean"], m) <= 1e-6
        assert _max_err(out["running_var"], v) <= 1e-6
        assert _rel({"g": out["grad"]}, {"g": grad}) <= 1e-5


# case 3: the loss
@pytest.mark.parametrize("name", ["consistency", "joint"])
def test_loss_matches_jax(runs, name):
    scalar, per_pair, g_depths, g_params = runs["jax"].result()["loss"][name]
    ranks = runs["ranks"].result("loss")
    scalars = [out[name]["scalar"] for out in ranks]
    if name == "consistency":
        # each rank's share: its sum over the global valid count
        np.testing.assert_allclose(sum(scalars), scalar, rtol=1e-6)
    else:
        # the global value on every rank
        np.testing.assert_allclose(scalars, scalar, rtol=1e-6)
    for out in ranks:
        out = out[name]
        for k in ("reprojection", "disparity"):
            assert _max_err(out["per_pair"][k], per_pair[k]) <= 1e-6, k
        assert _rel({"d": out["grad_depths"]}, {"d": g_depths}) <= 1e-5
        if name == "joint":
            assert _rel(out["grad_params"], g_params) <= 1e-5


def test_train_step_matches_jax(runs):
    metrics, want, init, stats = runs["jax"].result()["step"]
    for out in _step_results(runs):
        sgd = out["sgd"]
        np.testing.assert_allclose(sgd["metrics"]["loss"], metrics["loss"],
                                   rtol=1e-5)
        for k in ("reprojection", "disparity"):
            np.testing.assert_allclose(sgd["metrics"][k], metrics[k],
                                       rtol=1e-4)
        delta = {k: init[k] - sgd["params"][k] for k in want}
        assert _rel(delta, want) <= 1e-2, _rel(delta, want)
        for k, v in stats.items():
            np.testing.assert_allclose(sgd["buffers"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
