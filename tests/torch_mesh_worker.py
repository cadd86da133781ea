"""Rank bodies of ``tests/test_torch_mesh.py``: each runs in one process of a
gloo mesh on the CPU, started in the background by :func:`start` with
``torch.multiprocessing``, and writes what the test holds against its
references, case by case, to ``{out_dir}/{tag}_{case}_rank{r}.pkl``.

This module imports torch and the port, never jax nor ``conftest``, so that a
child process starts in about two seconds. The references (the JAX package,
the port's one-process passes) run in the test's own process.
"""

import os
import pickle
import shutil
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from consistent_depth_tpu_torch.models.layers import (  # noqa: E402
    GlobalBatchNorm2d)
from consistent_depth_tpu_torch.models import (  # noqa: E402
    mannequin_challenge)
from consistent_depth_tpu_torch.ops import losses  # noqa: E402
from consistent_depth_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from consistent_depth_tpu_torch.training import (  # noqa: E402
    TrainingEngine, create_optimizer, gather_batch)
from consistent_depth_tpu_torch.training.engine import PER_PAIR  # noqa: E402

RANKS = 2
THREADS = 1


class Later:
    """A case's keyword arguments that the test writes to ``path`` after the
    ranks have started (:func:`write_later`); a rank waits for the file."""

    def __init__(self, path):
        self.path = path

    def get(self):
        while not os.path.exists(self.path):
            time.sleep(0.05)
        with open(self.path, "rb") as f:
            return pickle.load(f)


def write_later(later, kwargs):
    """Give the ranks waiting on ``later`` their arguments."""
    with open(later.path + ".tmp", "wb") as f:
        pickle.dump(kwargs, f)
    os.replace(later.path + ".tmp", later.path)


class Launch:
    """Ranks started in the background by :func:`start`."""

    def __init__(self, context, prefix, nprocs):
        self.context, self.prefix, self.nprocs = context, prefix, nprocs

    def result(self, case):
        """Each rank's result of ``case``, in rank order, as soon as every
        rank has written it; a rank that raised raises here."""
        paths = [f"{self.prefix}_{case}_rank{r}.pkl"
                 for r in range(self.nprocs)]
        while not all(os.path.exists(p) for p in paths):
            if self.context.join(timeout=0.1):
                break
        out = []
        for p in paths:
            with open(p, "rb") as f:
                out.append(pickle.load(f))
        return out

    def close(self):
        """Stop any rank still running."""
        for p in self.context.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=60)


def start(out_dir, tag, nprocs=RANKS, **cases):
    """Start ``nprocs`` gloo ranks on the CPU, in the background, each
    running every case of ``cases`` (its name in :data:`CASES` -> its
    keyword arguments, or a :class:`Later` for them) in order and writing
    each result as it is done."""
    import torch.multiprocessing as mp

    prefix = os.path.join(out_dir, tag)
    context = mp.start_processes(
        _run, args=(nprocs, prefix + "_store", cases, prefix),
        nprocs=nprocs, join=False, start_method="spawn")
    return Launch(context, prefix, nprocs)


def _run(rank, world, store, cases, prefix):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(THREADS)
    mesh = pmesh.make_mesh(device="cpu", init_method="file://" + store)
    try:
        for name, kwargs in cases.items():
            if isinstance(kwargs, Later):
                kwargs = kwargs.get()
            result = CASES[name](mesh, **kwargs)
            path = f"{prefix}_{name}_rank{rank}.pkl"
            with open(path + ".tmp", "wb") as f:
                pickle.dump(result, f)
            os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def _np(obj):
    """``obj`` with every tensor as a numpy array (f32 unless integer or
    bool)."""
    if torch.is_tensor(obj):
        t = obj.detach().cpu()
        return t.numpy() if not t.is_floating_point() else t.float().numpy()
    if isinstance(obj, dict):
        return {k: _np(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_np(v) for v in obj)
    return obj


def port_model(state_dict):
    """The ``mc`` model on the CPU with the given weights (numpy)."""
    model = mannequin_challenge.MannequinChallengeModel(checkpoint="",
                                                        device="cpu")
    model.net.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in state_dict.items()}, strict=True)
    return model


# -- case 1: the mesh functions -------------------------------------------
def mesh_functions(mesh, x, coef):
    """``x`` (N, 3, 5): rank r's input to all_reduce_sum is x[r]; its
    objective is sum(coef[r] * y**2), y the sum over ranks."""
    r = mesh.rank
    batch = torch.arange(24.0).reshape(4, 6)
    out = {"shard0": _np(pmesh.shard_batch(mesh, batch)),
           "shard1": _np(pmesh.shard_batch(mesh, batch, axis=1))}
    out["round_trip0"] = _np(pmesh.all_gather_batch(
        mesh, pmesh.shard_batch(mesh, batch)))
    out["round_trip1"] = _np(pmesh.all_gather_batch(
        mesh, pmesh.shard_batch(mesh, batch.to(torch.float16), axis=1),
        axis=1))
    flags = torch.tensor([r == 0, True])
    out["gathered_bool"] = _np(pmesh.all_gather_batch(mesh, flags))
    try:
        pmesh.shard_batch(mesh, torch.zeros(3, 2))
        out["odd_batch_raised"] = False
    except ValueError:
        out["odd_batch_raised"] = True
    xr = torch.tensor(x[r], requires_grad=True)
    y = pmesh.all_reduce_sum(mesh, xr)
    (float(coef[r]) * y.square()).sum().backward()
    out["y"] = _np(y)
    out["grad"] = _np(xr.grad)
    rep = torch.full((2, 3), float(r + 1)).to(
        memory_format=torch.contiguous_format)
    pmesh.put_replicated(mesh, [rep])
    out["replicated"] = _np(rep)
    return out


# -- case 2: GlobalBatchNorm2d --------------------------------------------
def batch_norm(mesh, x, ct, weight, bias, mean, var):
    """A train-mode GlobalBatchNorm2d forward of this rank's block of ``x``
    (N, C, H, W) and the gradient of sum(y * ct) w.r.t. x, gathered; affine
    when ``weight`` is not None."""
    C = x.shape[1]
    bn = GlobalBatchNorm2d(C, mesh, affine=weight is not None).train()
    with torch.no_grad():
        if weight is not None:
            bn.weight.copy_(torch.from_numpy(weight))
            bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    xr = pmesh.shard_batch(mesh, torch.from_numpy(x)).clone()
    xr.requires_grad_(True)
    y = bn(xr)
    (y * pmesh.shard_batch(mesh, torch.from_numpy(ct))).sum().backward()
    return {"y": _np(pmesh.all_gather_batch(mesh, y.detach())),
            "grad": _np(pmesh.all_gather_batch(mesh, xr.grad)),
            "running_mean": _np(bn.running_mean),
            "running_var": _np(bn.running_var)}


# -- case 3: the loss --------------------------------------------------------
def loss(mesh, depths, intrinsics, extrinsics, flows, masks, valid, params,
         params_init, lambda_parameter):
    """``consistency_loss`` and ``joint_loss`` on this rank's block: the
    scalars, the gathered per-pair losses, and the gradients w.r.t. the
    depths (gathered) and the parameters (summed over the ranks)."""
    weights = losses.LossWeights(lambda_view_baseline=0.1,
                                 lambda_parameter=lambda_parameter)

    def block(a):
        return pmesh.shard_batch(mesh, torch.from_numpy(a))

    args = [block(a) for a in (intrinsics, extrinsics, flows, masks)]
    out = {}
    for name in ("consistency", "joint"):
        d = block(depths).clone().requires_grad_(True)
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
        p0 = {k: torch.from_numpy(v) for k, v in params_init.items()}
        if name == "consistency":
            scalar, per_pair = losses.consistency_loss(
                d, *args, weights, valid=block(valid), mesh=mesh)
        else:
            scalar, per_pair = losses.joint_loss(
                d, *args, weights, params=p, params_init=p0,
                valid=block(valid), mesh=mesh)
        scalar.backward()
        out[name] = {
            "scalar": float(scalar),
            "per_pair": {k: _np(pmesh.all_gather_batch(mesh, per_pair[k]))
                         for k in PER_PAIR},
            "grad_depths": _np(pmesh.all_gather_batch(mesh, d.grad)),
            "grad_params": {k: _np(pmesh.all_reduce_sum(
                mesh, v.grad if v.grad is not None else torch.zeros_like(v)))
                for k, v in p.items()}}
    return out


# -- case 4: the train step --------------------------------------------------
def _engine(mesh, state_dict, opt, lr, **kwargs):
    return TrainingEngine(port_model(state_dict), create_optimizer(opt, lr),
                          losses.LossWeights(lambda_view_baseline=0.1),
                          mesh=mesh, **kwargs)


def _state(engine):
    return {"params": _np(dict(engine.params)),
            "buffers": _np(dict(engine.model.net.named_buffers())),
            "optimizer": _np(engine.optimizer.state_dict()["state"]),
            "step": engine.step}


def train_step(mesh, data, state_dict, idx, valid, eval_state_dict,
               adam_batches, nan_pair):
    """One SGD(1.0) train-mode step; the eval-mode gradients on the
    ``eval_state_dict`` weights (random BN stats), summed over the ranks;
    three Adam steps; then a batch whose pair ``nan_pair`` (on rank 1's
    block) has NaN flows, and a batch whose loss is finite and one of whose
    gradients is not, on rank 1 alone."""
    out = {}
    eng = _engine(mesh, state_dict, "SGD", 1.0)
    dev = eng.put_data(data)
    m = eng.train_step(dev, idx, valid)
    out["sgd"] = {"metrics": _np(m), **_state(eng)}

    eng = _engine(mesh, eval_state_dict, "SGD", 1.0)
    dev = eng.put_data(data)
    i, v = eng._indices(idx, valid)
    eng._grad_flat.zero_()
    for p, g in zip(eng.params.values(), eng._grad_views):
        p.grad = g
    loss_value, _, _ = eng._loss(gather_batch(dev, eng._shard(i, 0)),
                                 eng._shard(v, 0), train=False)
    loss_value.backward()
    dist.all_reduce(eng._grad_flat)
    out["eval"] = {"loss": float(loss_value),
                   "grads": _np({k: p.grad for k, p in eng.params.items()})}

    eng = _engine(mesh, state_dict, "Adam", 4e-4)
    dev = eng.put_data(data)
    out["adam_losses"] = [float(eng.train_step(dev, b_idx, b_valid)["loss"])
                          for b_idx, b_valid in adam_batches]
    out["adam"] = _state(eng)
    bad = dict(dev)
    bad["flows"] = dev["flows"].clone()
    bad["flows"][nan_pair] = float("nan")
    m = eng.train_step(bad, idx, valid)
    out["nan"] = {"skipped": bool(m["skipped_nan"]), **_state(eng)}
    # a finite loss whose gradient is not finite on rank 1 alone
    hook = None
    if mesh.rank == 1:
        hook = eng.params["pred_layer.bias"].register_hook(
            lambda g: g * float("inf") * 0.0)
    m = eng.train_step(dev, idx, valid)
    if hook is not None:
        hook.remove()
    out["nan_grad"] = {"skipped": bool(m["skipped_nan"]),
                       "loss": float(m["loss"]), **_state(eng)}
    return out


# -- case 5: the epoch and the eval passes ----------------------------------
def epoch(mesh, data, state_dict, idx, valid, capture, eval_idx, eval_valid):
    """``train_epoch`` (Adam 4e-4) with capture slots, then the paired and
    the deduplicated eval passes, each from the same weights."""
    out = {}
    eng = _engine(mesh, state_dict, "Adam", 4e-4)
    dev = eng.put_data(data)
    out["train"] = _np(eng.train_epoch(dev, idx, valid, capture))
    out["train_state"] = _state(eng)
    for dedup in (False, True):
        eng = _engine(mesh, state_dict, "Adam", 4e-4, eval_dedup=dedup)
        dev = eng.put_data(data)
        name = "dedup" if dedup else "paired"
        out[name] = _np(eng.eval_epoch(dev, eval_idx, eval_valid))
        out[name + "_buffers"] = _np(dict(eng.model.net.named_buffers()))
    return out


# -- case 6: serving ---------------------------------------------------------
def serve(mesh, state_dict, frames, batch_size, bad_batch_size):
    from consistent_depth_tpu_torch.serving import DepthServer, ServeConfig

    server = DepthServer(ServeConfig(precision="f32", device="cpu",
                                     batch_size=batch_size, mesh=mesh),
                         model=port_model(state_dict))
    order = [k for k, _ in server.serve(
        (i, f) for i, f in enumerate(frames))]
    out = {"depth": server.infer_frames(frames), "order": order}
    try:
        DepthServer(ServeConfig(precision="f32", device="cpu",
                                batch_size=bad_batch_size, mesh=mesh),
                    model=port_model(state_dict))
        out["bad_batch_raised"] = False
    except ValueError:
        out["bad_batch_raised"] = True
    return out


# -- case 7: the CLI ------------------------------------------------------
def _drop_last_epoch(src, dst, tag_dir):
    """A copy of the dataset directory ``src`` as it stood after the first
    of two epochs: without what the second epoch and the final depth
    wrote under ``tag_dir`` (relative to the directory)."""
    shutil.copytree(src, dst)
    tag = os.path.join(dst, tag_dir)
    shutil.rmtree(os.path.join(tag, "checkpoints", "full_0002"))
    os.remove(os.path.join(tag, "checkpoints", "0002.pth"))
    shutil.rmtree(os.path.join(tag, "depth"))
    for f in os.listdir(os.path.join(tag, "eval")):
        if "_e0002_" in f:
            os.remove(os.path.join(tag, "eval", f))


def cli(mesh, path, argv, resumed, tag_dir, checkpoint_dir):
    """``cli.main.main`` under the mesh on ``path``, with the default
    checkpoints of ``checkpoint_dir``; then, on ``resumed``, a copy of it as
    after its first epoch (rank 0 makes it), the same command again, which
    resumes from that epoch. Returns both results and console outputs."""
    import contextlib
    import io

    from consistent_depth_tpu_torch.cli import main as cli_main

    os.environ["CDTPU_CHECKPOINT_DIR"] = checkpoint_dir

    out = []
    for p in (path, resumed):
        if p == resumed:
            if mesh.rank == 0:
                _drop_last_epoch(path, resumed, tag_dir)
            mesh.barrier()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = cli_main.main(["--path", p] + argv, device="cpu",
                                   mesh=mesh)
        out.append({"result": result, "stdout": buf.getvalue()})
    return out


CASES = {"mesh_functions": mesh_functions, "batch_norm": batch_norm,
         "loss": loss, "train_step": train_step, "epoch": epoch,
         "serve": serve, "cli": cli}
