"""The data mesh: the port of ``consistent_depth_tpu/parallel/mesh.py``.

The JAX package runs data parallelism as one program over a 1-D device
mesh, axis ``"data"``: the pair batch is sharded over it, parameters,
optimizer state and the resident dataset are replicated, and XLA inserts
the ``psum`` of every global reduction. Here the mesh is N processes, one
per card, started by ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), and each global reduction is an
explicit collective:

- :func:`shard_batch` gives rank r the rows ``[r B/N, (r+1) B/N)`` of a
  batch axis, the block layout of ``P("data")``;
- :func:`all_gather_batch` is its inverse;
- :func:`put_replicated` broadcasts from rank 0, the replicated placement;
- :func:`all_reduce_sum` is the ``psum``, differentiable: its backward is
  the same sum all-reduce, so that gradients flow through globally reduced
  statistics (train-mode BN, the focal mean) as in the one program.

Everything is built on ``all_reduce``, ``broadcast`` and ``barrier``, the
collectives that NCCL on the card, gloo on the CPU and gloo on CUDA
tensors all carry; ``all_gather_batch`` is a sum all-reduce of a zero
buffer that holds the rank's slice, which is exact.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"

# how long a rank waits in a collective or a barrier: the pipeline's
# other ranks wait at a barrier while rank 0 runs its stages alone (flow,
# calibration, renders), which can take far longer than the collective
# libraries' defaults of 10-30 minutes
TIMEOUT = datetime.timedelta(hours=4)


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh over the started ranks, seen from one rank."""

    group: Any          # the torch.distributed process group
    rank: int
    size: int
    device: torch.device
    backend: str

    def barrier(self) -> None:
        """Wait until every rank of the mesh has arrived."""
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None, device=None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None) -> Mesh:
    """The mesh over every rank the launcher started, joined on first use.

    Args:
        n_devices: the number of ranks expected; None takes them all. A
            mesh spans every started rank, so any other count raises.
        device: this rank's device, ``cuda:{LOCAL_RANK}`` by default; the
            CPU only when asked for (``device="cpu"``).
        backend: NCCL on the card, gloo on the CPU by default. gloo on the
            card only when named: two ranks that share one card cannot use
            NCCL, which refuses a duplicate GPU.
        init_method: the rendezvous, ``env://`` (torchrun's
            ``MASTER_ADDR``/``MASTER_PORT``) by default.
    """
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices asked for, and {world} ranks "
            "were started (a mesh spans every started rank)")
    device = torch.device(f"cuda:{local}" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh runs on the card and no CUDA device is available; "
                "pass device='cpu' for a mesh on the CPU")
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world, timeout=TIMEOUT)
    elif (dist.get_backend() != backend or dist.get_world_size() != world
          or dist.get_rank() != rank):
        raise RuntimeError(
            f"the process group is already joined as {dist.get_backend()} "
            f"rank {dist.get_rank()} of {dist.get_world_size()}, not "
            f"{backend} rank {rank} of {world}")
    return Mesh(dist.group.WORLD, rank, world, device, backend)


def launched_mesh(device) -> Optional[Mesh]:
    """The mesh over the launcher's ranks when it started more than one
    (``WORLD_SIZE`` > 1, as under ``torchrun``), else None: on the card,
    ``cuda:{LOCAL_RANK}`` with NCCL, when ``device`` is a CUDA device;
    otherwise on ``device`` with gloo."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    device = torch.device(device)
    return make_mesh(device=None if device.type == "cuda" else device)


def _rows(mesh: Mesh, n: int, axis: int):
    if n % mesh.size:
        raise ValueError(f"a batch of {n} along axis {axis} does not split "
                         f"over {mesh.size} ranks")
    b = n // mesh.size
    return mesh.rank * b, b


def shard_batch(mesh: Mesh, x, axis: int = 0):
    """This rank's block of ``x`` (a tensor or a numpy array) along
    ``axis``: rows ``[r B/N, (r+1) B/N)``. B must be a multiple of N."""
    start, b = _rows(mesh, x.shape[axis], axis)
    index = [slice(None)] * x.ndim
    index[axis] = slice(start, start + b)
    return x[tuple(index)]


def all_gather_batch(mesh: Mesh, x: torch.Tensor,
                     axis: int = 0) -> torch.Tensor:
    """The blocks of every rank concatenated along ``axis`` in rank order,
    the inverse of :func:`shard_batch` (not differentiable): a sum
    all-reduce of a zero buffer that holds this rank's block."""
    shape = list(x.shape)
    b = shape[axis]
    shape[axis] = b * mesh.size
    wire = torch.uint8 if x.dtype == torch.bool else x.dtype
    out = torch.zeros(shape, dtype=wire, device=x.device)
    out.narrow(axis, mesh.rank * b, b).copy_(x)
    dist.all_reduce(out, group=mesh.group)
    return out.to(x.dtype)


def put_replicated(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite each tensor, in place, with rank 0's value: one broadcast
    of a flat buffer per dtype."""
    src = dist.get_global_rank(mesh.group, 0)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=src, group=mesh.group)
            torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in group]), group)])


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (the ``psum``); the gradient of each
    rank's input is the sum of the ranks' output gradients."""
    return _AllReduceSum.apply(x, mesh.group)
