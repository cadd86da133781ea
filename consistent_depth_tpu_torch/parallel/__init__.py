"""Data parallelism: the port of ``consistent_depth_tpu/parallel``."""

from .mesh import (  # noqa: F401
    DATA_AXIS, Mesh, all_gather_batch, all_reduce_sum, launched_mesh,
    make_mesh, put_replicated, shard_batch)
