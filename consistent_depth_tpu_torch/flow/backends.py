"""Flow backends: the port's counterpart of
``consistent_depth_tpu/flow/backends.py``.

The host helpers (flow resize, the RANSAC homography and its composition
into a flow, the backend base class and the precomputed-flow backend)
import no JAX, so they are the JAX package's own, re-exported here.
:func:`create_flow_backend` picks the port's FlowNet2 backend.
"""

from __future__ import annotations

import os

from consistent_depth_tpu.flow.backends import (  # noqa: F401
    FlowBackend, PrecomputedFlowBackend, align_homography,
    compose_homography_flow, resize_flow)
from consistent_depth_tpu.io import image_io  # noqa: F401


def create_flow_backend(checkpoint: str = "FlowNet2",
                        device="cuda") -> FlowBackend:
    """``checkpoint`` names follow the reference CLI ('FlowNet2',
    'FlowNet2-KITTI'). If ``<dir>/<name lowercased>.pth`` exists, with
    ``<dir>`` the checkpoint cache ``./checkpoints`` or
    ``$CDTPU_CHECKPOINT_DIR``, FlowNet2 runs it on ``device`` (with the
    homography pre-alignment except for the KITTI model, reference
    flow.py:97-98); otherwise flow is a precomputed input."""
    name = checkpoint.lower()
    ckpt_dir = os.environ.get("CDTPU_CHECKPOINT_DIR", "checkpoints")
    ckpt_path = os.path.join(ckpt_dir, f"{name}.pth")
    if os.path.isfile(ckpt_path):
        from .runner import TorchFlowBackend

        return TorchFlowBackend(checkpoint=ckpt_path,
                                homography="kitti" not in name,
                                device=device)
    return PrecomputedFlowBackend()
