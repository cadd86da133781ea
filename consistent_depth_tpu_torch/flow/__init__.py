"""Native optical flow: FlowNet2 on the card, with the FlowNetC cost
volume through a hand-written CUDA kernel (``flow.correlation``)."""

from .backends import (FlowBackend, PrecomputedFlowBackend,
                       create_flow_backend)

__all__ = ["FlowBackend", "PrecomputedFlowBackend", "create_flow_backend"]
