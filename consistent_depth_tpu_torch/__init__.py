"""PyTorch/CUDA port of consistent_depth_tpu for one NVIDIA H100.

Imports ``torch`` and never ``jax``. The JAX package beside it is the
reference each module is tested against; of it, the port imports only
three host modules that load no JAX (``flow.backends``, ``io.image_io``,
``ops.flow_viz``). Ported so far:

- eval-mode MannequinChallenge depth serving (``serving``), whose k x k
  convs run through a hand-written CUDA kernel (``ops.s2d_conv``,
  ``csrc/same_conv.cu``);
- the native flow path: FlowNet2 (``flow``), whose FlowNetC cost volume
  runs through a hand-written CUDA kernel (``flow.correlation``,
  ``csrc/correlation.cu``), and the flow stage (``pipeline.flow_stage``).
"""
