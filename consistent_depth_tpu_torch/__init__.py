"""PyTorch/CUDA port of consistent_depth_tpu for one NVIDIA H100.

Imports ``torch`` and never ``jax``. The JAX package beside it is the
reference each module is tested against. Ported so far: eval-mode
MannequinChallenge depth serving (``serving``), whose k x k convs run
through a hand-written CUDA kernel (``ops.s2d_conv``, ``csrc/same_conv.cu``).
"""
