"""PyTorch/CUDA port of consistent_depth_tpu for one NVIDIA H100.

Imports ``torch`` and never ``jax``, and nothing of the JAX package
beside it, which is the reference each module is tested against: the host
helpers the port needs are its own copies (``io.image_io``, ``utils``,
``data.video_dataset``, ``training.summaries``, the flow helpers in
``flow.backends``, the colour wheel in ``ops.flow_viz``). Entry points run
on the card unless the caller asks for the CPU. Ported so far:

- eval-mode MannequinChallenge depth serving (``serving``), whose k x k
  convs run through hand-written CUDA kernels (``ops.s2d_conv``:
  ``csrc/same_conv_tc.cu`` and ``csrc/same_conv_tf32.cu``, bf16 and f32
  on the tensor cores, and ``csrc/same_conv.cu`` on the FMA pipes for the
  shapes they do not take);
- the native flow path: FlowNet2 (``flow``), whose FlowNetC cost volume
  runs through a hand-written CUDA kernel (``flow.correlation``,
  ``csrc/correlation.cu``), and the flow stage (``pipeline.flow_stage``);
- the ``mc`` fine-tune stage (``training``): the train step and epoch, the
  eval passes, eval-mode inference, and the driver with its checkpoints,
  resume and artifacts; the k x k convs' grad-input runs through the same
  kernels;
- the pipeline and its command line (``cli``, ``pipeline.process``,
  ``python -m consistent_depth_tpu_torch``): the stage graph, video
  extraction and downscaling, the COLMAP driver, scale calibration, the flow
  and fine-tune stages and the video export, with the JAX CLI's flags and
  output tree.
"""
