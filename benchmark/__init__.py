"""The benchmark of the PyTorch/CUDA port (``consistent_depth_tpu_torch``):
``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See README.md."""
