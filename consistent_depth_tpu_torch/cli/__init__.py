"""The command line of the port: ``python -m consistent_depth_tpu_torch``."""
