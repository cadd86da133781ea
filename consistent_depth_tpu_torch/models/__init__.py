"""Depth backbones of the port (only ``mc`` so far)."""
