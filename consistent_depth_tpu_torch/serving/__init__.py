"""Batched multi-video depth serving on one CUDA device."""

from .server import DepthServer, ServeConfig

__all__ = ["DepthServer", "ServeConfig"]
