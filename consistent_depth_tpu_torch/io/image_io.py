"""The ``.raw`` float32 image codec: the port's copy of the readers and
writers of ``consistent_depth_tpu/io/image_io.py`` that the port calls.

The ``.raw`` format is the binary interchange format between the
pipeline's stages (depth maps, optical flow, downscaled colour), kept
bit-compatible with the reference's C++-compatible codec:

    int32   height
    int32   width
    int32   cv_type      (CV_32F=5, channels encoded as ``5 + ((d-1)<<3)``)
    uint64  pixel_size   (``4*d`` bytes)
    float32 payload, row-major (H, W, D)

Plain numpy; the JAX package's optional native library is not used.
"""

from __future__ import annotations

import struct

import numpy as np

_CV_32F = 5
_CV_CN_SHIFT = 3
_CV_CN_MAX = 512
_HEADER = struct.Struct("<iiiQ")


def load_raw_float32_image(file_name: str) -> np.ndarray:
    """Read a ``.raw`` float32 image. Returns (H, W) or (H, W, D)."""
    with open(file_name, "rb") as f:
        h, w, cv_type, pixel_size = _HEADER.unpack(f.read(_HEADER.size))
        d = ((cv_type - _CV_32F) >> _CV_CN_SHIFT) + 1
        if d < 1 or d != pixel_size // 4:
            raise ValueError(
                f"Incompatible pixel_size({pixel_size}) and cv_type({cv_type})"
            )
        if d > _CV_CN_MAX:
            raise ValueError("Cannot load image with more than 512 channels")
        data = np.frombuffer(f.read(), dtype=np.float32)
    return data.reshape(h, w) if d == 1 else data.reshape(h, w, d)


def save_raw_float32_image(file_name: str, image: np.ndarray) -> None:
    """Write a ``.raw`` float32 image ((H, W) or (H, W, D))."""
    image = np.ascontiguousarray(np.asarray(image, dtype=np.float32))
    if image.ndim == 2:
        h, w = image.shape
        d = 1
    else:
        h, w, d = image.shape
    if d > _CV_CN_MAX:
        raise ValueError("Cannot save image with more than 512 channels")
    cv_type = _CV_32F + ((d - 1) << _CV_CN_SHIFT)
    with open(file_name, "wb") as f:
        f.write(_HEADER.pack(h, w, cv_type, 4 * d))
        f.write(image.tobytes())
