"""Image IO: the port's copy of the readers and writers of
``consistent_depth_tpu/io/image_io.py`` that the port calls, the ``.raw``
float32 codec and the image loader with its resize to a target size.

The ``.raw`` format is the binary interchange format between the
pipeline's stages (depth maps, optical flow, downscaled colour), kept
bit-compatible with the reference's C++-compatible codec:

    int32   height
    int32   width
    int32   cv_type      (CV_32F=5, channels encoded as ``5 + ((d-1)<<3)``)
    uint64  pixel_size   (``4*d`` bytes)
    float32 payload, row-major (H, W, D)

Plain numpy (OpenCV and Pillow for the image files, imported where they
are used); the JAX package's optional native library is not used.
"""

from __future__ import annotations

import os
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


def resize_to_target(image, max_size, align=1, suppress_messages=True):
    """Resize so the long side is at most ``max_size``; round each dim to a
    multiple of ``align`` (reference: utils/image_io.py:26-49, INTER_AREA)."""
    import cv2

    H, W = image.shape[:2]
    scale = min(1.0, max_size / float(max(H, W)))
    rh, rw = int(H * scale), int(W * scale)
    if rw % align != 0:
        rw = align * round(rw / align)
    if rh % align != 0:
        rh = align * round(rh / align)
    if not suppress_messages:
        print(f"Resizing {W}x{H} -> {rw}x{rh} (align={align})")
    return cv2.resize(image, (rw, rh), interpolation=cv2.INTER_AREA)


def load_image(file_name, max_size=None, align=1, suppress_messages=True):
    """Load an image as float32 in [0, 1], correcting EXIF rotation
    (reference: utils/image_io.py:54-95)."""
    img, _ = load_image_angle(
        file_name, max_size=max_size, align=align,
        suppress_messages=suppress_messages,
    )
    return img


def load_image_angle(
    file_name, max_size=None, min_size=None, angle=0, align=1,
    suppress_messages=True,
):
    import cv2
    from PIL import Image

    with Image.open(file_name) as img:
        exif = getattr(img, "_getexif", lambda: None)()
        if exif is not None:
            orient = dict(exif.items()).get(274)
            if orient == 8:
                angle = 90
            elif orient == 6:
                angle = 270
            elif orient == 3:
                angle = 180
        if angle != 0:
            img = img.rotate(angle, expand=True)
        out = np.float32(img) / 255.0

    if max_size is not None:
        if min_size is not None:
            out = cv2.resize(out, (max_size, min_size),
                             interpolation=cv2.INTER_AREA)
        else:
            out = resize_to_target(
                out, max_size, align=align, suppress_messages=suppress_messages
            )
    return out, angle


def save_image(file_name: str, image: np.ndarray) -> None:
    ext = os.path.splitext(file_name)[1].lower()
    if ext == ".raw":
        save_raw_float32_image(file_name, image)
    else:
        from PIL import Image

        arr = np.clip(255.0 * np.asarray(image), 0, 255).astype("uint8")
        Image.fromarray(arr).save(file_name)


def _main(argv=None):
    """Resize or convert one image: ``python -m
    consistent_depth_tpu_torch.io.image_io --input_image a.png
    --output_image b.raw [--max_size 768]`` (reference: image_io.py:190-200)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Resize/convert an image (.png/.jpg/.raw)")
    parser.add_argument("--input_image", type=str, required=True)
    parser.add_argument("--output_image", type=str, required=True)
    parser.add_argument("--max_size", type=int, default=768,
                        help="max size of the long image dimension")
    args, _ = parser.parse_known_args(argv)
    img = load_image(args.input_image, max_size=int(args.max_size))
    save_image(args.output_image, img)


if __name__ == "__main__":
    _main()
