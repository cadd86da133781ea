"""Minimal dependency-free TensorBoard event writer: the port's copy of
``consistent_depth_tpu/training/summaries.py``.

The reference logs scalars/images/histograms through
torch.utils.tensorboard (depth_fine_tuning.py:66-127). This module
hand-encodes the TF event-file wire format (protobuf + TFRecord CRC) so
the port needs neither tensorflow nor tensorboard installed; files open
in standard TensorBoard, and hold the same bytes as the JAX package's
writer for the same events.
"""

from __future__ import annotations

import os
import struct
import time
import numpy as np

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f32(num: int, value: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", value)


def _f64(num: int, value: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", value)


def _vint(num: int, value: int) -> bytes:
    return _field(num, 0) + _varint(value)


def _bytes_field(num: int, data: bytes) -> bytes:
    return _field(num, 2) + _varint(len(data)) + data


def _str(num: int, s: str) -> bytes:
    return _bytes_field(num, s.encode("utf-8"))


class SummaryWriter:
    """Scalar/image/histogram writer with the SummaryWriter API subset
    the pipeline uses."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.cdtpu"
        self._f = open(os.path.join(log_dir, fname), "wb")
        self._write_event(_f64(1, time.time()) + _str(3, "brain.Event:2"))

    def _write_event(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc(event)))
        self._f.flush()

    def _emit(self, summary_value: bytes, step: int) -> None:
        summary = _bytes_field(1, summary_value)
        event = _f64(1, time.time()) + _vint(2, int(step)) + _bytes_field(5, summary)
        self._write_event(event)

    def add_scalar(self, tag: str, value, step: int) -> None:
        v = _str(1, tag) + _f32(2, float(value))
        self._emit(v, step)

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: (3, H, W) or (H, W, 3) float [0,1] or uint8."""
        import cv2

        img = np.asarray(image)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = img.transpose(1, 2, 0)
        if img.dtype != np.uint8:
            img = np.uint8(np.clip(img, 0, 1) * 255)
        ok, png = cv2.imencode(".png", img[..., ::-1] if img.ndim == 3 else img)
        assert ok
        h, w = img.shape[:2]
        # Summary.Image: height=1, width=2, colorspace=3, data=4
        im_msg = (_vint(1, h) + _vint(2, w) + _vint(3, 3)
                  + _bytes_field(4, png.tobytes()))
        v = _str(1, tag) + _bytes_field(4, im_msg)
        self._emit(v, step)

    def add_histogram(self, tag: str, values, step: int, bins: int = 30) -> None:
        arr = np.asarray(values, np.float64).ravel()
        if arr.size == 0:
            return
        counts, edges = np.histogram(arr, bins=bins)
        # HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5
        #   bucket_limit=6 (packed) bucket=7 (packed)
        limits = edges[1:]
        msg = (_f64(1, float(arr.min())) + _f64(2, float(arr.max()))
               + _f64(3, float(arr.size)) + _f64(4, float(arr.sum()))
               + _f64(5, float((arr ** 2).sum())))
        msg += _bytes_field(6, b"".join(struct.pack("<d", x) for x in limits))
        msg += _bytes_field(7, b"".join(struct.pack("<d", float(c))
                                        for c in counts))
        v = _str(1, tag) + _bytes_field(5, msg)
        self._emit(v, step)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_image_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
                    normalize: bool = False) -> np.ndarray:
    """(N, H, W, C) -> single (H', W', C) grid image (torchvision
    make_grid equivalent for logging)."""
    images = np.asarray(images, np.float32)
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-12)
    N, H, W, C = images.shape
    ncol = (N + nrow - 1) // nrow
    grid = np.zeros((ncol * (H + pad) + pad, nrow * (W + pad) + pad, C),
                    np.float32)
    for n in range(N):
        r, c = divmod(n, nrow)
        y, x = r * (H + pad) + pad, c * (W + pad) + pad
        grid[y:y + H, x:x + W] = images[n]
    return grid
