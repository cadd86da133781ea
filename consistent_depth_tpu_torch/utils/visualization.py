"""Depth visualisation: the port's copy of
``consistent_depth_tpu/utils/visualization.py`` (reference:
utils/visualization.py): ``visualize_depth``, ``visualize_depth_dir``,
``apply_mask`` and ``create_video``.

The magma colour map is carried as data, :data:`MAGMA_LUT`: the 256 BGR
entries with the reference's gamma-2.2 pass folded in, as the JAX
package's ``_magma_lut`` computes them from matplotlib (which the port does
not import). Applying the gamma to the LUT entries once and rounding with
``np.rint`` (cv2's round-half-to-even ``saturate_cast<uchar>``) gives the
same PNG pixels as the reference's per-frame float power. OpenCV is
imported only inside the functions.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys

import numpy as np

from ..io import image_io

# (256, 3) uint8 BGR magma with gamma 2.2 folded in, row-major
MAGMA_LUT = np.frombuffer(bytes.fromhex(
    "000000000000000000000000000000000000000000010000010000010000010000010000"
    "020000020000020000020000030000030000040000040000050000050001060001070001"
    "0700010800010900010a00010b01010c01010d01020e01020f0102100102110102120103"
    "1401031501031701041801041901041b01051c01051e01061f0106210106230107230108"
    "25010827010928010929010a2b010b2b010b2c010c2d010d2e010d2f010e30010f310110"
    "31011131011132011233011333011434011534011635011735011836011936011a36011a"
    "36011c37011c37011e37011e370220380221380222380223380224380226380227390228"
    "39022939022b39022c39032d39032f390330390331390332390334390336390337390439"
    "39043a39043c39043d39043f39044139044238054438054538054738054a38054b38054d"
    "38054e37055137065337065437065736065936065a36065d36065f350661350763350764"
    "34076734076a33076b33086e33087132087232087531087831087931097c31097e300981"
    "3009842f09852e0a892e0a8c2d0a8d2d0b912c0b922b0b952b0b992b0b9a2a0c9e2a0c9f"
    "290da3280da5270da8270daa270ead260eaf250fb3240fb52410b82310ba2311bc2211c0"
    "2212c22112c42113c72014c91f14cb1f15cd1e16cf1e17d31e17d51d19d71d19d91c1adb"
    "1c1cdb1c1cdd1c1edf1b1ee11b20e31b21e51a23e51a23e71a25ea1a27ea1a28ec1a2aec"
    "1a2bee1b2cee1b2ef01b30f01b31f21c33f21c35f21c37f41c38f41d3af41e3cf61e3ef6"
    "1e40f61f42f62044f82046f82149f8214bf8224cf8234efb2351fb2453fb2555fb2658fb"
    "275afb285dfb295efb2a61fb2b63fd2c66fd2d69fd2e6bfd2f6efd316ffd3172fd3375fd"
    "3478fd357bfd377efd3881fd3a82fd3b85fd3d89fd3e8cfd408ffd4192fd4394fd4597fd"
    "469afd499efb4ba1fb4ca5fb4ea6fb51aafb52adfb54b1fb57b5fb58b8fb5abafb5dbefb"
    "5fc2fb62c5f863c9f866cbf869cff86bd3f86ed7f871dbf872dff875e1f878e5f87beaf8"
    "7eeef681f2f684f4f687f8f6"
), dtype=np.uint8).reshape(256, 3)


def visualize_depth(depth, depth_min=None, depth_max=None):
    """Magma-coloured sqrt-scaled gamma-2.2 depth rendering (reference:
    utils/visualization.py:20-37). Returns a uint8 BGR image."""
    import cv2

    depth = np.asarray(depth)
    if depth_min is None:
        depth_min = np.nanmin(depth)
    if depth_max is None:
        depth_max = np.nanmax(depth)

    depth_scaled = (depth - depth_min) / (depth_max - depth_min)
    depth_scaled = np.clip(np.nan_to_num(depth_scaled), 0, 1) ** 0.5
    depth_u8 = np.uint8(depth_scaled * 255)
    return cv2.applyColorMap(depth_u8, MAGMA_LUT[:, None, :])


def visualize_depth_dir(
    src_dir: str, dst_dir: str, force: bool = False, extension: str = ".raw",
    min_percentile: float = 0, max_percentile: float = 100,
):
    """Render every depth map in a directory with a shared global range
    (reference: utils/visualization.py:40-101)."""
    import cv2

    src_files, dst_files = [], []
    for file in sorted(os.listdir(src_dir)):
        base, ext = os.path.splitext(file)
        if ext.lower() == extension:
            src_files.append(file)
            dst_files.append(f"{base}.png")
    if not src_files:
        return
    if not force and all(
        os.path.exists(os.path.join(dst_dir, f)) for f in dst_files
    ):
        return

    d_min, d_max = sys.float_info.max, -sys.float_info.max

    def read(fn):
        if extension == ".raw":
            return image_io.load_raw_float32_image(os.path.join(src_dir, fn))
        return cv2.imread(os.path.join(src_dir, fn))

    for fn in src_files:
        disparity = read(fn)
        ix = np.isfinite(disparity)
        if ix.sum() == 0:
            logging.warning("%s has 0 valid depth", fn)
            continue
        valid = disparity[ix].astype(np.float64)
        d_min = min(d_min, float(np.percentile(valid, min_percentile)))
        d_max = max(d_max, float(np.percentile(valid, max_percentile)))

    os.makedirs(dst_dir, exist_ok=True)
    for src, dst in zip(src_files, dst_files):
        dst_path = os.path.join(dst_dir, dst)
        if os.path.exists(dst_path) and not force:
            continue
        cv2.imwrite(dst_path, visualize_depth(read(src), d_min, d_max))


def apply_mask(im, mask, mask_color=None):
    """Highlight masked-out regions (reference:
    utils/visualization.py:115-124)."""
    im = np.asarray(im)
    im = im.reshape(im.shape[:2] + (-1,))
    C = im.shape[-1]
    mask = np.asarray(mask).reshape(mask.shape[:2] + (-1,)) > 0
    if mask_color is None:
        mask_color = np.array([0, 255, 0] if C == 3 else 1)
    mask_color = np.asarray(mask_color).reshape(1, 1, C)
    result = 0.7 * im + 0.3 * ((1 - mask) * mask_color)
    return result.squeeze()


def create_video(pattern: str, output_file: str, ffmpeg_bin: str = "ffmpeg"):
    """Encode the frames matching ``pattern`` into ``output_file`` at 30
    fps with ``ffmpeg_bin`` (H.264, crf 27); nothing when the file
    exists."""
    if not os.path.exists(output_file):
        cmd = [ffmpeg_bin, "-r", "30", "-i", pattern,
               "-c:v", "libx264", "-crf", "27", "-pix_fmt", "yuv420p",
               output_file]
        subprocess.call(cmd)
