"""Flow backends: the port's counterpart of
``consistent_depth_tpu/flow/backends.py``.

The host helpers are the port's own copies of the JAX module's numpy and
OpenCV code: the flow resize, the RANSAC homography and its composition
into a flow, the backend base class and the precomputed-flow backend.
OpenCV is imported inside the functions that use it.
:func:`create_flow_backend` picks the port's FlowNet2 backend.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from ..io import image_io


def resize_flow(flow: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """Resize a flow field and rescale its vectors
    (reference: optical_flow_flownet2_homography.py:229-239)."""
    import cv2

    H, W = flow.shape[:2]
    w, h = size_wh
    scaling = np.array([w / W, h / H], np.float32)
    resized = cv2.resize(flow, (w, h), interpolation=cv2.INTER_LINEAR)
    return resized * scaling


def align_homography(im1: np.ndarray, im2: np.ndarray,
                     min_matches: int = 10):
    """Estimate a homography registering im2 onto im1 via feature
    matching + RANSAC (first-party equivalent of the reference's
    SURF-based pre-alignment, optical_flow_flownet2_homography.py:66-107;
    SIFT replaces the patented SURF).

    Returns (H 3x3 or None, im2 warped onto im1's frame)."""
    import cv2

    def to_u8(im):
        im = np.asarray(im)
        if im.dtype != np.uint8:
            im = np.uint8(np.clip(im, 0, 1) * 255)
        if im.ndim == 3:
            im = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
        return im

    g1, g2 = to_u8(im1), to_u8(im2)
    sift = cv2.SIFT_create()
    k1, d1 = sift.detectAndCompute(g1, None)
    k2, d2 = sift.detectAndCompute(g2, None)
    if d1 is None or d2 is None or len(k1) < min_matches or len(k2) < min_matches:
        return None, im2

    matcher = cv2.BFMatcher()
    raw = matcher.knnMatch(d2, d1, k=2)
    good = [m for m, n in raw if m.distance < 0.75 * n.distance]
    if len(good) < min_matches:
        return None, im2
    pts2 = np.float32([k2[m.queryIdx].pt for m in good]).reshape(-1, 1, 2)
    pts1 = np.float32([k1[m.trainIdx].pt for m in good]).reshape(-1, 1, 2)
    H, _status = cv2.findHomography(pts2, pts1, cv2.RANSAC, 4.0)
    if H is None:
        return None, im2
    h, w = np.asarray(im1).shape[:2]
    warped = cv2.warpPerspective(np.asarray(im2), H, (w, h))
    return H, warped


def compose_homography_flow(flow: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Un-warp a flow computed against a homography-aligned frame2 back
    into raw-frame2 coordinates (reference:
    optical_flow_flownet2_homography.py:201-224): target point p2' in
    the aligned frame maps through H^-1 to frame2."""
    import cv2

    h, w = flow.shape[:2]
    X, Y = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    tgt = np.stack([X + flow[..., 0], Y + flow[..., 1]], axis=-1)
    Hinv = np.linalg.inv(H)
    tgt_h = cv2.perspectiveTransform(
        tgt.reshape(-1, 1, 2), Hinv).reshape(h, w, 2)
    out = tgt_h - np.stack([X, Y], axis=-1)
    return out.astype(np.float32)


class FlowBackend:
    name = "base"

    def process_pairs(self, frame_dir: str, pairs: Sequence[Tuple[int, int]],
                      out_fmt: str, out_size: Tuple[int, int]) -> None:
        raise NotImplementedError


class PrecomputedFlowBackend(FlowBackend):
    """Flow files are expected as inputs; this backend verifies and
    resizes them to the depth resolution if a source directory with
    full-resolution flow exists (flow_full/)."""

    name = "precomputed"

    def process_pairs(self, frame_dir, pairs, out_fmt, out_size):
        src_fmt = os.path.join(
            os.path.dirname(os.path.dirname(out_fmt)),
            "flow_full", "flow_{:06d}_{:06d}.raw")
        missing = []
        for (i, j) in pairs:
            out_fn = out_fmt.format(i, j)
            if os.path.isfile(out_fn):
                continue
            src_fn = src_fmt.format(i, j)
            if os.path.isfile(src_fn):
                flow = image_io.load_raw_float32_image(src_fn)
                image_io.save_raw_float32_image(
                    out_fn, resize_flow(flow, out_size))
            else:
                missing.append((i, j))
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} flow files missing (e.g. "
                f"{out_fmt.format(*missing[0])}). FlowNet2 weights/CUDA "
                "ops are external inputs; precompute flow with the "
                "reference tooling or provide flow_full/.")


def create_flow_backend(checkpoint: str = "FlowNet2",
                        device="cuda") -> FlowBackend:
    """``checkpoint`` names follow the reference CLI ('FlowNet2',
    'FlowNet2-KITTI'). If ``<dir>/<name lowercased>.pth`` exists, with
    ``<dir>`` the checkpoint cache ``./checkpoints`` or
    ``$CDTPU_CHECKPOINT_DIR``, FlowNet2 runs it on ``device`` (with the
    homography pre-alignment except for the KITTI model, reference
    flow.py:97-98); otherwise flow is a precomputed input."""
    name = checkpoint.lower()
    ckpt_dir = os.environ.get("CDTPU_CHECKPOINT_DIR", "checkpoints")
    ckpt_path = os.path.join(ckpt_dir, f"{name}.pth")
    if os.path.isfile(ckpt_path):
        from .runner import TorchFlowBackend

        return TorchFlowBackend(checkpoint=ckpt_path,
                                homography="kitti" not in name,
                                device=device)
    return PrecomputedFlowBackend()
