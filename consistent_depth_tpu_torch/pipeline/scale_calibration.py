"""Metric-scale calibration against COLMAP dense depth: the port of
``consistent_depth_tpu/pipeline/scale_calibration.py`` (reference:
scale_calibration.py:154-328), with the same artifacts:

    {path}/colmap_dense/metadata.npz            COLMAP poses (internal basis)
    {path}/depth_colmap_dense/depth/*.raw       inverse COLMAP depth (NaN = invalid)
    {out_dir}/depth_scaled_by_colmap_dense/     source depth / per-frame scale
    {out_dir}/scales.csv                        (frame, scale) rows
    {out_dir}/metadata_scaled.npz               translations / mean scale
    {out_dir}/vis_calibration_dense/            cross-warp sanity renders

A frame is calibratable when >= ``dense_pixel_ratio`` of its COLMAP
pixels are finite; only calibratable frames continue to fine-tuning.

The device work runs on ``device``: all frames' per-frame median ratios
and statistics come out of one call (:func:`batched_scale_stats`) and one
fetch, and the calibration renders warp whole chunks of frame pairs, with
their uint8 conversion on the device and the PNG writes of one chunk
overlapping the next chunk's work (``flow_stage._Fetch``).
"""

from __future__ import annotations

import logging
import os
from os.path import join as pjoin
from typing import Iterable, List, Set

import numpy as np
import torch

from ..io import colmap_io, image_io, metadata_io
from ..ops import geometry
from ..utils import visualization
from ..utils.helpers import print_banner
from .colmap_processor import COLMAPParams, COLMAPProcessor
from .flow_stage import _Fetch, _upload


class ScaleCalibrationParams:
    @staticmethod
    def add_arguments(parser):
        parser.add_argument(
            "--dense_frame_ratio", type=float, default=0.95,
            help="threshold on fraction of successfully computed dense "
                 "depth frames")
        parser.add_argument(
            "--dense_pixel_ratio", type=float, default=0.3,
            help="min ratio of valid dense-depth pixels for a frame to "
                 "be valid")


# ---------------------------------------------------------------------------
# Batched scale statistics
# ---------------------------------------------------------------------------

def batched_scale_stats(inv_src: torch.Tensor, inv_cmp: torch.Tensor):
    """Per-frame scale statistics for a stack of frames in one call.

    Args:
        inv_src: (N, H, W) source (monocular) inverse depth.
        inv_cmp: (N, H, W) COLMAP inverse depth, NaN where invalid.

    Returns:
        medians (N,), stds (N,), valid_ratio (N,): the median and the
        population std of the finite per-pixel ratios inv_src/inv_cmp of
        each frame, and the share of its pixels that are finite. The median
        of an even count is the mean of the two middle values, as numpy's
        and ``jnp.nanmedian``'s (``torch.nanmedian`` returns the lower
        one); a frame with no finite ratio gets NaN.
    """
    ratio = inv_src / inv_cmp                    # NaN propagates
    flat = ratio.reshape(ratio.shape[0], -1)
    finite = torch.isfinite(flat)
    n = finite.sum(dim=1)
    # ascending sort puts the NaNs (every non-finite ratio, infinities
    # included) after the n finite values of each row
    ordered = torch.sort(torch.where(finite, flat, torch.nan), dim=1).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=flat.shape[1] - 1)
    middle = torch.gather(ordered, 1, torch.stack((lo, hi), dim=1))
    medians = torch.where(n > 0, middle.mean(dim=1), torch.nan)
    count = torch.clamp(n, min=1).to(flat.dtype)
    mean = torch.where(finite, flat, 0.0).sum(dim=1) / count
    var = torch.where(finite, flat - mean[:, None], 0.0).square().sum(
        dim=1) / count
    valid_ratio = n.to(flat.dtype) / flat.shape[1]
    return medians, torch.sqrt(var), valid_ratio


# ---------------------------------------------------------------------------
# COLMAP reconstruction + conversion helpers
# ---------------------------------------------------------------------------

def prepare_colmap_color(video) -> str:
    """Return the color dir COLMAP should consume; when a dynamic-object
    mask exists, a blacked-out copy is rendered first (reference:
    scale_calibration.py:37-70)."""
    import cv2

    masks = pjoin(video.path, "mask_dynamic")
    source = pjoin(video.path, "color_full")
    if not os.path.isdir(masks):
        return source
    target = pjoin(video.path, "color_colmap_dense")
    if video.check_frames(target, "png"):
        return target

    os.makedirs(target, exist_ok=True)
    for i in range(video.frame_count):
        name = f"frame_{i:06d}.png"
        keep = (cv2.imread(pjoin(masks, name), 0) > 0)[..., None]
        cv2.imwrite(pjoin(target, name),
                    cv2.imread(pjoin(source, name)) * keep)
    if not video.check_frames(target, "png"):
        raise RuntimeError(f"masked COLMAP colour frames missing in {target}")
    return target


def _read_colmap_poses(path: str, sparse_dir: str):
    """COLMAP sparse model -> (intrinsics, extrinsics) rescaled to the
    depth resolution and converted to the internal camera basis."""
    if not COLMAPProcessor.check_sparse(sparse_dir):
        raise FileNotFoundError(
            f"No COLMAP sparse model in {sparse_dir} (expected cameras/"
            "images .bin or .txt). Either the COLMAP reconstruction "
            "failed upstream (check the log above; rerun without "
            "--colmap_keep_going to stop at the failing subcommand) or "
            "precomputed COLMAP output was not provided at this path.")
    cameras, images, _ = colmap_io.read_model(sparse_dir, ext=".bin")
    probe = image_io.load_raw_float32_image(
        pjoin(path, "color_down", "frame_000000.raw"))
    return colmap_io.convert_calibration(
        cameras, images, probe.shape[1::-1])


def _run_colmap_if_needed(video, args, colmap_dir: str) -> None:
    """Ensure {colmap_dir}/metadata.npz exists, reconstructing with the
    COLMAP binary when the dense model is absent."""
    meta_file = pjoin(colmap_dir, "metadata.npz")
    if os.path.isfile(meta_file):
        print("Checked metadata file exists.")
        return

    proc = COLMAPProcessor(
        args.colmap_bin_path,
        fail_fast=not getattr(args, "colmap_keep_going", False))
    color_dir = prepare_colmap_color(video)
    if not proc.check_dense(
            proc.dense_dir(colmap_dir, 0), color_dir,
            valid_ratio=args.dense_frame_ratio):
        cli = [color_dir, colmap_dir, "--dense_max_size", str(args.size)]
        mask_path = pjoin(video.path, "colmap_mask")
        if os.path.isdir(mask_path):
            cli[2:2] = ["--mask_path", mask_path]
        proc.process(COLMAPParams().parse_args(args=cli, namespace=args))

    intrinsics, extrinsics = _read_colmap_poses(
        video.path, proc.sparse_dir(colmap_dir, 0))
    metadata_io.write_metadata(meta_file, intrinsics, extrinsics)


def _missing_outputs(fmt: str, frames: Iterable[int]) -> List[int]:
    return [i for i in frames if not os.path.isfile(fmt.format(i))]


def _convert_colmap_depth(colmap_dir: str, frames: List[int],
                          out_fmt: str) -> None:
    """COLMAP .geometric.bin depth -> inverse-depth .raw with NaN for
    invalid (<= 0 / inf) pixels; idempotent per frame."""
    proc_suffix = COLMAPProcessor.dense_depth_suffix()
    src_fmt = pjoin(
        COLMAPProcessor.dense_dir(colmap_dir, 0), "stereo", "depth_maps",
        "frame_{:06d}.png" + proc_suffix)
    out_dir = os.path.dirname(out_fmt)

    todo = [i for i in _missing_outputs(out_fmt, frames)
            if os.path.isfile(src_fmt.format(i))]
    for i in _missing_outputs(out_fmt, frames):
        if not os.path.isfile(src_fmt.format(i)):
            logging.warning(
                "[SCALE CALIBRATION] %s does not exist.", src_fmt.format(i))
    if not todo:
        return

    os.makedirs(out_dir, exist_ok=True)
    for i in todo:
        with np.errstate(divide="ignore"):
            inv = 1.0 / colmap_io.read_array(src_fmt.format(i))
        inv[~np.isfinite(inv) | (inv < 0)] = np.nan
        image_io.save_raw_float32_image(out_fmt.format(i), inv)
    visualization.visualize_depth_dir(
        out_dir, out_dir, force=True, min_percentile=0, max_percentile=99)


# ---------------------------------------------------------------------------
# Per-frame scales
# ---------------------------------------------------------------------------

def _compute_scales(frames: List[int], cmp_fmt: str, src_fmt: str,
                    scaled_fmt: str, scales_file: str,
                    dense_pixel_ratio: float, device) -> np.ndarray:
    """Median inv-depth ratios for every frame with enough COLMAP
    coverage; writes scales.csv and the rescaled depth dumps. The
    statistics of ALL frames come from one device call and one fetch."""
    import cv2

    present = [i for i in frames if os.path.isfile(cmp_fmt.format(i))]
    for i in sorted(set(frames) - set(present)):
        logging.warning(
            "[SCALE CALIBRATION] %s does not exist", cmp_fmt.format(i))

    inv_src = np.stack(
        [image_io.load_raw_float32_image(src_fmt.format(i))
         for i in present]) if present else np.zeros((0, 1, 1), np.float32)
    hw = inv_src.shape[1:3][::-1]
    inv_cmp = np.stack(
        [cv2.resize(image_io.load_raw_float32_image(cmp_fmt.format(i)),
                    hw, interpolation=cv2.INTER_NEAREST)
         for i in present]) if present else inv_src

    with torch.inference_mode():
        stats = batched_scale_stats(*_upload((inv_src, inv_cmp),
                                             torch.device(device)))
        medians, stds, valid_ratio = _Fetch(stats).result()

    os.makedirs(os.path.dirname(scaled_fmt), exist_ok=True)
    rows = []
    for j, i in enumerate(present):
        if valid_ratio[j] < dense_pixel_ratio:
            continue
        print(f"Scale[{i}]: median={medians[j]}, std={stds[j]}")
        rows.append((float(i), float(medians[j])))
        image_io.save_raw_float32_image(
            scaled_fmt.format(i), inv_src[j] / medians[j])
    visualization.visualize_depth_dir(
        os.path.dirname(scaled_fmt), os.path.dirname(scaled_fmt), force=True)

    table = np.asarray(rows, np.float64).reshape(-1, 2)
    metadata_io.write_scales_csv(scales_file, table)
    return table


def _load_or_compute_scales(out_dir: str, video_path: str,
                            frames: List[int], args, device) -> np.ndarray:
    scaled_fmt = pjoin(
        out_dir, "depth_scaled_by_colmap_dense", "depth", "frame_{:06d}.raw")
    scales_file = pjoin(out_dir, "scales.csv")
    cmp_fmt = pjoin(
        video_path, "depth_colmap_dense", "depth", "frame_{:06d}.raw")
    src_fmt = pjoin(
        video_path, f"depth_{args.model_type}", "depth", "frame_{:06d}.raw")

    converted = [i for i in frames if os.path.isfile(cmp_fmt.format(i))]
    cached = (os.path.isfile(scales_file)
              and not _missing_outputs(scaled_fmt, converted))
    if cached:
        table = metadata_io.read_scales_csv(scales_file)
        if not (table.shape[0] >= len(frames) * args.dense_frame_ratio
                and table.shape[1] == 2):
            raise ValueError(
                f"scales shape is {table.shape} does not match "
                f"({len(frames)}, 2) with threshold {args.dense_frame_ratio}")
        print("Existing scales file loaded.")
        return table
    return _compute_scales(frames, cmp_fmt, src_fmt, scaled_fmt,
                           scales_file, args.dense_pixel_ratio, device)


# ---------------------------------------------------------------------------
# Calibration visualizations
# ---------------------------------------------------------------------------

def render_calibration(colors: torch.Tensor, depths: torch.Tensor,
                       extrinsics: torch.Tensor, intrinsics: torch.Tensor):
    """Each pair's two frames warped into each other's view.

    colors (B, 2, H, W, 3) in [0, 1], depths (B, 2, H, W), extrinsics
    (B, 2, 3, 4), intrinsics (B, 2, 4) -> (colours, warped) as uint8
    (B, 2, H, W, 3); warped[b, k] is the other frame seen from frame k."""
    B, _, H, W, C = colors.shape
    # frame 2b + k samples frame 2b + 1 - k
    tgt = [2 * b + 1 - k for b in range(B) for k in range(2)]
    warped = geometry.warp_image(
        colors.reshape(2 * B, H, W, C), depths.reshape(2 * B, H, W),
        extrinsics.reshape(2 * B, 3, 4), intrinsics.reshape(2 * B, 4), tgt)

    def u8(x):
        return torch.clamp(x * 255, 0, 255).to(torch.uint8)

    return u8(colors), u8(warped.reshape(B, 2, H, W, C))


def visualize_calibration_pair(
    extrinsics, intrinsics, depth_fmt, color_fmt, id_pair, vis_dir,
    device="cuda",
):
    """Depth-based cross-warp sanity render for one frame pair (reference:
    scale_calibration.py:84-121): each frame, and the other frame warped
    into its view on ``device``, as PNGs (levels rounded half to even, as
    ``cv2.imwrite`` rounds a float image). Does nothing when a depth file
    is missing."""
    import cv2

    from ..data.video_dataset import load_color

    if any(not os.path.isfile(depth_fmt.format(i)) for i in id_pair):
        return
    colors = np.stack([load_color(color_fmt.format(i)) for i in id_pair])
    depths = 1.0 / np.stack(
        [image_io.load_raw_float32_image(depth_fmt.format(i))
         for i in id_pair])
    with torch.inference_mode():
        inputs = _upload((colors, depths,
                          extrinsics[list(id_pair)].astype(np.float32),
                          intrinsics[list(id_pair)].astype(np.float32)),
                         torch.device(device))
        warped = geometry.warp_image(*inputs, [1, 0]).cpu().numpy()

    def u8(x):
        return np.rint(np.clip(x, 0, 1) * 255).astype(np.uint8)

    os.makedirs(vis_dir, exist_ok=True)
    for k, i in enumerate(id_pair):
        other = id_pair[1 - k]
        cv2.imwrite(pjoin(vis_dir, f"frame_{i:06d}.png"), u8(colors[k]))
        cv2.imwrite(
            pjoin(vis_dir, f"frame_{other:06d}_warped_to_{i:06d}.png"),
            u8(warped[k]))


def visualize_all_calibration(
    extrinsics, intrinsics, depth_fmt, color_fmt, frame_range, vis_dir,
    batch_pairs: int = 16, device="cuda",
):
    """Warp every frame to the first one and back (reference:
    scale_calibration.py:84-121, one pair at a time there): whole chunks
    of (frame, anchor) pairs warp in one call on ``device``; the PNG
    writes of a chunk overlap the next chunk's reads and device work."""
    import cv2

    from ..data.video_dataset import load_color

    anchor = frame_range.index_to_frame[0]
    todo = [frame_range.index_to_frame[k]
            for k in range(1, len(frame_range))]
    todo = [f for f in todo if os.path.isfile(depth_fmt.format(f))]
    if not todo or not os.path.isfile(depth_fmt.format(anchor)):
        return
    os.makedirs(vis_dir, exist_ok=True)
    device = torch.device(device)

    def write_out(chunk, fetch):
        colors_u8, warped_u8 = fetch.result()
        for b, f in enumerate(chunk):
            for k, i in enumerate((f, anchor)):
                other = (f, anchor)[1 - k]
                cv2.imwrite(pjoin(vis_dir, f"frame_{i:06d}.png"),
                            colors_u8[b, k])
                cv2.imwrite(
                    pjoin(vis_dir, f"frame_{other:06d}_warped_to_{i:06d}.png"),
                    warped_u8[b, k])

    pending = None
    for start in range(0, len(todo), batch_pairs):
        chunk = todo[start:start + batch_pairs]
        ids = [(f, anchor) for f in chunk]
        colors = np.stack([
            np.stack([load_color(color_fmt.format(i)) for i in pair])
            for pair in ids])
        depths = 1.0 / np.stack([
            np.stack([image_io.load_raw_float32_image(depth_fmt.format(i))
                      for i in pair])
            for pair in ids])
        extr = np.stack([extrinsics[list(pair)] for pair in ids]).astype(
            np.float32)
        intr = np.stack([intrinsics[list(pair)] for pair in ids]).astype(
            np.float32)
        with torch.inference_mode():
            inputs = _upload((colors, depths, extr, intr), device)
            fetch = _Fetch(render_calibration(*inputs), inputs)
        if pending is not None:
            write_out(*pending)
        pending = (chunk, fetch)
    if pending is not None:
        write_out(*pending)


# ---------------------------------------------------------------------------
# Stage entry point
# ---------------------------------------------------------------------------

def calibrate_scale(video, out_dir: str, frame_range, args,
                    device="cuda") -> Set[int]:
    """Full calibration stage; returns the set of calibratable frames
    (reference: scale_calibration.py:154-328)."""
    frames = frame_range.frames()
    colmap_dir = pjoin(video.path, "colmap_dense")

    print_banner("COLMAP reconstruction")
    _run_colmap_if_needed(video, args, colmap_dir)

    print_banner("Convert COLMAP depth maps")
    cmp_fmt = pjoin(
        video.path, "depth_colmap_dense", "depth", "frame_{:06d}.raw")
    _convert_colmap_depth(colmap_dir, frames, cmp_fmt)

    print_banner("Compute per-frame scales")
    table = _load_or_compute_scales(out_dir, video.path, frames, args, device)
    valid_frames = {int(f) for f in table[:, 0]}

    scaled_meta_file = pjoin(out_dir, "metadata_scaled.npz")
    if os.path.isfile(scaled_meta_file):
        print("Scaled metadata file exists.")
        return valid_frames

    scales = table[:, 1]
    mean_scale = scales.mean()
    print(f"[scales] mean={mean_scale}, std={np.std(scales)}")

    meta = metadata_io.read_metadata(pjoin(colmap_dir, "metadata.npz"))
    intrinsics, extrinsics = meta["intrinsics"], meta["extrinsics"]
    extrinsics[..., -1] /= mean_scale
    metadata_io.write_metadata(
        scaled_meta_file, intrinsics, extrinsics, scales=table)

    visualize_all_calibration(
        extrinsics, intrinsics,
        pjoin(out_dir, "depth_scaled_by_colmap_dense", "depth",
              "frame_{:06d}.raw"),
        pjoin(video.path, "color_down", "frame_{:06d}.raw"),
        frame_range, pjoin(out_dir, "vis_calibration_dense"), device=device)
    return valid_frames
