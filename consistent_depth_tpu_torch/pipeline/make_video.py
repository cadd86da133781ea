"""Comparison-video export.

Renders the reference's visualization videos (reference:
tools/make_video.py): a color video, one disparity video + gray/depth
overlay per depth source, and hstacked side-by-side comparisons. The
ffmpeg command lines are the output contract (identical videos); the
machinery here is organised around an :class:`FFmpeg` helper that owns
command construction + output caching, and a depth-source discovery
pass that validates frame counts up front.

This is the port's copy of ``consistent_depth_tpu/pipeline/make_video.py``:
plain host code, enabled in the pipeline only by ``--make_video``. Also a
standalone CLI: ``python -m consistent_depth_tpu_torch.pipeline.make_video``.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import subprocess
import sys
from os.path import join as pjoin
from typing import List, Optional, Sequence, Tuple


class MakeVideoParams:
    def __init__(self):
        self.parser = argparse.ArgumentParser(
            "Create videos from color and depth frames.")
        self.parser.add_argument("--color_dir", default="color_down_png")
        self.parser.add_argument("--depth_dirs", nargs="*")
        self.parser.add_argument("--out_dir")
        self.parser.add_argument("--ext", default=".mp4")
        self.parser.add_argument("--frame_fmt", default="frame_%06d.png")
        self.parser.add_argument("--video3d_dir", default=None)
        self.add_arguments(self.parser)

    @staticmethod
    def add_arguments(parser):
        parser.add_argument("--ffmpeg", default="ffmpeg",
                            help="path to the ffmpeg binary")


def count_frames(directory: str, ext: str) -> int:
    return sum(1 for fn in os.listdir(directory)
               if os.path.splitext(fn)[1] == ext)


def probe_frame_size(frame_fmt: str, index: int = 0) -> Tuple[int, int]:
    import cv2

    return cv2.imread(frame_fmt % index).shape[1::-1]


class FFmpeg:
    """Builds + runs the export's ffmpeg invocations. Every product is
    cached by output-file existence (rerunning the stage is free)."""

    def __init__(self, binary: str, ext: str = ".mp4", crf: int = 1):
        self.binary = binary
        self.ext = ext
        self.crf = crf

    def available(self) -> bool:
        return shutil.which(self.binary) is not None

    def _run(self, *args: str, out: str) -> str:
        if not os.path.isfile(out):
            print(subprocess.run(
                [self.binary, *args, out], check=True))
        return out

    def encode(self, frame_fmt: str, prefix: str,
               size: Optional[Tuple[int, int]] = None) -> str:
        """Frames -> libx264 video (r30, even-dim pad), plus a rescaled
        variant when the frames differ from ``size``."""
        out = self._run(
            "-r", "30", "-i", frame_fmt,
            "-vcodec", "libx264", "-pix_fmt", "yuv420p",
            "-crf", str(self.crf),
            "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
            out=prefix + self.ext)
        if size is not None and probe_frame_size(frame_fmt) != tuple(size):
            self._run(
                "-i", out, "-vf", "scale=%d:%d" % tuple(size),
                out=self._sized_name(prefix, size))
        return out

    def _sized_name(self, prefix: str, size) -> str:
        return f"{prefix}_{tuple(size)}{self.ext}"

    def _best_variant(self, prefix: str, size) -> str:
        """The rescaled file when it exists, else the original."""
        if size is not None:
            sized = self._sized_name(prefix, size)
            if os.path.isfile(sized):
                return sized
        return prefix + self.ext

    def hstack(self, prefixes: Sequence[str], out_dir: str,
               size=None) -> str:
        """Side-by-side comparison of already-encoded videos."""
        out = pjoin(out_dir,
                    "_".join(os.path.basename(p) for p in prefixes)
                    + self.ext)
        if os.path.isfile(out):
            return out
        cmd: List[str] = []
        for p in prefixes:
            cmd += ["-i", self._best_variant(p, size)]
        cmd += ["-filter_complex", f"hstack=inputs={len(prefixes)}",
                "-crf", str(self.crf)]
        return self._run(*cmd, out=out)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def discover_depth_sources(
    depth_dirs: Sequence[str], frame_ext: str, expected_frames: int
) -> List[Tuple[str, str]]:
    """Resolve each requested depth dir to (display name, frame dir),
    descending into a sole ``depth/`` subdirectory and dropping sources
    that are missing or have the wrong frame count."""
    sources = []
    for d in depth_dirs:
        if not os.path.isdir(d):
            logging.warning("[Warning] missing %s", d)
            continue
        if os.listdir(d) == ["depth"]:
            d = pjoin(d, "depth")
        found = count_frames(d, frame_ext)
        if found != expected_frames:
            logging.warning(
                "[Warning] %d vs. %d in %s", found, expected_frames, d)
            continue
        head, name = os.path.split(d)
        if name == "depth":
            name = os.path.basename(head)
        sources.append((name, d))
    return sources


def render_overlays(depth_fmt: str, color_fmt: str, out_fmt: str,
                    n: int) -> None:
    """Half-gray + half-depth blend frames (the reference's overlay
    look, tools/make_video.py:165-174)."""
    import cv2

    for i in range(n):
        color = cv2.imread(color_fmt % i)
        depth = cv2.imread(depth_fmt % i)
        if depth.shape != color.shape:
            depth = cv2.resize(depth, color.shape[1::-1])
        gray = cv2.cvtColor(color, cv2.COLOR_BGR2GRAY)[..., None]
        cv2.imwrite(out_fmt % i, gray / 2.0 + depth / 2.0)


# ---------------------------------------------------------------------------
# Export orchestration
# ---------------------------------------------------------------------------

def _resolve_paths(args):
    if args.video3d_dir is not None:
        args.color_dir = pjoin(args.video3d_dir, args.color_dir)
        args.depth_dirs = [pjoin(args.video3d_dir, d)
                           for d in args.depth_dirs]
        args.out_dir = pjoin(args.video3d_dir, args.out_dir)
    return args


def _export_depth_source(ff: FFmpeg, depth_fmt: str, color_fmt: str,
                         prefix: str, size, n: int) -> None:
    """Disparity video + overlay video + their side-by-side stack for
    one depth source."""
    ff.encode(depth_fmt, prefix, size=size)
    overlay_prefix = prefix + "-overlay"
    if not os.path.isfile(overlay_prefix + ff.ext):
        tmp_dir = prefix
        os.makedirs(tmp_dir, exist_ok=True)
        overlay_fmt = pjoin(tmp_dir, os.path.basename(depth_fmt))
        render_overlays(depth_fmt, color_fmt, overlay_fmt, n)
        ff.encode(overlay_fmt, overlay_prefix, size=size)
        shutil.rmtree(tmp_dir)
    ff.hstack([prefix, overlay_prefix],
              os.path.dirname(prefix), size=size)


def main(args) -> int:
    ff = FFmpeg(args.ffmpeg, ext=args.ext)
    if not ff.available():
        logging.warning(
            "ffmpeg not found; skipping video export (frames remain on disk)")
        return 0

    args = _resolve_paths(args)
    frame_ext = os.path.splitext(args.frame_fmt)[1]
    n = count_frames(args.color_dir, frame_ext)
    if n == 0:
        raise FileNotFoundError(
            f"no {frame_ext} frames in {args.color_dir} to make videos of")
    sources = discover_depth_sources(args.depth_dirs, frame_ext, n)

    color_fmt = pjoin(args.color_dir, args.frame_fmt)
    size = probe_frame_size(color_fmt)
    os.makedirs(args.out_dir, exist_ok=True)

    color_prefix = pjoin(args.out_dir, "color")
    ff.encode(color_fmt, color_prefix)

    depth_prefixes = []
    for name, depth_dir in sources:
        prefix = pjoin(args.out_dir, name)
        depth_prefixes.append(prefix)
        _export_depth_source(
            ff, pjoin(depth_dir, args.frame_fmt), color_fmt, prefix,
            size, n)

    if depth_prefixes:
        ff.hstack([color_prefix] + depth_prefixes, args.out_dir, size=size)
        with_overlays = [p for pre in depth_prefixes
                         for p in (pre, pre + "-overlay")]
        ff.hstack(with_overlays, args.out_dir, size=size)
    return 0


if __name__ == "__main__":
    sys.exit(main(MakeVideoParams().parser.parse_args()))
