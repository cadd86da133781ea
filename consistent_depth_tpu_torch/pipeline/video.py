"""Video frame extraction + multi-resolution downscaling: the port's copy
of ``consistent_depth_tpu/pipeline/video.py`` (reference: video.py).
ffmpeg/ffprobe run as host subprocesses; all stages are idempotent and
self-checking. Plain host code: nothing here runs on the card."""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from os.path import join as pjoin
from typing import Iterable, List, Optional

from ..io import image_io
from ..utils import frame_sampling
from ..utils.helpers import mkdir_ifnotexists

FFMPEG = "ffmpeg"
FFPROBE = "ffprobe"


def sample_pairs(frame_range, flow_ops: Iterable[str]):
    """Two-way pair sampling over the fine-tuning frame range
    (reference: video.py:18-28)."""
    name_mode_map = frame_sampling.SamplePairsMode.name_mode_map()
    opts = [
        frame_sampling.SamplePairsOptions(mode=name_mode_map[op])
        for op in flow_ops
    ]
    pairs = frame_sampling.SamplePairs.sample(
        opts, frame_range=frame_range, two_way=True)
    print(f"Sampled {len(pairs)} frame pairs.")
    return pairs


def require_binary(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        sys.exit(
            f"ERROR: '{name}' binary not found on PATH. Install it or "
            "pre-populate the corresponding pipeline stage outputs.")
    return path


class Video:
    def __init__(self, path: str, video_file: Optional[str] = None):
        self.path = path
        self.video_file = video_file
        self.frame_count: Optional[int] = None

    # -- PTS ------------------------------------------------------------
    def check_extracted_pts(self) -> bool:
        pts_file = pjoin(self.path, "frames.txt")
        if not os.path.exists(pts_file):
            return False
        with open(pts_file, "r") as f:
            lines = f.readlines()
        self.frame_count = int(lines[0])
        width, height = int(lines[1]), int(lines[2])
        print(f"{self.frame_count} frames detected ({width} x {height}).")
        if len(lines) != self.frame_count + 3:
            sys.exit("frames.txt has wrong number of lines")
        print("frames.txt exists, checked OK.")
        return True

    def extract_pts(self) -> None:
        if self.check_extracted_pts():
            return
        if not self.video_file or not os.path.exists(self.video_file):
            sys.exit(f"ERROR: input video file '{self.video_file}' not found.")
        require_binary(FFMPEG)
        require_binary(FFPROBE)

        # frame size from the first frame
        tmp = tempfile.mktemp(".png")
        subprocess.run(
            [FFMPEG, "-i", self.video_file, "-vframes", "1", tmp],
            capture_output=True)
        image = image_io.load_image(tmp)
        height, width = image.shape[:2]
        os.remove(tmp)

        # PTS via ffprobe
        res = subprocess.run(
            [FFPROBE, self.video_file, "-select_streams", "v:0",
             "-show_frames"],
            capture_output=True, text=True).stdout
        pts: List[str] = []
        for line in res.splitlines():
            for token in ("pkt_pts_time=", "pts_time="):
                if line.startswith(token):
                    pts.append(line[len(token):])
                    break
        self.frame_count = len(pts)
        print(f"{self.frame_count} frames detected.")

        with open(pjoin(self.path, "frames.txt"), "w") as f:
            f.write(f"{len(pts)}\n{width}\n{height}\n")
            for t in pts:
                f.write(f"{t}\n")
        self.check_extracted_pts()

    # -- frames ---------------------------------------------------------
    def check_frames(self, frame_dir: str, extension: str,
                     frames=None) -> bool:
        """(reference: video.py:101-124)"""
        if not os.path.isdir(frame_dir):
            return False
        # count only frame artifacts — a stray file (editor dropping,
        # preview image) must not fail the cache check with a
        # misleading count mismatch
        files = [n for n in os.listdir(frame_dir)
                 if re.fullmatch(r"frame_\d{6}\." + re.escape(extension), n)]
        if len(files) == 0:
            return False
        if frames is None:
            frames = range(self.frame_count)
        if len(files) != len(frames):
            sys.exit(
                f"ERROR: expected to find {len(frames)} files "
                f"but found {len(files)} in '{frame_dir}'")
        for i in frames:
            frame_file = pjoin(frame_dir, f"frame_{i:06d}.{extension}")
            if not os.path.exists(frame_file):
                sys.exit(f"ERROR: did not find expected file '{frame_file}'")
        print("Frames found, checked OK.")
        return True

    def extract_frames(self) -> None:
        frame_dir = pjoin(self.path, "color_full")
        mkdir_ifnotexists(frame_dir)
        if self.check_frames(frame_dir, "png"):
            return
        if not self.video_file or not os.path.exists(self.video_file):
            sys.exit(f"ERROR: input video file '{self.video_file}' not found.")
        require_binary(FFMPEG)
        subprocess.run(
            [FFMPEG, "-i", self.video_file, "-start_number", "0",
             "-vsync", "0", pjoin(frame_dir, "frame_%06d.png")],
            capture_output=True)
        count = len([n for n in os.listdir(frame_dir)
                     if re.fullmatch(r"frame_\d{6}\.png", n)])
        if count != self.frame_count:
            sys.exit(f"ERROR: {count} frames extracted, but "
                     f"{self.frame_count} PTS entries.")
        self.check_frames(frame_dir, "png")

    def downscale_frames(
        self, subdir: str, max_size: int, ext: str, align: int = 16,
        full_subdir: str = "color_full",
    ) -> None:
        """(reference: video.py:154-181). The stored .raw is the RGB
        swizzle of the loaded image (video.py:174)."""
        import cv2

        full_dir = pjoin(self.path, full_subdir)
        down_dir = pjoin(self.path, subdir)
        mkdir_ifnotexists(down_dir)
        if self.check_frames(down_dir, ext):
            return

        for i in range(self.frame_count):
            full_file = pjoin(full_dir, f"frame_{i:06d}.png")
            down_file = pjoin(down_dir, f"frame_{i:06d}.{ext}")
            image = image_io.load_image(
                full_file, max_size=max_size, align=align,
                suppress_messages=(i > 0))
            image = image[..., ::-1]  # channel swizzle
            if ext == "raw":
                image_io.save_raw_float32_image(down_file, image)
            else:
                cv2.imwrite(down_file, image * 255)
        self.check_frames(down_dir, ext)
