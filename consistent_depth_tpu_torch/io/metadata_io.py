"""Readers/writers for the small pipeline artifacts: the port's copy of
``consistent_depth_tpu/io/metadata_io.py`` (plain numpy).

Formats match the reference output tree exactly so the reference tooling
and the parity harness can consume our outputs unchanged:

- ``frames.txt``              (reference: video.py:91-97)
- ``metadata(_scaled).npz``   (reference: scale_calibration.py:186, 314-319)
- ``flow_list.json``          (reference: flow.py:84-86)
- ``scales.csv``              (reference: scale_calibration.py:292-296)
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class FramesTxt:
    frame_count: int
    width: int
    height: int
    pts: List[str]  # presentation timestamps as written by ffprobe


def read_frames_txt(path: str) -> FramesTxt:
    with open(path, "r") as f:
        lines = f.read().splitlines()
    n = int(lines[0])
    if len(lines) != n + 3:
        raise ValueError(f"frames.txt has wrong number of lines ({len(lines)})")
    return FramesTxt(
        frame_count=n, width=int(lines[1]), height=int(lines[2]),
        pts=lines[3:3 + n],
    )


def write_frames_txt(path: str, frames: FramesTxt) -> None:
    with open(path, "w") as f:
        f.write(f"{frames.frame_count}\n{frames.width}\n{frames.height}\n")
        for t in frames.pts:
            f.write(f"{t}\n")


def read_metadata(path: str) -> Dict[str, np.ndarray]:
    """{'intrinsics': (N,4), 'extrinsics': (N,3,4)[, 'scales': (M,2)]}"""
    with np.load(path) as meta:
        return {k: np.array(meta[k]) for k in meta.files}


def write_metadata(
    path: str, intrinsics: np.ndarray, extrinsics: np.ndarray,
    scales: Optional[np.ndarray] = None,
) -> None:
    data = {"intrinsics": intrinsics, "extrinsics": extrinsics}
    if scales is not None:
        data["scales"] = scales
    np.savez(path, **data)


def read_flow_list(path: str) -> List[Tuple[int, int]]:
    with open(path, "r") as f:
        return [tuple(pair) for pair in json.load(f)]


def write_flow_list(path: str, pairs: Sequence[Sequence[int]]) -> None:
    with open(path, "w") as f:
        json.dump([list(int(i) for i in p) for p in pairs], f)


def read_scales_csv(path: str) -> np.ndarray:
    """(M, 2) array of (frame_index, scale)."""
    scales = np.loadtxt(path, delimiter=",")
    return scales.reshape(-1, 2)


def write_scales_csv(path: str, scales: np.ndarray) -> None:
    np.savetxt(path, np.asarray(scales).reshape(-1, 2), delimiter=",")


def scales_to_map(scales: np.ndarray) -> Dict[int, float]:
    return {int(row[0]): float(row[1]) for row in np.asarray(scales).reshape(-1, 2)}
