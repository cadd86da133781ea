"""Frame subset selection algebra: the port's copy of
``consistent_depth_tpu/utils/frame_range.py`` (plain Python).

Semantics match the reference (utils/frame_range.py): an optional set of
frame indices ("None" = everything), intersected with the video's full
range, exposing a dense index <-> frame-id mapping. The canonical string form of a range
("0,2-6,8-10") names the output directory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Set


class OptionalSet:
    """A set where ``None`` means "unconstrained" (the universe)."""

    def __init__(self, set: Optional[Set[int]] = None):  # noqa: A002
        self.set = set

    def intersection(self, other: "OptionalSet") -> "OptionalSet":
        if self.set is None:
            return other
        if other.set is None:
            return self
        return OptionalSet(set=self.set.intersection(other.set))

    def __str__(self):
        return str(self.set)


class NamedOptionalSet(NamedTuple):
    name: str
    set: OptionalSet


class FrameRange:
    """Sorted frame subset with contiguous index <-> frame-id maps."""

    def __init__(self, frame_range: OptionalSet, num_frames: Optional[int] = None):
        full = OptionalSet(
            set=set(range(num_frames)) if num_frames is not None else None
        )
        self.update(frame_range.intersection(full))

    def update(self, frame_range: OptionalSet) -> None:
        assert frame_range.set is not None, (
            "FrameRange needs a concrete set; pass num_frames to bound it"
        )
        self.frame_range = frame_range
        frames = sorted(frame_range.set)
        self.index_to_frame = dict(enumerate(frames))
        self.frame_to_index = {f: i for i, f in enumerate(frames)}

    def intersection(self, other: OptionalSet) -> "FrameRange":
        return FrameRange(self.frame_range.intersection(other))

    def frames(self):
        return sorted(self.index_to_frame.values())

    def __len__(self):
        return len(self.index_to_frame)


def canonical_range_name(frames: Set[int]) -> str:
    """Compress a frame set into the canonical range string, e.g.
    {0,2,3,4,5,6,8,9,10} -> "0,2-6,8-10"."""
    out = []
    run_start = None
    prev = None
    for i in sorted(frames):
        if i < 0:
            raise ValueError("Frame indices must be non-negative.")
        if run_start is None:
            run_start = prev = i
            continue
        if i == prev + 1:
            prev = i
            continue
        out.append(str(run_start) if run_start == prev else f"{run_start}-{prev}")
        run_start = prev = i
    if run_start is not None:
        out.append(str(run_start) if run_start == prev else f"{run_start}-{prev}")
    return ",".join(out)


def parse_frame_range(frame_range_str: str) -> NamedOptionalSet:
    """Parse "1-10,15,21-40" into a NamedOptionalSet; empty string parses
    to the unconstrained set with an empty name."""
    if len(frame_range_str) == 0:
        return NamedOptionalSet(name="", set=OptionalSet())

    frames: Set[int] = set()
    for part in frame_range_str.split(","):
        bounds = [int(s) for s in part.split("-", maxsplit=1)]
        if len(bounds) == 1:
            frames.add(bounds[0])
        else:
            start, end = bounds
            if start > end:
                raise ValueError(f"Invalid sub-range '{part}'")
            frames.update(range(start, end + 1))

    return NamedOptionalSet(name=canonical_range_name(frames), set=OptionalSet(frames))
