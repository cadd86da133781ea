"""Frame subset selection algebra: the port's copy of
``consistent_depth_tpu/utils/frame_range.py`` (plain Python).

Semantics match the reference (utils/frame_range.py): an optional set of
frame indices ("None" = everything), intersected with the video's full
range, exposing a dense index <-> frame-id mapping. The range-string
parser comes with the CLI's slice.
"""

from __future__ import annotations

from typing import Optional, Set


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
