"""Hierarchical frame-pair sampling: the port's copy of
``consistent_depth_tpu/utils/frame_sampling.py`` (plain Python).

This is the system's answer to long sequences: instead of O(N^2)
exhaustive pairs, sample pairs at power-of-two distances, O(N log N)
pairs total. Semantics match the reference (utils/frame_sampling.py):

- ``hierarchical``: for each level l with distance d=2^l, starts step by
  d; pairs (s, s±d) (two-way) / (s, s+d) (one-way).
- ``hierarchical2`` (pipeline default): same but starts step by
  max(1, d/2), i.e. include mid-points.
- ``consecutive``: distance-1 pairs only.
- ``exhausted``: all ordered (two-way) / upper-triangular (one-way) pairs.
"""

from __future__ import annotations

from collections import namedtuple
from enum import Enum, auto, unique
from math import ceil, floor, log2
from typing import (Any, Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Set, Tuple)

from .frame_range import FrameRange

Pair = namedtuple("Pair", ["first", "second"])
Pairs = Set[Pair]


@unique
class SamplePairsMode(Enum):
    EXHAUSTED = 0
    CONSECUTIVE = auto()
    HIERARCHICAL = auto()
    HIERARCHICAL2 = auto()

    @classmethod
    def name_mode_map(cls) -> Dict[str, "SamplePairsMode"]:
        return {v.name.lower(): v for v in cls}

    @classmethod
    def names(cls) -> List[str]:
        return [v.name.lower() for v in cls]


class SamplePairsOptions(NamedTuple):
    mode: SamplePairsMode
    params: Dict[str, Any] = {}


def sample_hierarchical(
    num_frames: int,
    two_way: bool,
    min_dist: int = 1,
    max_dist: Optional[int] = None,
    include_mid_point: bool = False,
) -> Pairs:
    assert min_dist >= 1
    if max_dist is None:
        max_dist = num_frames - 1
    if max_dist < 1:
        return set()
    min_level = ceil(log2(min_dist))
    max_level = floor(log2(max_dist))

    signs = (-1, 1) if two_way else (1,)
    pairs: Pairs = set()
    for level in range(min_level, max_level + 1):
        dist = 1 << level
        step = 1 << (max(0, level - 1) if include_mid_point else level)
        for start in range(0, num_frames, step):
            for sign in signs:
                end = start + sign * dist
                if 0 <= end < num_frames:
                    pairs.add(Pair(start, end))
    return pairs


def sample_hierarchical2(
    num_frames: int, two_way: bool,
    min_dist: int = 1, max_dist: Optional[int] = None,
) -> Pairs:
    return sample_hierarchical(
        num_frames, two_way, min_dist=min_dist, max_dist=max_dist,
        include_mid_point=True,
    )


def sample_consecutive(num_frames: int, two_way: bool) -> Pairs:
    return sample_hierarchical(num_frames, two_way, min_dist=1, max_dist=1)


def sample_exhausted(num_frames: int, two_way: bool) -> Pairs:
    pairs: Pairs = set()
    for i in range(num_frames):
        seconds = range(num_frames) if two_way else range(i + 1, num_frames)
        for j in seconds:
            if i != j:
                pairs.add(Pair(i, j))
    return pairs


_MODE_FUNCS = {
    SamplePairsMode.EXHAUSTED: sample_exhausted,
    SamplePairsMode.CONSECUTIVE: sample_consecutive,
    SamplePairsMode.HIERARCHICAL: sample_hierarchical,
    SamplePairsMode.HIERARCHICAL2: sample_hierarchical2,
}


class SamplePairs:
    """Pair-set construction over a FrameRange (reference:
    utils/frame_sampling.py:38-62)."""

    @classmethod
    def sample(
        cls,
        opts: Iterable[SamplePairsOptions],
        frame_range: FrameRange,
        two_way: bool = False,
    ) -> Pairs:
        num_frames = len(frame_range)
        rel_pairs: Pairs = set()
        for opt in opts:
            rel_pairs |= _MODE_FUNCS[opt.mode](num_frames, two_way, **opt.params)

        in_range = set(frame_range.frames())
        pairs: Pairs = set()
        for rel in rel_pairs:
            pair = Pair(
                frame_range.index_to_frame[rel[0]],
                frame_range.index_to_frame[rel[1]],
            )
            if pair[0] in in_range or pair[1] in in_range:
                pairs.add(pair)
        return pairs

    @classmethod
    def to_one_way(cls, pairs: Iterable[Sequence[int]]) -> Pairs:
        return {
            Pair(*sorted((p[0], p[1])))
            for p in pairs
        }


def to_in_range(
    pairs: Iterable[Sequence[int]],
    frame_range: Optional[Tuple[int, int]] = None,
):
    """Keep only pairs fully inside the half-open range [lo, hi)."""
    if frame_range is None:
        return pairs
    lo, hi = frame_range
    return [p for p in pairs if all(lo <= i < hi for i in p)]
