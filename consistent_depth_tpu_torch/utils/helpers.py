"""Console and filesystem conveniences of the pipeline stages: the port's
copy of ``consistent_depth_tpu/utils/helpers.py``, as far as
``pipeline/`` calls it (mkdir -p, and the banners around stage
transitions; one ``_frame`` renderer draws both banner styles)."""

from __future__ import annotations

import os


def mkdir_ifnotexists(path: str) -> None:
    """mkdir -p."""
    os.makedirs(path, exist_ok=True)


def _frame(text: str, char: str, sides: int) -> str:
    """Render ``text`` boxed above/below (and left/right when
    ``sides`` > 0) with ``char``."""
    pad = f"{char * sides}  " if sides else ""
    mid = f"{pad}{text}{pad[::-1]}"
    rule = char * len(mid)
    return f"\n{rule}\n{mid}\n{rule}\n"


def print_title(text: str) -> None:
    """Minor heading: a dashed rule above and below."""
    print(_frame(text, "-", sides=0))


def print_banner(text: str) -> None:
    """Major stage banner: starred box."""
    print(_frame(text, "*", sides=4))
