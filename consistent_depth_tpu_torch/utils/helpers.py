"""Console and filesystem conveniences of the pipeline stages: the port's
copy of ``consistent_depth_tpu/utils/helpers.py`` (mkdir -p, the banners
around stage transitions, which one ``_frame`` renderer draws, an
attribute-access dict, and a stdout gag for chatty callees)."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator


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


class dotdict(dict):
    """Mapping whose items are also readable/writable as attributes; a
    missing attribute reads as None."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            return None

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        del self[key]


@contextlib.contextmanager
def suppressed_stdout() -> Iterator[None]:
    """Swallow everything written to stdout inside the ``with`` block, to
    the null device rather than a buffer."""
    with open(os.devnull, "w") as devnull:
        with contextlib.redirect_stdout(devnull):
            yield
