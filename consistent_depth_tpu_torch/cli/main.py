"""CLI entry: the port of ``consistent_depth_tpu/cli/main.py`` (reference:
main.py). Runs the whole pipeline on the card:

    python -m consistent_depth_tpu_torch --video_file v.mp4 --path d ...

The flags are the JAX CLI's; there is no device flag, as there is none
there. A caller that wants the CPU calls :func:`main` with
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(args: Optional[Sequence[str]] = None, device="cuda"):
    from ..pipeline.process import DatasetProcessor
    from .params import Video3dParamsParser

    params = Video3dParamsParser().parse(args)
    return DatasetProcessor(device=device).process(params)


if __name__ == "__main__":
    main()
