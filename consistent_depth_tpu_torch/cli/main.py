"""CLI entry: the port of ``consistent_depth_tpu/cli/main.py`` (reference:
main.py). Runs the whole pipeline on the card:

    python -m consistent_depth_tpu_torch --video_file v.mp4 --path d ...

The flags are the JAX CLI's; there is no device flag, as there is none
there. A caller that wants the CPU calls :func:`main` with
``device="cpu"``. On N cards of one host, one process per card:

    torchrun --nproc_per_node N -m consistent_depth_tpu_torch ...

fine-tunes over a data mesh at N times ``--batch_size``; rank 0 runs the
other stages and writes every artifact (``pipeline.process``).
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(args: Optional[Sequence[str]] = None, device="cuda", mesh=None):
    from ..pipeline.process import DatasetProcessor
    from .params import Video3dParamsParser

    params = Video3dParamsParser().parse(args)
    processor = DatasetProcessor(device=device, mesh=mesh)
    try:
        return processor.process(params)
    finally:
        # a mesh joined here (under torchrun) is left here
        if mesh is None and processor.mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
