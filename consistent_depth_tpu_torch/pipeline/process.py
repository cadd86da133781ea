"""Pipeline orchestrator: the port of
``consistent_depth_tpu/pipeline/process.py``, a declarative stage graph.

Behavioral contract (artifact tree, stage order, caching semantics)
matches the reference orchestrator (reference: process.py:38-121), but
the design is a small stage framework instead of one long method: each
:class:`Stage` declares a completion probe (``done``) next to its body,
the graph is data (``_build_graph``), and a shared :class:`PipelineState`
carries everything stages exchange. That makes the pipeline inspectable
(``describe()``), resumable per-stage, and gives every stage a uniform
banner + wall-clock report.

Output tree (identical to the reference):

    {path}/R{range}_{flow_ops}_{model}/...   per-config artifacts
    {path}/depth_{model}/depth/              initial depth
    {path}/flow_list.json                    filtered pair list

The device stages (initial depth, calibration, flow, masks and renders,
fine-tuning, final depth) run on the processor's ``device``: the card
unless the caller asks for the CPU.

Under a data mesh (``torchrun --nproc_per_node N -m
consistent_depth_tpu_torch ...``, or a mesh passed in), every rank builds
the fine-tuner on its own card and runs the fine-tune; every other stage
runs on rank 0 while the others wait at a barrier. Those stages are cached
on the filesystem, so the ranks that waited read what rank 0 wrote.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass, field
from os.path import join as pjoin
from typing import Callable, List, Optional, Tuple

import torch

from ..parallel.mesh import Mesh, launched_mesh
from ..training.fine_tuning import DepthFineTuner
from ..utils.frame_range import FrameRange, OptionalSet
from ..utils.helpers import print_banner, print_title
from . import make_video as mkvid
from .flow_stage import Flow
from .scale_calibration import calibrate_scale
from .video import Video, sample_pairs


@dataclass
class PipelineState:
    """Everything the stages read from / publish to each other."""

    params: object
    writer: object = None
    device: torch.device = torch.device("cuda")
    mesh: Optional[Mesh] = None
    path: str = ""
    out_dir: str = ""
    video: Optional[Video] = None
    flow: Optional[Flow] = None
    tuner: Optional[DepthFineTuner] = None
    frame_range: Optional[FrameRange] = None
    ft_frame_range: Optional[FrameRange] = None
    frame_pairs: list = field(default_factory=list)
    initial_depth_dir: str = ""

    @property
    def frames(self) -> List[int]:
        return self.frame_range.frames()


@dataclass
class Stage:
    """One cached pipeline step.

    ``done`` (optional) probes whether the stage's artifacts already
    exist; stages without a probe implement their own internal caching
    (every reference stage re-checks its outputs on entry). Under a mesh a
    stage runs on rank 0 alone, the others waiting at a barrier, unless it
    runs ``every_rank``.
    """

    name: str
    run: Callable[[PipelineState], None]
    done: Optional[Callable[[PipelineState], bool]] = None
    enabled: Callable[[PipelineState], bool] = lambda s: True
    every_rank: bool = False

    def execute(self, state: PipelineState) -> None:
        mesh = state.mesh
        if mesh is None or self.every_rank:
            self._execute(state)
            return
        if mesh.rank == 0:
            self._execute(state)
        mesh.barrier()

    def _execute(self, state: PipelineState) -> None:
        if not self.enabled(state):
            return
        print_banner(self.name)
        if self.done is not None and self.done(state):
            print(f"[{self.name}] outputs up to date, skipping.")
            return
        t0 = time.perf_counter()
        self.run(state)
        print(f"[{self.name}] finished in {time.perf_counter() - t0:.1f}s.")


# ---------------------------------------------------------------------------
# Stage bodies
# ---------------------------------------------------------------------------

def _extract_pts(s: PipelineState) -> None:
    s.video.extract_pts()


def _extract_frames(s: PipelineState) -> None:
    s.video.extract_frames()


def _downscale(column: str, size_of, fmt: str, align: int = 16):
    def run(s: PipelineState) -> None:
        s.video.downscale_frames(
            column, size_of(s), fmt,
            **({"align": align} if align != 16 else {}))
    return run


def _init_models(s: PipelineState) -> None:
    """Instantiate the fine-tuner (loads the pretrained backbone) and the
    frame range; cheap, never cached."""
    if s.video.frame_count is None:
        # a rank that waited while rank 0 extracted reads its frames.txt
        s.video.check_extracted_pts()
    s.frame_range = FrameRange(
        frame_range=s.params.frame_range.set,
        num_frames=s.video.frame_count)
    s.tuner = DepthFineTuner(s.out_dir, s.frames, s.params, device=s.device,
                             mesh=s.mesh)
    s.initial_depth_dir = pjoin(s.path, f"depth_{s.params.model_type}")


def _initial_depth(s: PipelineState) -> None:
    s.tuner.save_depth(s.initial_depth_dir)


def _calibrate(s: PipelineState) -> None:
    valid = calibrate_scale(s.video, s.out_dir, s.frame_range, s.params,
                            device=s.device)
    s.ft_frame_range = s.frame_range.intersection(OptionalSet(set(valid)))
    dropped = sorted(set(s.frames) - set(s.ft_frame_range.frames()))
    print("Filtered out frames", dropped)


def _compute_flow(s: PipelineState) -> None:
    s.frame_pairs = sample_pairs(s.ft_frame_range, s.params.flow_ops)
    s.flow.compute_flow(s.frame_pairs, s.params.flow_checkpoint)


def _flow_masks(s: PipelineState) -> None:
    s.flow.mask_valid_correspondences()


def _filter_pairs(s: PipelineState) -> None:
    flow_list = s.flow.check_good_flow_pairs(
        s.frame_pairs, s.params.overlap_ratio)
    shutil.copyfile(flow_list, pjoin(s.path, "flow_list.json"))


def _visualize_flow(s: PipelineState) -> None:
    s.flow.visualize_flow(warp=True)


def _fine_tune(s: PipelineState) -> None:
    s.tuner.fine_tune(writer=s.writer)


def _final_depth(s: PipelineState) -> None:
    s.tuner.save_depth(s.tuner.out_dir, s.frames)


def _export_videos(s: PipelineState) -> None:
    depth_dirs = [
        s.initial_depth_dir,
        pjoin(s.path, "depth_colmap_dense"),
        pjoin(s.tuner.out_dir, "depth"),
    ]
    gt = pjoin(s.path, "depth_gt")
    if os.path.isdir(gt):
        depth_dirs.append(gt)
    argv = ["--color_dir", pjoin(s.path, "color_down_png"),
            "--out_dir", pjoin(s.out_dir, "videos"),
            "--depth_dirs", *depth_dirs]
    vid_params = mkvid.MakeVideoParams().parser.parse_args(
        argv, namespace=s.params)
    import logging

    logging.info("Make videos %s", vid_params)
    mkvid.main(vid_params)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

class DatasetProcessor:
    """Runs the stage graph over one video dataset on ``device``, the card
    unless the caller asks for the CPU; without a CUDA device the default
    raises before anything is written. ``mesh``: the data mesh, by default
    one over the launcher's ranks when it started more than one; under a
    mesh the device is the mesh's."""

    def __init__(self, writer=None, device="cuda",
                 mesh: Optional[Mesh] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DatasetProcessor runs on the card and no CUDA device is "
                "available; pass device='cpu' to run the pipeline on the CPU")
        if mesh is None:
            mesh = launched_mesh(device)
        self.writer = writer
        self.mesh = mesh
        self.device = device if mesh is None else mesh.device

    # -- graph definitions -------------------------------------------------
    @staticmethod
    def _frames_graph() -> List[Stage]:
        # the probes reuse the stages' own idempotency checks (each body
        # re-checks on entry as well — the reference's model), so the
        # framework's uniform "outputs up to date" reporting covers them
        return [
            Stage("Extracting PTS", _extract_pts,
                  done=lambda s: s.video.check_extracted_pts()),
            Stage("Extracting frames", _extract_frames,
                  done=lambda s: s.video.check_frames(
                      pjoin(s.path, "color_full"), "png")),
        ]

    def _build_graph(self, params) -> List[Stage]:
        def downscaled(column, ext):
            return lambda s: s.video.check_frames(pjoin(s.path, column), ext)

        return self._frames_graph() + [
            Stage("Downscaling frames (raw)",
                  _downscale("color_down", lambda s: s.params.size, "raw"),
                  done=downscaled("color_down", "raw")),
            Stage("Downscaling frames (png)",
                  _downscale("color_down_png", lambda s: s.params.size, "png"),
                  done=downscaled("color_down_png", "png")),
            Stage("Downscaling frames (for flow)",
                  _downscale("color_flow", lambda s: Flow.max_size(), "png",
                             align=64),
                  done=downscaled("color_flow", "png")),
            Stage("Loading depth model", _init_models, every_rank=True),
            Stage("Compute initial depth", _initial_depth,
                  done=lambda s: s.video.check_frames(
                      pjoin(s.initial_depth_dir, "depth"), "raw")),
            Stage("Calibrating scale", _calibrate),
            Stage("Compute flow", _compute_flow),
            Stage("Compute flow masks", _flow_masks),
            Stage("Filter flow pairs", _filter_pairs,
                  done=lambda s: (
                      os.path.isfile(pjoin(
                          s.out_dir,
                          "flow_list_%.2f.json" % s.params.overlap_ratio))
                      and os.path.isfile(pjoin(s.path, "flow_list.json")))),
            Stage("Visualize flow", _visualize_flow),
            Stage("Fine-tuning", _fine_tune, every_rank=True),
            Stage("Compute final depth", _final_depth,
                  done=lambda s: s.video.check_frames(
                      pjoin(s.tuner.out_dir, "depth"), "raw", s.frames)),
            Stage("Export visualization videos", _export_videos,
                  enabled=lambda s: s.params.make_video),
        ]

    def describe(self, params) -> List[str]:
        """Stage names in execution order (introspection/debugging)."""
        return [st.name for st in self._build_graph(params)]

    # -- execution ----------------------------------------------------------
    @staticmethod
    def _config_dir_name(params) -> str:
        """R{range}_{flow_ops}_{model}, the per-config directory tag
        (reference: process.py:22-29)."""
        return "_".join([
            f"R{params.frame_range.name}",
            "-".join(params.flow_ops),
            params.model_type,
        ])

    def _make_state(self, params) -> PipelineState:
        path = params.path
        os.makedirs(path, exist_ok=True)
        out_dir = pjoin(path, self._config_dir_name(params))
        os.makedirs(out_dir, exist_ok=True)
        return PipelineState(
            params=params, writer=self.writer, device=self.device,
            mesh=self.mesh, path=path, out_dir=out_dir,
            video=Video(path, params.video_file),
            flow=Flow(path, out_dir, device=self.device),
        )

    def process(self, params) -> Optional[Tuple[str, str, List[int]]]:
        state = self._make_state(params)
        print_title(f"Processing dataset '{state.path}'")
        print(f"Output directory: {state.out_dir}")

        if params.op == "extract_frames":
            graph = self._frames_graph()
        elif params.op == "all":
            graph = self._build_graph(params)
        else:
            raise RuntimeError("Invalid operation specified.")

        for stage in graph:
            stage.execute(state)

        if params.op != "all":
            return None
        return state.initial_depth_dir, state.tuner.out_dir, state.frames
