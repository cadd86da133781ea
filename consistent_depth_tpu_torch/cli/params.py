"""CLI flag surface: the port of ``consistent_depth_tpu/cli/params.py``.

The *flag contract* (names, defaults, choices, the kitti preset, and
the model-default resolution of align / learning-rate / λ-view) mirrors
the reference CLI (reference: params.py) so command lines are portable;
the implementation here is a declarative flag table composed with the
per-stage ``add_arguments`` hooks.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence

from ..models.registry import get_depth_model, get_depth_model_list
from ..pipeline.colmap_processor import COLMAPParams
from ..pipeline.make_video import MakeVideoParams
from ..pipeline.scale_calibration import ScaleCalibrationParams
from ..training.fine_tuning import DepthFineTuningParams
from ..utils import frame_range, frame_sampling

# Top-level flags as a declarative table: (name, argparse kwargs).
# Stage-owned flags (COLMAP, calibration, fine-tune, export) are
# contributed by the stage classes themselves below.
_TOP_LEVEL_FLAGS: List = [
    ("--op", dict(choices=["all", "extract_frames"], default="all")),
    ("--path", dict(
        type=str,
        help="Directory where all inputs (except the video) and outputs "
             "are stored.")),
    ("--video_file", dict(
        type=str,
        help="Path to the input video. Ignored if color_full and "
             "frames.txt already exist.")),
    ("--configure", dict(choices=["default", "kitti"], default="default")),
    # depth-map geometry
    ("--size", dict(
        type=int, default=384,
        help="Long dimension of the output depth maps.")),
    ("--align", dict(
        type=int, default=0,
        help="Alignment multiple of the depth size; <=0 resolves to the "
             "model requirement.")),
    # optical flow
    ("--flow_ops", dict(
        nargs="*", choices=frame_sampling.SamplePairsMode.names(),
        default=["hierarchical2"],
        help="Frame-pair sampling mode(s) for optical flow.")),
    ("--flow_checkpoint", dict(
        choices=["FlowNet2", "FlowNet2-KITTI"], default="FlowNet2")),
    ("--overlap_ratio", dict(type=float, default=0.2)),
    # backbone + fine-tune range
    ("--model_type", dict(
        type=str, choices=get_depth_model_list(), default="mc")),
    ("--frame_range", dict(
        default="", type=frame_range.parse_frame_range,
        help="Range of depth frames to fine-tune, e.g. 0,2-10,21-40.")),
    # export
    ("--make_video", dict(action="store_true")),
]

# The kitti preset (reference: params.py kitti branch): flag -> value,
# applied after parsing (overrides command-line values, like the
# reference; flags absent from the parse are skipped).
_KITTI_PRESET: Dict[str, Any] = {
    "flow_checkpoint": "FlowNet2-KITTI",
    "model_type": "monodepth2",
    "overlap_ratio": 0.5,
    "matcher": "sequential",
}

# Flags whose <=0 / <0 sentinel defaults resolve to the selected depth
# model's own requirements: flag -> (sentinel predicate, model attr).
_MODEL_RESOLVED: Dict[str, Any] = {
    "align": (lambda v: v <= 0, "align"),
    "learning_rate": (lambda v: v <= 0, "learning_rate"),
    "lambda_view_baseline": (lambda v: v < 0, "lambda_view_baseline"),
}


def build_parser() -> argparse.ArgumentParser:
    """Assemble the full ArgumentParser from the flag table plus every
    stage's contributed arguments."""
    parser = argparse.ArgumentParser()
    for name, kwargs in _TOP_LEVEL_FLAGS:
        parser.add_argument(name, **kwargs)
    for stage_params in (COLMAPParams, ScaleCalibrationParams,
                         DepthFineTuningParams, MakeVideoParams):
        stage_params.add_arguments(parser)
    return parser


def _apply_preset(params: argparse.Namespace) -> None:
    if params.configure != "kitti":
        return
    for key, value in _KITTI_PRESET.items():
        if hasattr(params, key):
            setattr(params, key, value)


def _resolve_model_defaults(params: argparse.Namespace) -> None:
    model = get_depth_model(params.model_type)
    for key, (is_sentinel, attr) in _MODEL_RESOLVED.items():
        if is_sentinel(getattr(params, key)):
            setattr(params, key, getattr(model, attr))


def _format_value(v: Any) -> str:
    if isinstance(v, frame_range.NamedOptionalSet):
        return f"'{v.name}'"
    return str(v)


def print_params(params: argparse.Namespace) -> None:
    print("------------ Parameters -------------")
    for key in sorted(vars(params)):
        print(f"{key}: {_format_value(getattr(params, key))}")
    print("-------------------------------------")


class Video3dParamsParser:
    """Parses the pipeline command line and resolves presets and
    model-dependent defaults (flag contract: reference params.py)."""

    def __init__(self):
        self.parser = build_parser()
        self.params: Optional[argparse.Namespace] = None

    def parse(self, args: Optional[Sequence[str]] = None,
              namespace: Optional[argparse.Namespace] = None):
        self.params = self.parser.parse_args(args, namespace=namespace)
        _apply_preset(self.params)
        _resolve_model_defaults(self.params)
        print_params(self.params)
        return self.params
