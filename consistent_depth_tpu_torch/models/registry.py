"""Backbone registry: the port of ``consistent_depth_tpu/models/registry.py``.
The list names the JAX package's three backbones, so that the CLI takes the
same ``--model_type`` choices; only ``mc`` is ported so far, and building
another raises."""

from __future__ import annotations

from typing import List, Type

from .base import DepthModel


class _NotPorted(DepthModel):
    """A backbone of the JAX package that the port does not build yet: its
    requirements and defaults, which the CLI resolves its flags from, and
    no network."""

    name = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"backbone '{self.name}' is not ported yet (ROADMAP.md, queue 1: "
            "'Other backbones')")


class _MidasV2(_NotPorted):
    name = "midas2"
    align = 32
    learning_rate = 0.0001
    lambda_view_baseline = 0.0001


class _Monodepth2(_NotPorted):
    name = "monodepth2"
    align = 1
    learning_rate = 0.00004
    lambda_view_baseline = 1


def get_depth_model_list() -> List[str]:
    return ["mc", "midas2", "monodepth2"]


def get_depth_model(type: str) -> Type[DepthModel]:  # noqa: A002
    if type == "mc":
        from .mannequin_challenge import MannequinChallengeModel
        return MannequinChallengeModel
    if type == "midas2":
        return _MidasV2
    if type == "monodepth2":
        return _Monodepth2
    raise ValueError(f"Unsupported model type '{type}'.")


def create_depth_model(type: str, **kwargs) -> DepthModel:  # noqa: A002
    return get_depth_model(type)(**kwargs)
