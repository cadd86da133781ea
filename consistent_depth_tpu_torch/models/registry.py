"""Backbone registry: the port of ``consistent_depth_tpu/models/registry.py``.
Only ``mc`` is ported so far."""

from __future__ import annotations

from typing import Type

from .base import DepthModel


def get_depth_model(type: str) -> Type[DepthModel]:  # noqa: A002
    if type == "mc":
        from .mannequin_challenge import MannequinChallengeModel
        return MannequinChallengeModel
    if type in ("midas2", "monodepth2"):
        raise NotImplementedError(
            f"backbone '{type}' is not ported yet (ROADMAP.md, queue 1: "
            "'Other backbones')")
    raise ValueError(f"Unsupported model type '{type}'.")


def create_depth_model(type: str, **kwargs) -> DepthModel:  # noqa: A002
    return get_depth_model(type)(**kwargs)
