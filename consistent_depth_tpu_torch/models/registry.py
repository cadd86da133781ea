"""Backbone registry: the port of ``consistent_depth_tpu/models/registry.py``
(reference: monodepth/depth_model_registry.py), with one backbone the JAX
package lacks: ``dav2-large``, Depth Anything V2-Large. Each adapter module
is imported when its backbone is asked for."""

from __future__ import annotations

from typing import List, Type

from .base import DepthModel


def get_depth_model_list() -> List[str]:
    return ["mc", "midas2", "monodepth2", "dav2-large"]


def get_depth_model(type: str) -> Type[DepthModel]:  # noqa: A002
    if type == "mc":
        from .mannequin_challenge import MannequinChallengeModel
        return MannequinChallengeModel
    if type == "midas2":
        from .midas_v2 import MidasV2Model
        return MidasV2Model
    if type == "monodepth2":
        from .monodepth2 import Monodepth2Model
        return Monodepth2Model
    if type == "dav2-large":
        from .depth_anything_v2 import DepthAnythingV2Model
        return DepthAnythingV2Model
    raise ValueError(f"Unsupported model type '{type}'.")


def create_depth_model(type: str, **kwargs) -> DepthModel:  # noqa: A002
    return get_depth_model(type)(**kwargs)
