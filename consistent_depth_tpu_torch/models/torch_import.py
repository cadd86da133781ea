"""Weights carried across: the port's counterpart of
``consistent_depth_tpu/models/torch_import.py``.

The port's modules use the torch state_dict layout directly, so a released
``.pth`` loads as it is. :func:`state_dict_from_jax_variables` converts the
JAX package's ``{"params", "batch_stats"}`` tree (numpy leaves) into that
layout, with the same rules as the JAX package's ``variables_to_state_dict``:

    kernel (kh, kw, I, O)  ->  weight (O, I, kh, kw)
    scale / bias           ->  weight / bias
    mean / var             ->  running_mean / running_var
    seq_3 / list_0_1 / convs_1_3  ->  seq.3.list.0.1.convs.1.3
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_STRIP_PREFIXES = ("module.", "model.")


def _iter_leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _iter_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _torch_key(path, leaf: str) -> str:
    """('seq_3', 'list_0_1', 'uncertainty_layer_0'), 'weight' ->
    'seq.3.list.0.1.uncertainty_layer.0.weight'"""
    comps = []
    for comp in path:
        parts = comp.split("_")
        n_idx = 0
        while n_idx < len(parts) - 1 and parts[-1 - n_idx].isdigit():
            n_idx += 1
        comps.append("_".join(parts[:len(parts) - n_idx]))
        comps.extend(parts[len(parts) - n_idx:])
    return ".".join(comps + [leaf])


def state_dict_from_jax_variables(
        variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's variables (numpy leaves) -> a torch-layout
    state_dict of numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for path, value in _iter_leaves(variables.get("params", {})):
        *mods, leaf = path
        value = np.asarray(value)
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            out[_torch_key(mods, "weight")] = value
        elif leaf == "scale":
            out[_torch_key(mods, "weight")] = value
        else:
            out[_torch_key(mods, leaf)] = value
    for path, value in _iter_leaves(variables.get("batch_stats", {})):
        *mods, leaf = path
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        out[_torch_key(mods, name)] = np.asarray(value)
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` state_dict (optionally nested under "state_dict" and
    prefixed by DataParallel's "module.") onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and not isinstance(sd["state_dict"], torch.Tensor):
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        for pre in _STRIP_PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = torch.as_tensor(v)
    return out
