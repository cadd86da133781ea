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

That key rule cannot spell FlowNet names: ``flownets_1 / conv3_1_0``
would become ``flownets.1.conv3.1.0``, not the module's
``flownets_1.conv3_1.0``. So for FlowNet the direction is reversed:
:func:`state_dict_for_module` starts from the port module's own keys and
maps each to its flax path with the JAX importer's rule (``_flax_path`` of
``consistent_depth_tpu/models/torch_import.py``), which is unambiguous;
:func:`checkpoint_for_module` does the same for a ``.pth``, so a released
checkpoint (``flownets_1.conv3_1.0.weight``) and one the JAX package wrote
(``flownets.1.conv3.1.0.weight``) both load.

The key rule spells monodepth2's keys as released (``encoder.layer1.0.conv1``,
``decoder.0.conv.conv``). MiDaS's decoder modules are flat in the JAX package
(``scratch_layer1_rn``, ``scratch_output_conv_0``), so its keys come out as
``scratch_layer1_rn.weight`` and ``scratch_output_conv.0.weight``;
:func:`released_midas_keys` respells them as released (``scratch.layer1_rn``,
``scratch.output_conv.0``), which the JAX package's MiDaS loader reads too.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

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


def released_midas_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A MiDaS state_dict in the released spelling: ``scratch_layer1_rn``,
    ``scratch_refinenet4`` and ``scratch_output_conv.0`` become
    ``scratch.layer1_rn``, ``scratch.refinenet4`` and
    ``scratch.output_conv.0`` (the reverse of the JAX loader's rewrite,
    ``consistent_depth_tpu/models/midas_v2.py:145-154``); released keys
    pass as they are."""
    return {("scratch." + k[len("scratch_"):]
             if k.startswith("scratch_") else k): v
            for k, v in state_dict.items()}


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


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor]
                    ) -> None:
    """Write ``state_dict`` as a ``.pth`` of CPU tensors, the layout that
    :func:`load_checkpoint`, the reference, and the JAX package's reader
    (``load_torch_checkpoint`` / ``state_dict_to_variables``, which drops
    ``num_batches_tracked``) all take."""
    torch.save({k: torch.as_tensor(v).detach().cpu().contiguous()
                for k, v in state_dict.items()}, path)


def flax_path(torch_key: str) -> Tuple[str, ...]:
    """'flownets.1.conv3.1.0.weight' and 'flownets_1.conv3_1.0.weight' ->
    ('flownets_1', 'conv3_1_0', 'weight'): alpha tokens grouped with the
    index tokens after them, the JAX importer's rule."""
    *tokens, leaf = torch_key.split(".")
    groups = []
    for tok in tokens:
        if tok.isdigit() and groups:
            groups[-1] += "_" + tok
        else:
            groups.append(tok)
    return tuple(groups) + (leaf,)


def _jax_leaf(params: Mapping[str, Any], path: Tuple[str, ...]) -> np.ndarray:
    *mods, leaf = path
    node = params
    for m in mods:
        node = node.get(m) if isinstance(node, Mapping) else None
    name = {"weight": "kernel", "bias": "bias"}.get(leaf)
    if not isinstance(node, Mapping) or name not in node:
        raise KeyError(f"no JAX leaf for {'/'.join(path)}")
    value = np.asarray(node[name])
    if name == "kernel":
        # conv HWIO -> OIHW; transposed conv (kh, kw, O, I) -> (I, O, kh, kw)
        value = value.transpose(3, 2, 0, 1)
    return value


def state_dict_for_module(variables: Mapping[str, Any],
                          module: nn.Module) -> Dict[str, np.ndarray]:
    """The JAX package's variables (numpy leaves) -> a state_dict with
    exactly ``module``'s keys (numpy values) for a module of convs and
    transposed convs: each key's kernel or bias is found at its flax path.
    Raises KeyError on a key with no leaf and ValueError on a shape
    mismatch."""
    params = variables.get("params", {})
    out: Dict[str, np.ndarray] = {}
    for key, t in module.state_dict().items():
        value = _jax_leaf(params, flax_path(key))
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{key}: JAX leaf {value.shape}, module "
                             f"{tuple(t.shape)}")
        out[key] = value
    return out


def checkpoint_for_module(state_dict: Mapping[str, torch.Tensor],
                          module: nn.Module) -> Dict[str, torch.Tensor]:
    """Re-key a checkpoint's ``state_dict`` to ``module``'s own keys by
    flax path, so that either spelling of a key loads. Keys the module
    lacks are ignored; a module key the checkpoint lacks raises KeyError."""
    by_path = {flax_path(k): v for k, v in state_dict.items()}
    missing = [k for k in module.state_dict() if flax_path(k) not in by_path]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the module's "
                       f"keys, e.g. {missing[:4]}")
    return {k: by_path[flax_path(k)] for k in module.state_dict()}
