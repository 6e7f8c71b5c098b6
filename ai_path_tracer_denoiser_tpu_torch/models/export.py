"""Model artifact loading (counterpart of models/export.py).

The deployable artifact is the JAX package's ``.npz``: the parameter and
BatchNorm-state trees flattened to ``params/<path>`` and
``bn_state/<path>`` arrays plus a JSON ``__meta__``.  It is plain numpy,
so the port reads it directly; conv weights stay HWIO.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import ModelOptions
from ..utils.device import resolve_device


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def params_from_numpy(params_np, bn_state_np, device=None):
    """Carry a parameter tree and its BatchNorm state, given as nested
    dicts of numpy arrays (e.g. the JAX package's trees converted with
    ``np.asarray``), into float32 tensors on ``device`` (default cuda)."""
    device = resolve_device(device)
    return _to_tensors(params_np, device), _to_tensors(bn_state_np, device)


def load_model(path: str, device=None) -> Tuple[Any, Any, Dict[str, Any]]:
    """Read (params, bn_state, meta) from an ``.npz`` artifact."""
    with np.load(path) as data:
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data else {})
        params_flat, state_flat = {}, {}
        for key in data.files:
            if key.startswith("params/"):
                params_flat[key[len("params/"):]] = data[key]
            elif key.startswith("bn_state/"):
                state_flat[key[len("bn_state/"):]] = data[key]
    params, bn_state = params_from_numpy(_unflatten(params_flat),
                                         _unflatten(state_flat), device)
    return params, bn_state, meta


def model_options_from_meta(meta: Dict[str, Any]) -> ModelOptions:
    """The ModelOptions a checkpoint was trained with (missing keys: the
    reference architecture; pre-``norm`` artifacts were all BatchNorm)."""
    return ModelOptions(
        widths=tuple(meta.get("widths", (32, 43, 57, 76, 101))),
        norm=meta.get("norm", "batch"))
