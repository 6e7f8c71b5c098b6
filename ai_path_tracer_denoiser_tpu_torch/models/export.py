"""Model artifact (de)serialization (counterpart of models/export.py).

The deployable artifact is the JAX package's ``.npz``: the parameter and
BatchNorm-state trees flattened to ``params/<path>`` and
``bn_state/<path>`` arrays plus a JSON ``__meta__``.  It is plain numpy,
so either package reads what the other wrote; conv weights stay HWIO.
``train_state_from_numpy`` / ``train_state_to_numpy`` carry a whole train
state (parameters, BatchNorm statistics, Adam moments) across in the JAX
package's leaf order.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import ModelOptions
from ..utils.device import resolve_device


def _flatten(tree, prefix=""):
    """Nested dict of tensors/arrays -> {"a/b/c": numpy array}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = (tree.detach().cpu().numpy()
                            if isinstance(tree, torch.Tensor) else np.asarray(tree))
    return out


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


def save_model(path: str, params, bn_state, meta: Dict[str, Any] = None,
               options=None):
    """Write params + bn state + metadata to ``path`` (.npz).

    Pass ``options`` (ModelOptions) to record the architecture (widths and
    norm) in the metadata: loaders must know the norm to route batch-norm
    models through the BN-folding deployment path and group-norm ones
    through the eval graph.
    """
    meta = dict(meta or {})
    if options is not None:
        meta.setdefault("widths", list(options.widths))
        meta.setdefault("norm", options.norm)
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"bn_state/{k}": v for k, v in _flatten(bn_state).items()})
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def model_options_from_params(params, norm: str = "batch") -> ModelOptions:
    """ModelOptions from parameter shapes: the checkpoint itself is the
    source of truth for the channel plan.  ``norm`` is not recoverable
    from shapes (batch and group share one scale/bias tree)."""
    widths = tuple(int(params[f"enc{i}"]["conv1"]["w"].shape[-1])
                   for i in range(1, 6))
    return ModelOptions(widths=widths, norm=norm)


# ---------------------------------------------------------------------------
# Train state across packages
# ---------------------------------------------------------------------------
# The JAX trainer's optimiser state is Adam with injected hyper-parameters;
# its leaves in tree order (what ``opt/<i>`` of a checkpoint holds) are
#   0 count (int32)        1 b1   2 b2   3 eps   4 eps_root   5 learning_rate
#   6 adam's own count (int32)
#   7 .. 7+P-1   mu, one leaf per parameter leaf
#   7+P .. 7+2P-1  nu
# with the P parameter leaves in sorted-key order at every level of the tree
# (``sorted_leaves``), which is how jax flattens a dict.
OPT_HEADER = 7
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def sorted_leaves(tree, prefix=()):
    """[(path tuple, leaf)] of a nested dict in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(sorted_leaves(tree[k], prefix + (k,)))
    return out


def tree_from_leaves(template, leaves):
    """The nested dict shaped like ``template`` whose leaves, in sorted-key
    order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        built = {k: build(node[k]) for k in sorted(node)}
        return {k: built[k] for k in node}

    return build(template)


def train_state_from_numpy(params_np, bn_state_np, opt_leaves_np, step, lr,
                           device=None):
    """A train state of the JAX package as the port's ``TrainState``.

    ``params_np`` / ``bn_state_np``: nested dicts of numpy arrays;
    ``opt_leaves_np``: the optimiser state's leaves in the order above
    (``jax.tree_util.tree_leaves(state.opt_state)``), or None for fresh
    zero moments; ``step`` and ``lr`` scalars.
    """
    from ..train.trainer import TrainState, init_opt_state
    device = resolve_device(device)
    params, bn_state = params_from_numpy(params_np, bn_state_np, device)
    opt_state = init_opt_state(params)
    if opt_leaves_np is not None:
        p = len(sorted_leaves(params))
        if len(opt_leaves_np) != OPT_HEADER + 2 * p:
            raise ValueError(f"expected {OPT_HEADER + 2 * p} optimiser leaves "
                             f"for {p} parameter leaves, got {len(opt_leaves_np)}")
        as_f32 = [torch.from_numpy(np.array(a, np.float32)).to(device)
                  for a in opt_leaves_np[OPT_HEADER:]]
        opt_state = {"count": int(np.asarray(opt_leaves_np[OPT_HEADER - 1])),
                     "mu": tree_from_leaves(params, as_f32[:p]),
                     "nu": tree_from_leaves(params, as_f32[p:])}
    return TrainState(params=params, bn_state=bn_state, opt_state=opt_state,
                      step=int(np.asarray(step)), lr=float(np.asarray(lr)))


def train_state_to_numpy(state):
    """Inverse of ``train_state_from_numpy``: (params_np, bn_state_np,
    opt_leaves_np, step, lr) with the optimiser leaves in the JAX order."""
    to_np = lambda tree: _unflatten(_flatten(tree))
    count = np.asarray(state.opt_state["count"], np.int32)
    header = [count, np.float32(ADAM_B1), np.float32(ADAM_B2),
              np.float32(ADAM_EPS), np.float32(0.0), np.float32(state.lr), count]
    moments = [leaf.detach().cpu().numpy()
               for key in ("mu", "nu")
               for _, leaf in sorted_leaves(state.opt_state[key])]
    return (to_np(state.params), to_np(state.bn_state),
            [np.asarray(a) for a in header] + moments,
            np.asarray(state.step, np.int32), np.asarray(state.lr, np.float32))
