"""Checkpoint / resume (counterpart of train/checkpoint.py).

The full train state (params, BN state, Adam state, step, lr) round-trips
through one ``.npz`` in the JAX package's layout, so a checkpoint written
by either package resumes in the other:

  params/<path>, bn_state/<path>   the two trees, flattened
  opt/<i>                          the optimiser state's leaves in the JAX
                                   order (models/export.py: count, Adam's
                                   hyper-parameters and the learning rate,
                                   Adam's count, mu leaves, nu leaves)
  step, lr, next_epoch             scalars; next_epoch is the epoch to
                                   resume at (2**30 for "final")
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from ..models.export import (_flatten, _unflatten, sorted_leaves,
                             train_state_from_numpy, train_state_to_numpy)


def save_checkpoint(directory: str, state, epoch) -> str:
    """Write a full-train-state checkpoint; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"model_{epoch}.npz")
    params_np, bn_np, opt_leaves, step, lr = train_state_to_numpy(state)
    flat = {f"params/{k}": v for k, v in _flatten(params_np).items()}
    flat.update({f"bn_state/{k}": v for k, v in _flatten(bn_np).items()})
    for i, leaf in enumerate(opt_leaves):
        flat[f"opt/{i}"] = leaf
    flat["step"] = step
    flat["lr"] = lr
    # The resume epoch is stored explicitly: a checkpoint written after
    # epoch e resumes at e+1 whatever the dataset or batch size of the next
    # run; "final" resumes past any epoch count.
    next_epoch = 2 ** 30 if epoch == "final" else int(epoch) + 1
    flat["next_epoch"] = np.asarray(next_epoch, np.int64)
    np.savez(path, **flat)
    return path


def checkpoint_epoch(path: str) -> Optional[int]:
    """The epoch a checkpoint should resume at, or None for old
    checkpoints that never stored it (callers fall back to
    step // steps_per_epoch and should warn)."""
    with np.load(path) as data:
        if "next_epoch" in data.files:
            return int(data["next_epoch"])
    return None


def load_checkpoint(path: str, template_state=None, device=None):
    """Restore a train state.  The trees come wholly from the file;
    ``template_state`` (kept for the JAX package's signature) only decides
    the device when ``device`` is not given."""
    if device is None and template_state is not None:
        device = sorted_leaves(template_state.params)[0][1].device
    with np.load(path) as data:
        params_flat, state_flat, opt_flat = {}, {}, {}
        for key in data.files:
            if key.startswith("params/"):
                params_flat[key[7:]] = data[key]
            elif key.startswith("bn_state/"):
                state_flat[key[9:]] = data[key]
            elif key.startswith("opt/"):
                opt_flat[int(key[4:])] = data[key]
        step, lr = data["step"], data["lr"]
    opt_leaves = [opt_flat[i] for i in range(len(opt_flat))]
    return train_state_from_numpy(_unflatten(params_flat), _unflatten(state_flat),
                                  opt_leaves or None, step, lr, device=device)


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(directory):
        m = re.match(r"model_(\d+|final)\.npz$", name)
        if not m:
            continue
        epoch = 10 ** 9 if m.group(1) == "final" else int(m.group(1))
        if epoch > best_epoch:
            best, best_epoch = os.path.join(directory, name), epoch
    return best
