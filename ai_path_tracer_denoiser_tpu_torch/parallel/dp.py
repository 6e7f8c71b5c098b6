"""Data-parallel training: the sequences of a batch split over ``data``
(counterpart of parallel/dp.py).

Each rank runs the whole BPTT train step on its slice of the batch.
BatchNorm's statistics and HFEN's max span the ranks, and the gradients
and metrics are averaged over them inside ``train_step`` (one all-reduce
of the flattened gradient tree), so sharded training is the same model as
large-batch single-device training.  Adam then runs identically on every
rank, which keeps the parameters replicated without a broadcast.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelOptions, TrainOptions
from ..train.trainer import train_step
from .mesh import axis_index, axis_size, mesh_device


def local_batch(inputs, targets, mesh):
    """This rank's slice of the N axis of a (T, N, H, W, C) batch, where the
    batch lies (a host batch stays on the host)."""
    n_dev, r = axis_size(mesh, "data"), axis_index(mesh, "data")
    n = inputs.shape[1]
    assert n % n_dev == 0, f"batch of {n} not divisible by {n_dev} ranks"
    k = n // n_dev
    return inputs[:, r * k:(r + 1) * k], targets[:, r * k:(r + 1) * k]


def shard_batch(inputs, targets, mesh):
    """This rank's slice of the N axis of a (T, N, H, W, C) batch (numpy
    arrays or tensors), on this rank's device."""
    dev = mesh_device(mesh)
    return tuple(torch.as_tensor(a).to(dev).contiguous()
                 for a in local_batch(inputs, targets, mesh))


def make_dp_train_step(mesh, train_options: TrainOptions = TrainOptions(),
                       model_options: Optional[ModelOptions] = None):
    """Data-parallel train step: (state, x, y) -> (state, metrics).

    x: (T, n, H, W, 10), y: (T, n, H, W, 3), this rank's slice of the batch
    (``shard_batch``).  The state is replicated; the returned state and
    metrics are the same on every rank.
    """
    group = mesh.get_group("data")

    def step(state, x, y):
        return train_step(state, x, y, train_options, model_options,
                          axis_name=group)

    return step
