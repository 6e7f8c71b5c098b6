"""Training loop: Adam + StepLR, BPTT over 7-frame sequences (counterpart
of train/trainer.py).

One ``train_step`` runs the sequence forward frame by frame, takes a single
backward pass through all frames (loss.backward(), train.py:99) and applies
Adam with the learning rate injected per step.  The state is a plain
dataclass of dict-of-tensor trees; a step returns a new state and leaves
the old one untouched, as the JAX trainer does.

With ``axis_name`` (a ``torch.distributed`` process group: the
data-parallel ranks, each holding other sequences of the batch) BatchNorm
and HFEN take their statistics over the ranks, and the gradients and
metrics are averaged over them with one all-reduce of the flattened
gradient tree and metrics (the one bucket ``DistributedDataParallel`` would build; it cannot wrap
this functional parameter tree).  Adam then runs identically on every
rank, so the parameters stay replicated with no broadcast.  The argument
comes last, after ``model_options``, so that every positional call of
these functions keeps its meaning.

Adam has the JAX trainer's settings (b1 0.9, b2 0.999, eps 1e-8 added outside
the root, no weight decay), written with ``torch._foreach_*`` over the
parameter leaves in sorted-key order, the order of the JAX package's
optimiser state and checkpoints (models/export.py).
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelOptions, TrainOptions
from ..models.autoencoder import apply_sequence, init_autoencoder
from ..models.export import (ADAM_B1, ADAM_B2, ADAM_EPS, sorted_leaves,
                             tree_from_leaves)
from ..utils.device import resolve_device
from ..utils.timers import span
from .loss import sequence_loss
from .schedule import step_lr


@dataclasses.dataclass
class TrainState:
    params: dict
    bn_state: dict
    opt_state: dict            # {"count": int, "mu": tree, "nu": tree}
    step: int
    lr: float                  # set per epoch by ``fit``


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params) -> dict:
    return {"count": 0, "mu": _tree_map(torch.zeros_like, params),
            "nu": _tree_map(torch.zeros_like, params)}


def init_train_state(generator: torch.Generator,
                     model_options: ModelOptions = ModelOptions(),
                     train_options: TrainOptions = TrainOptions(),
                     device=None) -> TrainState:
    """A fresh state on ``device`` (default: the card), weights drawn from
    ``generator``."""
    device = resolve_device(device)
    params, bn_state = init_autoencoder(generator, model_options)
    params = _tree_map(lambda t: t.to(device), params)
    bn_state = _tree_map(lambda t: t.to(device), bn_state)
    return TrainState(params=params, bn_state=bn_state,
                      opt_state=init_opt_state(params), step=0,
                      lr=float(train_options.lr))


def loss_fn(params, bn_state, inputs, targets,
            train_options: TrainOptions = TrainOptions(),
            bf16: bool = False,
            model_options: Optional[ModelOptions] = None,
            axis_name=None):
    """BPTT loss over one batch of sequences (this rank's, with
    ``axis_name``).

    inputs: (T, N, H, W, 10) time-major; targets: (T, N, H, W, 3).
    Returns (total, (metrics, new_bn_state)).
    """
    with span("train.forward"):
        outputs, _, new_bn = apply_sequence(params, bn_state, inputs,
                                            train=True, bf16=bf16,
                                            axis_name=axis_name,
                                            remat=train_options.remat_frames,
                                            options=model_options)
    with span("train.loss"):
        total, metrics = sequence_loss(
            outputs, targets, train_options.w_spatial, train_options.w_gradient,
            train_options.w_temporal, train_options.frame_ramp[:inputs.shape[0]],
            axis_name=axis_name)
    return total, (metrics, new_bn)


def loss_and_grads(state: TrainState, inputs, targets,
                   train_options: TrainOptions = TrainOptions(),
                   model_options: Optional[ModelOptions] = None,
                   axis_name=None):
    """(metrics, new_bn_state, gradient tree) of ``loss_fn`` at the state's
    parameters: one forward over the sequence, one backward.  With
    ``axis_name`` the gradients and metrics are the means over its ranks."""
    flat = sorted_leaves(state.params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in flat]
    params = tree_from_leaves(state.params, leaves)
    total, (metrics, new_bn) = loss_fn(
        params, state.bn_state, inputs, targets, train_options,
        train_options.bf16_compute, model_options, axis_name)
    with span("train.backward"):
        grads = list(torch.autograd.grad(total, leaves))
    keys = list(metrics)
    metrics = [metrics[k].detach() for k in keys]
    if axis_name is not None:
        means = _mean_over_ranks(grads + metrics, axis_name)
        grads, metrics = means[:len(grads)], means[len(grads):]
    new_bn = _tree_map(lambda t: t.detach(), new_bn)
    return (dict(zip(keys, metrics)), new_bn,
            tree_from_leaves(state.params, grads))


def _mean_over_ranks(tensors, group):
    """The means of ``tensors`` over the ranks of ``group``: one sum
    all-reduce of their flattened concatenation, divided by the size."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat / dist.get_world_size(group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def adam_update(params, grads, opt_state, lr: float):
    """One Adam step, out of place.  Returns (new params, new opt_state).

    The decay rates are float32 numbers in the JAX trainer (its injected
    hyper-parameters), so 1 - b2 is 0.0010000467 there, not 0.001; the
    constants are taken the same way here so that the moments of either
    package continue the other's to float32 rounding.
    """
    p = [leaf for _, leaf in sorted_leaves(params)]
    g = [leaf for _, leaf in sorted_leaves(grads)]
    mu = [leaf for _, leaf in sorted_leaves(opt_state["mu"])]
    nu = [leaf for _, leaf in sorted_leaves(opt_state["nu"])]
    count = opt_state["count"] + 1
    one, b1, b2 = np.float32(1.0), np.float32(ADAM_B1), np.float32(ADAM_B2)
    bias1 = float(one - b1 ** np.int32(count))
    bias2 = float(one - b2 ** np.int32(count))
    with torch.no_grad():
        mu = torch._foreach_mul(mu, float(b1))
        torch._foreach_add_(mu, g, alpha=float(one - b1))
        nu = torch._foreach_mul(nu, float(b2))
        torch._foreach_addcmul_(nu, g, g, value=float(one - b2))
        denom = torch._foreach_div(nu, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        new_p = torch._foreach_addcdiv(p, mu, denom, value=-lr / bias1)
    return (tree_from_leaves(params, list(new_p)),
            {"count": count, "mu": tree_from_leaves(params, list(mu)),
             "nu": tree_from_leaves(params, list(nu))})


def train_step(state: TrainState, inputs: torch.Tensor, targets: torch.Tensor,
               train_options: TrainOptions = TrainOptions(),
               model_options: Optional[ModelOptions] = None,
               axis_name=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step (forward 7 frames -> single backward -> Adam).
    ``axis_name``: the data-parallel process group; the returned state is
    then the same on every rank."""
    with span("train.step"):
        metrics, new_bn, grads = loss_and_grads(state, inputs, targets,
                                                train_options, model_options,
                                                axis_name)
        with span("train.optimizer"):
            params, opt_state = adam_update(state.params, grads, state.opt_state,
                                            state.lr)
    return TrainState(params=params, bn_state=new_bn, opt_state=opt_state,
                      step=state.step + 1, lr=state.lr), metrics


def _device_prefetch(batches: Iterable, device: torch.device,
                     bf16_inputs: bool = False):
    """Stage batches on the device one batch ahead of compute.

    On the card each host batch is copied into pinned memory and sent with
    a non-blocking copy, so the next batch's transfer overlaps the current
    step.  ``bf16_inputs`` ships inputs and targets as bfloat16 (half the
    bytes): with bfloat16 conv compute the first consumer rounds to
    bfloat16 anyway, and the loss upcasts the targets to float32.
    """
    def stage(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if bf16_inputs:
            t = t.to(torch.bfloat16)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    ahead = None
    for x, y in batches:
        staged = (stage(np.asarray(x)), stage(np.asarray(y)))
        if ahead is not None:
            yield ahead
        ahead = staged
    if ahead is not None:
        yield ahead


class _EpochLog:
    """Sampled metrics of one epoch: fetched ``log_every`` steps behind the
    dispatch (one host read for all four scalars), printed and logged."""

    def __init__(self, epoch, lr, epoch_base, logger):
        self.epoch, self.lr, self.base, self.logger = epoch, lr, epoch_base, logger
        self.total, self.count, self.pending = 0.0, 0, None

    def step(self, i, metrics, log_every):
        if i % log_every == 0:
            self.flush()
            self.pending = (i, metrics)

    def flush(self):
        if self.pending is None:
            return
        i, metrics = self.pending
        self.pending = None
        keys = list(metrics)
        values = torch.stack([metrics[k].float() for k in keys]).tolist()
        m = dict(zip(keys, values))
        self.total += m["total"]
        self.count += 1
        if self.logger is not None:
            self.logger.scalars(self.base + i + 1, m)
        print(f"Epoch [{self.epoch}] Step [{i}] "
              f"Total {m['total']:.4f} L1 {m['l1']:.4f} "
              f"HFEN {m['hfen']:.4f} "
              f"Temporal {m['temporal']:.4f} lr {self.lr:g}")

    def close(self, seconds):
        self.flush()
        if self.count:
            print(f"Epoch {self.epoch}: avg loss {self.total / self.count:.4f} "
                  f"({seconds:.1f}s)")


def fit(state: TrainState, data_iter_fn: Callable[..., Iterable],
        train_options: TrainOptions = TrainOptions(),
        epochs: Optional[int] = None,
        logger=None, checkpoint_fn=None, log_every: int = 5,
        model_options: Optional[ModelOptions] = None,
        start_epoch: int = 0, axis_name=None):
    """Epoch loop (train.py:54-112): StepLR per epoch, periodic checkpoints.

    ``data_iter_fn()`` must yield (inputs (T,N,H,W,10), targets (T,N,H,W,3))
    numpy batches for one epoch; if it accepts an argument it receives the
    epoch index: shuffle with it.  Batches go to the device the state's
    parameters live on.  ``start_epoch`` resumes the StepLR schedule
    mid-run (epochs already covered by a loaded checkpoint).
    ``axis_name``: the data-parallel process group; each batch is then this
    rank's slice (``parallel.dp.local_batch``).
    """
    try:
        takes_epoch = len(inspect.signature(data_iter_fn).parameters) >= 1
    except (TypeError, ValueError):
        takes_epoch = False
    epochs = epochs if epochs is not None else train_options.epochs
    device = sorted_leaves(state.params)[0][1].device
    overall_step = int(state.step)
    for epoch in range(start_epoch, epochs):
        lr = step_lr(train_options.lr, epoch, train_options.lr_step_epochs,
                     train_options.lr_gamma)
        state = dataclasses.replace(state, lr=float(lr))
        t0 = time.time()
        batches = data_iter_fn(epoch) if takes_epoch else data_iter_fn()
        staged = _device_prefetch(batches, device,
                                  bf16_inputs=train_options.bf16_compute)
        log = _EpochLog(epoch, lr, overall_step, logger)
        n_steps = 0
        for i, (inputs, targets) in enumerate(staged):
            state, metrics = train_step(state, inputs, targets, train_options,
                                        model_options, axis_name)
            n_steps = i + 1
            log.step(i, metrics, log_every)
        overall_step += n_steps
        log.close(time.time() - t0)
        if checkpoint_fn is not None and epoch % train_options.checkpoint_every_epochs == 0:
            checkpoint_fn(state, epoch)
    if checkpoint_fn is not None:
        checkpoint_fn(state, "final")
    return state


def recalibrate_bn(state: TrainState, batches, n_batches: int,
                   train_options: Optional[TrainOptions] = None,
                   model_options: Optional[ModelOptions] = None
                   ) -> TrainState:
    """Re-estimate BatchNorm running statistics with frozen weights: a
    short pass of forward-only train-mode steps (no optimizer) lets the
    running statistics converge on the final weights before the export.

    ``batches``: iterable of (inputs (T,N,H,W,10), targets); targets are
    ignored.  Returns the state with updated ``bn_state`` only.
    """
    topt = train_options if train_options is not None else TrainOptions()
    device = sorted_leaves(state.params)[0][1].device
    bn = state.bn_state
    seen = 0
    with torch.no_grad():
        for x, _ in batches:
            x = torch.as_tensor(x).to(device)
            _, _, bn = apply_sequence(state.params, bn, x, train=True,
                                      bf16=topt.bf16_compute,
                                      options=model_options)
            seen += 1
            if seen >= n_batches:
                break
    return dataclasses.replace(state, bn_state=bn)
