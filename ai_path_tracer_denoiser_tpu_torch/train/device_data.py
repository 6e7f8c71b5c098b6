"""Device-resident training data: upload every frame once, crop on device
(counterpart of train/device_data.py).

The host-streaming loader (``data/dataset.py`` + ``fit``) ships every batch
over the host-to-device link.  Here the whole frame corpus is uploaded once
as two device tensors X (F, H, W, 10) / Y (F, H, W, 3), bfloat16 under
bfloat16 compute (raw uint8 for a u8-quantized corpus, decoded after the
crop); each step only the window starts and crop offsets go up, three small
integer vectors, and the 7-frame crop windows are gathered on the device.

Windows are consecutive frame POSITIONS (``SequenceDataset.window_start``:
the reference's end-of-sequence clamp, dataloader.py:48-49).  Crop offsets
stay crop_size-aligned with the same per-(seed, item) RNG keying as the
host loader, so both loaders draw the same batches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import ModelOptions, TrainOptions
from ..models.export import sorted_leaves
from ..utils.device import resolve_device
from ..utils.timers import span
from .schedule import step_lr
from .trainer import TrainState, _EpochLog, train_step


def load_device_dataset(dataset, dtype=torch.bfloat16, chunk: int = 96,
                        device=None):
    """Upload a SequenceDataset's frames to ``device``.

    Returns (X (F,H,W,10), Y (F,H,W,3) tensors in ``dtype``, window_starts
    (F,) int32 host array).  Frames are staged in ``chunk``-frame pieces, so
    peak host memory is one chunk.
    """
    device = resolve_device(device)
    f0 = np.load(dataset.path_of(0, gt=False), mmap_mode="r")
    h, w = f0.shape[:2]
    n = len(dataset)
    if f0.dtype == np.uint8:
        # u8-quantized corpus: upload raw uint8 and decode on the device
        # after cropping, so host and device paths see identical values.
        dtype = torch.uint8

    def upload(shape, gt):
        buf = torch.empty(shape, dtype=dtype, device=device)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            piece = np.empty((e - s,) + shape[1:], f0.dtype)
            for i in range(s, e):
                frame = np.load(dataset.path_of(i, gt=gt), mmap_mode="r")
                # A mixed f32/u8 corpus would be cast silently into the
                # wrong value range here; fail loudly instead.
                if frame.dtype != f0.dtype:
                    raise ValueError(
                        f"mixed-dtype corpus: {dataset.path_of(i, gt=gt)} is "
                        f"{frame.dtype} but frame 0 is {f0.dtype}; "
                        "regenerate the corpus with one --quantize mode")
                piece[i - s] = frame
            buf[s:e] = torch.from_numpy(piece).to(device).to(dtype)
        return buf

    X = upload((n, h, w, 10), gt=False)
    Y = upload((n, h, w, 3), gt=True)
    starts = np.asarray([dataset.window_start(i) for i in range(n)], np.int32)
    return X, Y, starts


def _crop_batch(X, Y, starts, cys, cxs, t, ch, cw):
    """(N,) windows -> time-major (T, N, ch, cw, C) batches, on the device.
    ``starts``/``cys``/``cxs`` are host integer sequences."""
    with span("train.crop"):
        xs = torch.stack([X[s:s + t, cy:cy + ch, cx:cx + cw]
                          for s, cy, cx in zip(starts, cys, cxs)], dim=1)
        ys = torch.stack([Y[s:s + t, cy:cy + ch, cx:cx + cw]
                          for s, cy, cx in zip(starts, cys, cxs)], dim=1)
    return xs, ys


def _decode_u8(x, y, dtype):
    """The u8 regime's decode after the crop (data/dataset.py decode_u8_*)."""
    x = x.to(torch.float32) / 255.0
    x = torch.cat([x[..., 0:3], x[..., 3:6] * 2.0 - 1.0, x[..., 6:7] * 10.0,
                   x[..., 7:10]], dim=-1)
    return x.to(dtype), (y.to(torch.float32) / 255.0).to(dtype)


def epoch_crops(epoch: int, idxs, h: int, w: int, crop_h: int, crop_w: int):
    """Crop offsets of the items ``idxs`` in ``epoch``: the same draw
    expression as ``SequenceDataset.__getitem__`` with the per-item
    generator of ``sequence_batches``, so the crops are identical (and a
    frame smaller than the crop raises here too)."""
    cy, cx = [], []
    for item in idxs:
        rng = np.random.default_rng([epoch, int(item)])
        cy.append(int(rng.integers(h // crop_h)) * crop_h)
        cx.append(int(rng.integers(w // crop_w)) * crop_w)
    return cy, cx


def _train_windows(state: TrainState, X, Y, starts, items, epoch: int,
                   topt: TrainOptions, model_options, log, log_every: int,
                   step_i: int = 0):
    """Train on the windows of ``items`` (global item ids, in batches of
    ``topt.batch_size``, a ragged tail dropped), cropped on the device from
    the frame buffers X / Y, where item i's window starts at row
    ``starts[i]``.  Returns (state, the epoch's step count so far)."""
    batch = topt.batch_size
    h, w = X.shape[1:3]
    # crop_size=0 disables cropping: full (H, W) frames, like the host path.
    crop_h = topt.crop_size if topt.crop_size else h
    crop_w = topt.crop_size if topt.crop_size else w
    in_dtype = torch.bfloat16 if topt.bf16_compute else torch.float32
    for b0 in range(0, len(items) // batch * batch, batch):
        idxs = items[b0:b0 + batch]
        cy, cx = epoch_crops(epoch, idxs, h, w, crop_h, crop_w)
        x, y = _crop_batch(X, Y, starts[idxs].tolist(), cy, cx,
                           topt.sequence_length, crop_h, crop_w)
        if X.dtype == torch.uint8:
            x, y = _decode_u8(x, y, in_dtype)
        state, metrics = train_step(state, x, y, topt, model_options)
        log.step(step_i, metrics, log_every)
        step_i += 1
    return state, step_i


def _fit_epochs(state: TrainState, topt: TrainOptions, epochs: int, start_epoch: int,
                logger, checkpoint_fn, train_epoch) -> TrainState:
    """The epoch loop of ``fit_device_data`` and ``fit_streamed``: the
    learning-rate schedule, the sampled log, checkpoints.
    ``train_epoch(state, epoch, log)`` trains one epoch and returns
    (state, its step count)."""
    overall_step = int(state.step)
    for epoch in range(start_epoch, epochs):
        lr = step_lr(topt.lr, epoch, topt.lr_step_epochs, topt.lr_gamma)
        state = dataclasses.replace(state, lr=float(lr))
        t0 = time.time()
        log = _EpochLog(epoch, lr, overall_step, logger)
        state, steps = train_epoch(state, epoch, log)
        overall_step += steps
        log.close(time.time() - t0)
        if checkpoint_fn is not None and \
                epoch % topt.checkpoint_every_epochs == 0:
            checkpoint_fn(state, epoch)
    if checkpoint_fn is not None:
        checkpoint_fn(state, "final")
    return state


def fit_device_data(state: TrainState, dataset,
                    train_options: TrainOptions = TrainOptions(),
                    epochs: Optional[int] = None,
                    logger=None, checkpoint_fn=None, log_every: int = 5,
                    model_options: Optional[ModelOptions] = None,
                    start_epoch: int = 0,
                    data=None) -> TrainState:
    """fit() with the corpus device-resident; same schedule/logging contract.

    ``data``: optional pre-loaded (X, Y, window_starts) triple from
    ``load_device_dataset`` (loaded here, onto the device of the state's
    parameters, if absent).
    """
    topt = train_options
    epochs = epochs if epochs is not None else topt.epochs
    if data is None:
        t0 = time.time()
        # The upload dtype follows the compute dtype: with bf16_compute off
        # the host path trains on float32 inputs and this path matches it.
        data = load_device_dataset(
            dataset, dtype=torch.bfloat16 if topt.bf16_compute else torch.float32,
            device=sorted_leaves(state.params)[0][1].device)
        n_bytes = sum(a.numel() * a.element_size() for a in data[:2])
        print(f"[device-data] uploaded {len(dataset)} frames "
              f"({n_bytes / 2**30:.1f} GiB) in {time.time() - t0:.0f}s")
    X, Y, starts_tbl = data

    def train_epoch(state, epoch, log):
        order = np.arange(len(dataset))
        np.random.default_rng(epoch).shuffle(order)
        return _train_windows(state, X, Y, starts_tbl, order, epoch, topt,
                              model_options, log, log_every)

    return _fit_epochs(state, topt, epochs, start_epoch, logger, checkpoint_fn,
                       train_epoch)
