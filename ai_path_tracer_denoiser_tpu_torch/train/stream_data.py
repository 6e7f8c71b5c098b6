"""Host-streamed sharded training: corpora larger than the card's memory
(counterpart of train/stream_data.py).

The device-resident path (``train/device_data.py``) uploads the whole
corpus once, which caps it at what fits beside training.  Here the corpus
is split into sequence-aligned shards; each shard trains through the same
on-device crop path, and shards swap through two persistent device
buffers while a host thread reads the next shard from disk.

  * Shards are cut at (scene, mov, noise) group edges, so a window never
    crosses a shard (``SequenceDataset.window_start`` stays in its group).
  * On the card, the host thread reads the next shard into page-locked
    memory and queues its copy into the other buffer on a side stream, so
    the copy runs while the current shard trains.  The copy waits for an
    event recorded after the last step that read that buffer, and the
    first step on a shard waits for the event after its copy.  On the CPU
    the thread reads straight into the other buffer.
  * Sampling is shard-stratified: the shard order is reshuffled every
    epoch (rng(epoch)), windows within a shard with rng([epoch, shard]).
    With one shard this is the device-resident path's global shuffle
    (rng(epoch)), and the fit equals ``fit_device_data``'s bit for bit.
    Crop offsets keep the global (epoch, item) keying
    (``device_data.epoch_crops``), so they are the same under any
    sharding.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelOptions, TrainOptions
from ..models.export import sorted_leaves
from .device_data import _fit_epochs, _train_windows
from .trainer import TrainState


def group_ranges(dataset) -> List[Tuple[int, int]]:
    """Contiguous index ranges of the (scene, mov, noise) groups."""
    ranges = []
    prev = None
    start = 0
    for i, (s, mv, nz, _f) in enumerate(dataset._keys):
        key = (s, mv, nz)
        if key != prev and prev is not None:
            ranges.append((start, i))
            start = i
        prev = key
    ranges.append((start, len(dataset)))
    return ranges


def shard_plan(dataset, max_frames: int) -> List[Tuple[int, int]]:
    """Greedy pack whole groups into shards of <= max_frames frames."""
    shards = []
    cur_s, cur_e = None, None
    for (s, e) in group_ranges(dataset):
        if e - s > max_frames:
            raise ValueError(
                f"group [{s},{e}) has {e - s} frames > shard capacity "
                f"{max_frames}; raise the shard budget")
        if cur_s is None:
            cur_s, cur_e = s, e
        elif e - cur_s <= max_frames:
            cur_e = e
        else:
            shards.append((cur_s, cur_e))
            cur_s, cur_e = s, e
    if cur_s is not None:
        shards.append((cur_s, cur_e))
    return shards


def _frame_dtypes(dataset, bf16: bool):
    """(buffer dtype, file dtype): raw uint8 for a u8-quantized corpus,
    else the compute dtype."""
    f0 = np.load(dataset.path_of(0, gt=False), mmap_mode="r")
    if f0.dtype == np.uint8:
        return torch.uint8, np.uint8
    return (torch.bfloat16 if bf16 else torch.float32), f0.dtype


def _read_shard(dataset, s, e, np_dtype, hx: torch.Tensor, hy: torch.Tensor):
    """Host read of frames [s, e) into rows [0, e - s) of the host tensors
    ``hx`` / ``hy`` (converted to their dtype as ``load_device_dataset``
    converts)."""
    for i in range(s, e):
        fx = np.load(dataset.path_of(i, gt=False))
        fy = np.load(dataset.path_of(i, gt=True))
        if fx.dtype != np_dtype:
            raise ValueError(
                f"mixed-dtype corpus: {dataset.path_of(i)} is {fx.dtype} but "
                f"frame 0 is {np_dtype}; regenerate with one --quantize mode")
        hx[i - s].copy_(torch.from_numpy(fx))
        hy[i - s].copy_(torch.from_numpy(fy))


def _epoch_plan(shards, epoch: int):
    """[(shard, its global item ids in training order)] of ``epoch``: the
    shards in rng(epoch) order, each shard's windows in rng([epoch, shard])
    order; one shard takes the device-resident path's global shuffle."""
    if len(shards) == 1:
        s, e = shards[0]
        return [(0, np.random.default_rng(epoch).permutation(e - s) + s)]
    plan = []
    for si in np.random.default_rng(epoch).permutation(len(shards)):
        s, e = shards[si]
        plan.append((int(si), np.random.default_rng([epoch, int(si)]).permutation(e - s) + s))
    return plan


def fit_streamed(state: TrainState, dataset,
                 train_options: TrainOptions = TrainOptions(),
                 epochs: Optional[int] = None,
                 shard_frames: Optional[int] = None,
                 shard_gb: float = 6.0,
                 logger=None, checkpoint_fn=None, log_every: int = 5,
                 model_options: Optional[ModelOptions] = None,
                 start_epoch: int = 0,
                 timings: Optional[list] = None) -> TrainState:
    """fit() with a host-streamed sharded corpus; ``fit_device_data``'s
    contract, on the device of the state's parameters.

    ``shard_frames`` / ``shard_gb``: shard capacity (frames win if given).
    ``timings``: a list that gets one dict per shard visit: its frames,
    steps, host read seconds and, on the card, ``upload_ms`` (the copy on
    the side stream), ``exposed_ms`` (how long the compute stream, once
    there, waited for it), ``steps_ms`` (first step to last) and ``gap_ms``
    (the compute stream from the previous visit's last step to this one's
    first; None for the first visit), all CUDA events.
    """
    topt = train_options
    epochs = epochs if epochs is not None else topt.epochs
    dev = sorted_leaves(state.params)[0][1].device
    on_card = dev.type == "cuda"
    buf_dtype, np_dtype = _frame_dtypes(dataset, topt.bf16_compute)
    f0 = np.load(dataset.path_of(0, gt=False), mmap_mode="r")
    h, w = f0.shape[:2]
    bytes_per_frame = h * w * 13 * torch.empty((), dtype=buf_dtype).element_size()
    if shard_frames is None:
        shard_frames = max(int(shard_gb * 2 ** 30 / bytes_per_frame), 64)
    shards = shard_plan(dataset, shard_frames)
    cap = max(e - s for s, e in shards)
    n = len(dataset)
    print(f"[stream] {n} frames -> {len(shards)} shards "
          f"(cap {cap} frames, {cap * bytes_per_frame / 2**30:.1f} GiB)")
    starts_tbl = np.asarray([dataset.window_start(i) for i in range(n)],
                            np.int32)

    # two persistent device buffers; on the card one page-locked staging pair
    X = [torch.empty((cap, h, w, 10), dtype=buf_dtype, device=dev) for _ in range(2)]
    Y = [torch.empty((cap, h, w, 3), dtype=buf_dtype, device=dev) for _ in range(2)]
    if on_card:
        staging = (torch.empty((cap, h, w, 10), dtype=buf_dtype, pin_memory=True),
                   torch.empty((cap, h, w, 3), dtype=buf_dtype, pin_memory=True))
        copy_stream = torch.cuda.Stream(device=dev)

    def timed_event():
        return torch.cuda.Event(enable_timing=True)

    def stage(si, slot, free, staged):
        """Read shard ``si`` and (on the card) queue its copy into buffer
        ``slot`` after ``free`` (the last step that read it); ``staged``:
        the event after the staging pair's previous copy."""
        s, e = shards[si]
        if staged is not None:
            staged.synchronize()              # the staging pair is free again
        t0 = time.perf_counter()
        _read_shard(dataset, s, e, np_dtype,
                    *(staging if on_card else (X[slot], Y[slot])))
        read_s = time.perf_counter() - t0
        if not on_card:
            return read_s, None, None
        with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
            if free is not None:
                copy_stream.wait_event(free)
            a, b = timed_event(), timed_event()
            a.record()
            X[slot][:e - s].copy_(staging[0][:e - s], non_blocking=True)
            Y[slot][:e - s].copy_(staging[1][:e - s], non_blocking=True)
            b.record()
        return read_s, a, b

    free = [None, None]        # per buffer: event after the last step on it
    staged = None              # event after the staging pair's last copy
    visits = []                # per shard visit, read back at the end
    pos = 0                    # shard visits so far: the buffer is pos % 2

    def train_epoch(state, epoch, log):
        nonlocal staged, pos
        plan = _epoch_plan(shards, epoch)
        step_i = 0
        nxt = reader.submit(stage, plan[0][0], pos % 2, free[pos % 2], staged)
        for k, (si, items) in enumerate(plan):
            slot = pos % 2
            read_s, up_a, up_b = nxt.result()
            staged = up_b
            if k + 1 < len(plan):                  # prefetch the next shard
                nslot = (pos + 1) % 2
                nxt = reader.submit(stage, plan[k + 1][0], nslot, free[nslot], staged)
            marks = None
            if on_card:
                marks = [timed_event(), timed_event()]
                marks[0].record()
                torch.cuda.current_stream(dev).wait_event(up_b)
                marks[1].record()
            s, e = shards[si]
            first = step_i
            state, step_i = _train_windows(state, X[slot], Y[slot], starts_tbl - s, items,
                                           epoch, topt, model_options, log, log_every,
                                           step_i)
            if on_card:
                done = timed_event()
                done.record()
                free[slot] = done
                marks.append(done)
            visits.append((si, e - s, step_i - first, read_s, up_a, up_b, marks))
            pos += 1
        return state, step_i

    with ThreadPoolExecutor(max_workers=1) as reader:
        state = _fit_epochs(state, topt, epochs, start_epoch, logger, checkpoint_fn,
                            train_epoch)
    if timings is not None:
        if on_card:
            torch.cuda.synchronize(dev)
        prev = None
        for si, frames, n_steps, read_s, up_a, up_b, marks in visits:
            rec = {"shard": si, "frames": frames, "steps": n_steps, "read_s": read_s}
            if on_card:
                # exposed: how long after the compute stream reached the
                # wait the copy ended (0 where it had ended before); gap:
                # the compute stream from the previous shard's last step to
                # this shard's first
                rec.update(upload_ms=up_a.elapsed_time(up_b),
                           exposed_ms=max(0.0, marks[0].elapsed_time(up_b)),
                           steps_ms=marks[1].elapsed_time(marks[2]),
                           gap_ms=prev[2].elapsed_time(marks[1]) if prev else None)
            prev = marks
            timings.append(rec)
    return state
