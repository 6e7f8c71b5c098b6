"""Performance timing (counterpart of utils/timers.py) and the port's spans
and counters.

Common::PerformanceTimer (common.h:27-111): paired host and device timers.
On a CUDA device the device timer is a pair of CUDA events on the current
stream, read after the end event has completed; on the CPU it is the host
clock.  ``torch.profiler`` traces (utils/debug.py) are the deeper tool.

Spans and counters (``span``, ``host_read``, ``count``) mark the layers of
the program from inside: render, its bounces and their parts, the
denoiser's levels, the train step's phases, and every read of the device
on the hot paths.  A span has two modes, chosen when it opens:

* while a torch profiler collects (``_profiler_enabled()``: the active
  steps of a schedule; its warm-up steps only prepare the tracer), it is
  ``torch.profiler.record_function`` and keeps nothing in memory: it lands in the profiler's Chrome trace as a
  ``user_annotation`` event on the clock of the device's kernels;
* otherwise it adds its host nanoseconds (``time.perf_counter_ns``) to an
  in-memory record: a span opened with no span open on its thread is a
  top-level span and starts a record of its own, ``{"spans": {name: ns},
  "counts": {name: n}}``, which its nested spans and any ``count`` made
  on its thread while it is open add to (a name opened several times
  adds up).  The last ``KEEP`` records of each top-level
  name are kept (``records``).

``count`` also adds to process-wide totals (``totals``), always.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional, Union

import torch


def _is_cuda(device: Optional[Union[str, torch.device]]) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


class PerformanceTimer:
    """``device``: where the timed work runs (None: the card if there is one)."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self._cuda = _is_cuda(device)
        self._cpu_start: Optional[float] = None
        self._dev_start = None
        self.cpu_elapsed_ms: float = 0.0
        self.dev_elapsed_ms: float = 0.0

    # --- CPU timer (common.h:37-55) ---
    def start_cpu(self):
        self._cpu_start = time.perf_counter()

    def end_cpu(self) -> float:
        assert self._cpu_start is not None
        self.cpu_elapsed_ms = (time.perf_counter() - self._cpu_start) * 1e3
        self._cpu_start = None
        return self.cpu_elapsed_ms

    # --- device timer (common.h:57-77: cudaEvent pairs) ---
    def start_device(self):
        if self._cuda:
            # drain queued work so that only what follows is timed
            torch.cuda.synchronize()
            self._dev_start = torch.cuda.Event(enable_timing=True)
            self._dev_start.record()
        else:
            self._dev_start = time.perf_counter()

    def end_device(self) -> float:
        assert self._dev_start is not None
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.dev_elapsed_ms = self._dev_start.elapsed_time(end)
        else:
            self.dev_elapsed_ms = (time.perf_counter() - self._dev_start) * 1e3
        self._dev_start = None
        return self.dev_elapsed_ms


def time_call(fn, *args, warmup: int = 1, iters: int = 10,
              device: Optional[Union[str, torch.device]] = None) -> float:
    """Median milliseconds per call of ``fn(*args)`` (warm-up excluded): each
    call between two CUDA events on a card, on the host clock on the CPU."""
    timer = PerformanceTimer(device)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        timer.start_device()
        fn(*args)
        times.append(timer.end_device())
    times.sort()
    return times[len(times) // 2]


# ------------------------------------------------------------------ spans

KEEP = 1024                     # records kept per top-level span name

_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
_ident = threading.get_ident
_RECORDS: Dict[str, Deque[dict]] = {}
_TOTALS: Dict[str, int] = {}
_TOTALS_LOCK = threading.Lock()


class _Open:
    """One thread's open in-memory spans: how many, and the record of the
    top-level one.  Looked up by thread id (cheaper than threading.local)."""

    __slots__ = ("depth", "rec")

    def __init__(self):
        self.depth = 0
        self.rec: Optional[dict] = None


_OPEN: Dict[int, _Open] = {}


class span:
    """``with span(name):`` times the block (see the module docstring).
    Names are dotted by layer (``render.bounce``, ``denoise.enc1``,
    ``train.backward``).  Off the profiler it costs one gate, two clock
    reads and a few dict operations, and makes no dispatcher call."""

    __slots__ = ("name", "_rf", "_t0", "_open")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            return self
        self._rf = None
        op = _OPEN.get(_ident())
        if op is None:
            op = _OPEN[_ident()] = _Open()
        if not op.depth:
            op.rec = {"spans": {}, "counts": {}}
        op.depth += 1
        self._open = op
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            return False
        dt = _clock() - self._t0
        op = self._open
        rec = op.rec
        spans = rec["spans"]
        spans[self.name] = spans.get(self.name, 0) + dt
        op.depth -= 1
        if not op.depth:
            op.rec = None
            kept = _RECORDS.get(self.name)
            if kept is None:
                kept = _RECORDS.setdefault(self.name, collections.deque(maxlen=KEEP))
            kept.append(rec)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``: to the process-wide totals, and to
    the record of the top-level span open on this thread, if any."""
    with _TOTALS_LOCK:
        _TOTALS[name] = _TOTALS.get(name, 0) + n
    op = _OPEN.get(_ident())
    if op is not None and op.rec is not None:
        counts = op.rec["counts"]
        counts[name] = counts.get(name, 0) + n


def host_read(site: str) -> span:
    """A call at ``site`` that makes the host wait for the device's queue
    to drain: a read of the device, or a copy onto it from pageable host
    memory.  Counted as ``sync.<site>`` and timed as a span of that name,
    which holds the wait.  ``with host_read(site):`` around the call alone."""
    name = "sync." + site
    count(name)
    return span(name)


def records(top_name: str) -> List[dict]:
    """The kept records of the top-level span ``top_name``, oldest first."""
    return list(_RECORDS.get(top_name, ()))


def totals() -> Dict[str, int]:
    """A copy of the process-wide counter totals."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def reset() -> None:
    """Forget every kept record and counter total.  A span open now still
    closes into a record, which is kept."""
    _RECORDS.clear()
    with _TOTALS_LOCK:
        _TOTALS.clear()
