"""Performance timing (counterpart of utils/timers.py).

Common::PerformanceTimer (common.h:27-111): paired host and device timers.
On a CUDA device the device timer is a pair of CUDA events on the current
stream, read after the end event has completed; on the CPU it is the host
clock.  ``torch.profiler`` traces (utils/debug.py) are the deeper tool.
"""
from __future__ import annotations

import time
from typing import Optional, Union

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
