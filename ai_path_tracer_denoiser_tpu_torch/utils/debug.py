"""Numerics checking + profiling helpers (counterpart of utils/debug.py).

The reference's runtime verification is ERRORCHECK-gated
cudaDeviceSynchronize/cudaGetLastError after every kernel launch
(pathtrace.cu:27, 32-50) plus cudaEvent timers (common.h).  Here: a
per-iteration finite-ness sweep over every floating plane of the render
state (it names the iteration at which a NaN/Inf first appeared, like the
post-launch error check), and ``torch.profiler`` traces for per-kernel
timing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch


def _state_finite(state) -> bool:
    """Every floating tensor of a render state (nested tuples and
    dataclasses included) is finite."""
    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for item in x:
                yield from leaves(item)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                yield from leaves(getattr(x, f.name))

    return all(bool(torch.isfinite(t).all()) for t in leaves(state)
               if t.is_floating_point())


def assert_render_finite(scene, options, num_iterations: int = 1):
    """Raise if any iteration produces NaN/Inf in any render-state plane.

    ERRORCHECK=1 equivalent: checks after every iteration of the plain
    wavefront, so the failing iteration index is reported.
    """
    from ..render.wavefront import init_render_state, trace_iteration

    state = init_render_state(scene, options)
    for i in range(num_iterations):
        state = trace_iteration(scene, options, state)
        if not _state_finite(state):
            raise FloatingPointError(
                f"non-finite value in render state after iteration {i + 1} "
                f"(scene {scene.image_name!r})")
    return state


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace context (PerformanceTimer/TIME-flag
    equivalent): host and, on a card, device activity of the body, written
    as ``trace.json`` (Chrome trace format) under ``log_dir``.  Yields the
    profiler; ``key_averages()`` sums the times by kernel."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
