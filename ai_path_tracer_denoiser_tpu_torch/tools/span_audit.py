"""The port's counted host reads against the card's own list of
synchronising calls, and the cost of a span with tracing off and on.

For one 800x800 statue frame (the plain wavefront and the binned mesh
kernels), one 800x800 cornell frame (the megakernel) followed by one
denoised frame at the reference widths, and one train step (batch 4,
7-frame windows, 256x256 crops, bfloat16), each after a warm-up call:
``torch.cuda.set_sync_debug_mode("warn")`` lists every call that made the
host wait for the card, and the program's ``sync.*`` counters
(utils/timers.py) count the reads it wraps in ``host_read``.  The two must
agree; each warning's Python location is printed, so a read that no
``host_read`` wraps shows where it is (a warning with no frame of the port
on its stack, such as the one the debug mode's own switch can raise, is
listed apart).  Then spans are timed back to back:
top-level and nested, with no profiler and under ``torch.profiler``
collecting CPU and CUDA activity.  Prints one JSON line per part, with the
card's name and power limit.

Run on an NVIDIA GPU, from the repository root:
    python -m ai_path_tracer_denoiser_tpu_torch.tools.span_audit
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import math
import subprocess
import time
import traceback
import warnings

import torch

from ..config import ModelOptions, RenderOptions, TrainOptions
from ..models import init_autoencoder, init_hidden, padded_resolution, prepare_inference
from ..models.inference import apply_frame_fast_padded
from ..render import render_gbuffer_frame
from ..scene import derive_camera, load_scene, orbit_camera, orbit_params_from_camera
from ..train import init_train_state, train_step
from ..train.device_data import _crop_batch
from ..utils import timers

WIDTHS = (32, 43, 57, 76, 101)
BATCH, SEQ, CROP = 4, 7, 256
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORT = os.path.join(REPO, "ai_path_tracer_denoiser_tpu_torch")
OUTSIDE = "outside the port"


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def _site(stack) -> str:
    """A warning's location: the innermost frame of the port's package,
    and the innermost frame of all where that lies elsewhere (the warnings
    module's own frames left out)."""
    while len(stack) > 1 and stack[-1].filename.endswith("warnings.py"):
        stack = stack[:-1]
    inner = stack[-1]
    mine = next((f for f in reversed(stack) if f.filename.startswith(PORT)
                 and not f.filename.endswith("span_audit.py")), None)
    where = (f"{os.path.relpath(mine.filename, REPO)}:{mine.lineno}" if mine is not None
             else OUTSIDE)
    if mine is not inner:
        where += f" <- {os.path.basename(inner.filename)}:{inner.lineno} {inner.name}"
    return where


def audited(fn, top: str, device):
    """Run ``fn`` once under the sync debug mode (on a card): (warnings by
    location, the ``sync.*`` counts of the newest ``top`` record)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    where = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            where[_site(traceback.extract_stack()[:-1])] += 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    if cuda:
        torch.cuda.synchronize()
    rec = timers.records(top)[-1]
    counted = {k: v for k, v in rec["counts"].items() if k.startswith("sync.")}
    return where, counted


def in_port(where) -> int:
    """Warnings raised with a frame of the port on the stack."""
    return sum(n for site, n in where.items() if not site.startswith(OUTSIDE))


def frame_scene(name: str, device, res: int):
    scene = load_scene(os.path.join(REPO, "scenes", name), device=device)
    c = scene.camera
    if tuple(c.resolution) != (res, res):
        scene = dataclasses.replace(scene, camera=derive_camera(
            (res, res), float(c.fov[1]), c.position.numpy(), c.look_at.numpy(),
            c.up.numpy()))
    return scene


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def audit_frames(emit, device="cuda", res=800, widths=WIDTHS):
    opts = RenderOptions(rng="parity", backend="auto")
    mopts = ModelOptions(widths=widths)
    params, bn = init_autoencoder(torch.Generator().manual_seed(0), mopts)
    folded = prepare_inference(to_device(params, device), to_device(bn, device), mopts)
    hidden = init_hidden(1, *padded_resolution(res, res), mopts, dtype=torch.bfloat16,
                         device=device)
    for name in ("cornell_mesh_statue.txt", "cornell_box.txt"):
        scene = frame_scene(name, device, res)
        render_gbuffer_frame(scene, opts)                       # builds, warms
        where, counted = audited(lambda: render_gbuffer_frame(scene, opts), "render.frame",
                                 device)
        gbuf = render_gbuffer_frame(scene, opts)[1]
        x = gbuf.permute(1, 2, 0)[None]
        apply_frame_fast_padded(folded, x, hidden, mopts)
        d_where, d_counted = audited(lambda: apply_frame_fast_padded(folded, x, hidden, mopts),
                                     "denoise.frame", device)
        emit({"phase": "sync_audit", "scene": name,
              "render_warnings": in_port(where), "render_counted": sum(counted.values()),
              "render_warnings_at": dict(where), "render_counted_by_site": counted,
              "denoise_warnings": in_port(d_where),
              "denoise_counted": sum(d_counted.values()),
              "denoise_warnings_at": dict(d_where),
              "binned_calls": {k: v for k, v in timers.records("render.frame")[-1]["counts"]
                               .items() if k.startswith("binned.")}})


def audit_orbit(emit, device="cuda", res=800, steps=range(0, 360, 12)):
    """The statue frame along the benchmark's orbit (0.01 rad a frame from
    the scene's camera): reads counted, bounces traced (one read of the
    geoms' materials each; a frame stops once every path has ended) and
    host ms, at every 12th frame."""
    opts = RenderOptions(rng="parity", backend="auto")
    scene = frame_scene("cornell_mesh_statue.txt", device, res)
    phi, theta, zoom = orbit_params_from_camera(scene.camera)
    out = []
    for k in steps:
        cam = orbit_camera(scene.camera, phi + 0.01 * k, theta, zoom)
        render_gbuffer_frame(dataclasses.replace(scene, camera=cam), opts)
        rec = timers.records("render.frame")[-1]
        out.append({"frame": k, "reads": sum(v for n, v in rec["counts"].items()
                                             if n.startswith("sync.")),
                    "bounces": rec["counts"]["sync.geom_materials"],
                    "host_ms": rec["spans"]["render.frame"] * 1e-6})
    emit({"phase": "orbit", "scene": "cornell_mesh_statue.txt", "degrees_per_frame":
          math.degrees(0.01), "frames": out})


def audit_train(emit, device="cuda", crop=CROP, widths=WIDTHS):
    topt = TrainOptions(bf16_compute=True, batch_size=BATCH, sequence_length=SEQ,
                        crop_size=crop)
    mopts = ModelOptions(widths=widths)
    state = init_train_state(torch.Generator().manual_seed(0), mopts, topt, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    X = torch.rand(16, 2 * crop, 2 * crop, 10, generator=g, device=device).to(torch.bfloat16)
    Y = torch.rand(16, 2 * crop, 2 * crop, 3, generator=g, device=device).to(torch.bfloat16)
    starts, cys, cxs = [0, 3, 6, 9], [0, crop, 0, crop], [crop, 0, 0, crop]
    x, y = _crop_batch(X, Y, starts, cys, cxs, SEQ, crop, crop)
    state, _ = train_step(state, x, y, topt, mopts)

    def one():
        xx, yy = _crop_batch(X, Y, starts, cys, cxs, SEQ, crop, crop)
        train_step(state, xx, yy, topt, mopts)
    where, counted = audited(one, "train.step", device)
    crop = timers.records("train.crop")[-1]["counts"]
    emit({"phase": "sync_audit", "scene": "train_step", "warnings": in_port(where),
          "counted": sum(counted.values()) + sum(v for k, v in crop.items()
                                                 if k.startswith("sync.")),
          "warnings_at": dict(where), "counted_by_site": counted,
          "phases_ms": {k: v * 1e-6 for k, v in timers.records("train.step")[-1]["spans"]
                        .items()}})


def span_cost(n: int):
    """Microseconds per span: (top-level, nested one deep), back to back."""
    def top():
        t = time.perf_counter()
        for _ in range(n):
            with timers.span("audit.top"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    def nested():
        with timers.span("audit.outer"):
            t = time.perf_counter()
            for _ in range(n):
                with timers.span("audit.inner"):
                    pass
            return (time.perf_counter() - t) / n * 1e6

    def bare():
        t = time.perf_counter()
        for _ in range(n):
            pass
        return (time.perf_counter() - t) / n * 1e6
    base = min(bare() for _ in range(3))
    return (min(top() for _ in range(3)) - base, min(nested() for _ in range(3)) - base,
            base)


def measure_cost(emit, n_off: int, n_on: int):
    from torch.profiler import ProfilerActivity, profile
    off_top, off_nested, loop = span_cost(n_off)
    gate = []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(n_off):
            torch._C._autograd._profiler_enabled()
        gate.append((time.perf_counter() - t) / n_off * 1e6 - loop)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on_top, on_nested, _ = span_cost(n_on)
    emit({"phase": "span_cost", "off_us": {"top": off_top, "nested": off_nested},
          "on_us": {"top": on_top, "nested": on_nested}, "gate_us": min(gate),
          "spans_off": n_off, "spans_on": n_on})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans-off", type=int, default=200_000)
    ap.add_argument("--spans-on", type=int, default=20_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_audit needs an NVIDIA GPU")
    info = card()

    def emit(d):
        print(json.dumps({**d, "card": info}), flush=True)
    timers.reset()
    audit_frames(emit)
    audit_orbit(emit)
    audit_train(emit)
    measure_cost(emit, args.spans_off, args.spans_on)


if __name__ == "__main__":
    main()
