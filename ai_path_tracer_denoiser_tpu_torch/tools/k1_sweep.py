"""Times the render megakernel K1 (csrc/render_megakernel.cu) at the shapes
that launch it, and its launch shapes against each other: how the shipped
threads per block, blocks per SM and pixel chunk were chosen.

Two shapes: the interactive frame (scenes/cornell_box.txt at its own
800x800, depth 8, one iteration, the orbit's frame 0) and a datagen
ground-truth launch (the same scene at 512x512, 64 iterations).  For each
it prints one JSON line with K1's time per launch two ways: CUDA events
around launches through ``render_cuda`` back to back (``events_ms``, the
measure chip_smoke.py's ``kernels`` line gives; the scene packing and the
buffer copies of each call included) and device time, launches of the
kernel alone on buffers packed once, captured in a CUDA graph and replayed
(``device_ms``); the lane efficiency of one pixel per thread, from the
plain version's per-pixel segment counts (``render/cuda_backend.py``:
``path_segments``, ``lane_efficiency``), and the kernel's own (lane-steps
counted by the kernel, where its launcher takes ``stats``); the device time
of the one-pixel-per-thread witness build where the tree has one.  Then
each build's registers, stack and local memory (``cuobjdump -res-usage``)
and its SASS instructions per box test and per sphere test
(tools/sass_count.py, ``--per geom``, on two builds of the source whose
geom loop holds only boxes or only spheres and whose face loop is compiled
out).

With ``--variants`` it also times every launch shape of ``VARIANTS`` and
builds capped at ``REG_CAPS`` registers on both shapes, and with
``--sources`` builds of other versions of the source (the same C
interface), in ``--rounds`` rounds that alternate their order, after
checking each against the shipped kernel bit for bit.

It also runs on a tree from before ``render_cuda`` was split into packing
and ``launch_megakernel`` (it then launches the library's entry point with
that tree's arguments), so that one call can time both sides of a change.

Run on an NVIDIA GPU, from the repository root (it uses chip_smoke.py's
timers):
    python -m ai_path_tracer_denoiser_tpu_torch.tools.k1_sweep [--variants]
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess

import numpy as np
import torch

from ..config import RenderOptions
from ..render import cuda_backend, init_render_state
from ..scene import derive_camera, load_scene, orbit_camera, orbit_params_from_camera
from ..utils.cuda_build import (BASE_FLAGS, BUILD_DIR, CSRC_DIR, CudaKernel, build_all, check,
                                rebuilt)
from .sass_count import count_library, resource_usage

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENE = os.path.join(ROOT, "scenes", "cornell_box.txt")
# name: (resolution, None = the scene's own with the orbit's frame 0; iterations per launch)
SHAPES = {"cornell_800_niter1": (None, 1), "cornell_512_niter64": (512, 64)}
REPS = {"cornell_800_niter1": 20, "cornell_512_niter64": 5}
# launch shapes: (threads per block, blocks per SM (0: as many as fit), pixels per chunk)
VARIANTS = list(itertools.product((64, 128, 256), (4, 0), (16, 32, 64)))
# builds of the shipped source with a register cap (more blocks fit on an SM),
# each timed at every thread count with as many blocks as fit and chunk 32
REG_CAPS = (64, 72, 80)
# geom loop with one kind of geom and no face loop, for counting its instructions
SASS_EDITS = {"box": [("gtype[g] == kCube", "true"), ("n_faces > 0 &&", "false &&")],
              "sphere": [("gtype[g] == kCube", "false"), ("n_faces > 0 &&", "false &&")]}


def shape_scene(name: str, dev):
    """(scene, iterations per launch) of one of ``SHAPES``."""
    res, niter = SHAPES[name]
    scene = load_scene(SCENE, device=dev)
    c = scene.camera
    if res is None:
        ph, th, zm = orbit_params_from_camera(c)
        cam = orbit_camera(c, ph, th, zm)
    else:
        cam = derive_camera((res, res), float(c.fov[1]), c.position.numpy(),
                            c.look_at.numpy(), c.up.numpy())
    return dataclasses.replace(scene, camera=cam), niter


def packed_launch(scene, options: RenderOptions, niter: int, kernel=None, **launch):
    """A function that launches K1 once for a whole frame of ``scene`` at
    iteration 0, on buffers packed once (accumulating into them), and the
    buffers: (run, acc, gbuf).  ``launch``: launch shape and ``stats``."""
    state = init_render_state(scene, options)
    acc, gbuf = state.accum.clone(), state.gbuf.clone()
    floats, ints = cuda_backend.pack_scene(scene)
    cam = scene.camera
    cam_row = np.concatenate([cam.position.numpy(), cam.view.numpy(), cam.up.numpy(),
                              cam.right.numpy(), cam.pixel_length.numpy()]).astype(np.float32)
    w, h = cam.resolution
    counts = (scene.geoms.count, scene.materials.count, scene.mesh.num_faces)
    flags = cuda_backend._flags(options)
    if hasattr(cuda_backend, "launch_megakernel"):
        def run():
            cuda_backend.launch_megakernel(
                floats, ints, cam_row, acc, gbuf, counts=counts, resolution=(w, h),
                depth=scene.trace_depth, flags=flags, niter=niter, kernel=kernel, **launch)
    else:
        if launch or kernel is not None:
            raise ValueError("this tree's K1 takes no launch shape")
        lib = cuda_backend.KERNEL.lib()

        def run():   # the entry point of a tree from before launch_megakernel
            rc = lib.aptd_render_megakernel(
                floats.data_ptr(), ints.data_ptr(), *counts, cam_row.ctypes.data, w, h,
                w * h, 0, 0, niter, 0, scene.trace_depth, flags, acc.data_ptr(),
                gbuf.data_ptr(), torch.cuda.current_stream().cuda_stream)
            check(rc, "render megakernel")
    return run, acc, gbuf


def kernel_lane_efficiency(scene, options, niter):
    """Segments over lane-steps as the kernel counts them, or None where
    its launcher takes no ``stats``."""
    if not hasattr(cuda_backend, "launch_megakernel"):
        return None
    stats = torch.zeros(2, dtype=torch.int64, device=scene.device)
    run, _, _ = packed_launch(scene, options, niter, stats=stats)
    run()
    lane_steps, segments = stats.tolist()
    return {"segments": segments, "lane_steps": lane_steps,
            "lane_efficiency": segments / max(lane_steps, 1)}


def measure(name: str, dev, time_ms, graph_ms) -> dict:
    """K1 at one of ``SHAPES``: events and device time per launch, lane
    efficiencies."""
    scene, niter = shape_scene(name, dev)
    opts = RenderOptions()
    state0 = init_render_state(scene, opts)
    reps = REPS[name]
    out = {"shape": name, "res": list(scene.camera.resolution), "niter": niter,
           "depth": scene.trace_depth,
           "events_ms": time_ms(lambda: cuda_backend.render_cuda(scene, opts, niter, state0),
                                reps, warmup=1)}
    run, _, _ = packed_launch(scene, opts, niter)
    out["device_ms"] = graph_ms(run, reps)
    if hasattr(cuda_backend, "WITNESS"):
        run, _, _ = packed_launch(scene, opts, niter, kernel=cuda_backend.WITNESS)
        out["witness_device_ms"] = graph_ms(run, reps)
    if hasattr(cuda_backend, "path_segments"):
        seg = cuda_backend.path_segments(scene, opts, niter, state0)
        out["segments"] = int(seg.sum())
        out["one_pixel_per_thread_lane_efficiency"] = cuda_backend.lane_efficiency(seg)
        out["segments_per_path"] = float(seg.float().mean())
    out["kernel"] = kernel_lane_efficiency(scene, opts, niter)
    return out


def sass_build(kind: str) -> CudaKernel:
    """The shipped source with ``SASS_EDITS[kind]``, built into the build
    directory (never launched)."""
    shipped = cuda_backend.KERNEL
    with open(shipped.source) as f:
        text = f.read()
    for old, new in SASS_EDITS[kind]:
        if old not in text:
            raise ValueError(f"{kind}: {old!r} not in {shipped.source}")
        text = text.replace(old, new)
    path = os.path.join(BUILD_DIR, "variants", f"render_megakernel_{kind}_only.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return CudaKernel(f"render_megakernel_{kind}_only", path,
                      extra_flags=shipped.flags[len(BASE_FLAGS):] + (f"-I{CSRC_DIR}",))


def reg_cap_build(regs: int) -> CudaKernel:
    shipped = cuda_backend.KERNEL
    return CudaKernel(f"render_megakernel_regs{regs}", os.path.basename(shipped.source),
                      extra_flags=shipped.flags[len(BASE_FLAGS):] + (f"-maxrregcount={regs}",),
                      declare=cuda_backend._declare)


def variants(dev, rounds, graph_ms, launch_shapes, caps, sources):
    """Every launch shape of ``launch_shapes``, every register-capped build
    and every other source: equal to the shipped kernel bit for bit on both
    shapes, then device ms per launch."""
    runs = [(f"{t}x{b}x{c}", None, dict(threads=t, blocks_per_sm=b, chunk=c))
            for t, b, c in launch_shapes]
    runs += [(f"regs{r}:{t}x0x32", k, dict(threads=t, blocks_per_sm=0, chunk=32))
             for r, k in caps.items() for t in (64, 128, 256)]
    runs += [(f"{k.name}:shipped shape", k, {}) for k in sources]
    runs += [("shipped", None, {})]
    cases = {}
    for name in SHAPES:
        scene, niter = shape_scene(name, dev)
        run, acc, gbuf = packed_launch(scene, RenderOptions(), niter)
        run()
        cases[name] = (scene, niter)
        for label, kernel, shape in runs:
            vrun, vacc, vgbuf = packed_launch(scene, RenderOptions(), niter, kernel=kernel,
                                              **shape)
            vrun()
            if not (torch.equal(vacc, acc) and torch.equal(vgbuf, gbuf)):
                raise RuntimeError(f"K1 {label} differs from the shipped kernel on {name}")
    for rnd in range(rounds):
        ms = {name: {} for name in SHAPES}
        for label, kernel, shape in (runs if rnd % 2 == 0 else runs[::-1]):
            for name, (scene, niter) in cases.items():
                run, _, _ = packed_launch(scene, RenderOptions(), niter, kernel=kernel, **shape)
                ms[name][label] = graph_ms(run, REPS[name])
        print(json.dumps({"round": rnd, "columns": "[build:] threads x blocks per SM (0: as "
                          "many as fit) x chunk", "device_ms_by_variant": ms}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--no-sass", action="store_true", help="skip the instruction counts")
    ap.add_argument("--sources", nargs="*", default=[],
                    help="other versions of csrc/render_megakernel.cu to time beside it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_sweep: needs an NVIDIA GPU")
    from chip_smoke import graph_ms, time_ms
    dev = torch.device("cuda")
    sass = {} if args.no_sass else {kind: sass_build(kind) for kind in SASS_EDITS}
    builds = [cuda_backend.KERNEL] + ([cuda_backend.WITNESS]
                                      if hasattr(cuda_backend, "WITNESS") else [])
    caps = {r: reg_cap_build(r) for r in REG_CAPS} if args.variants else {}
    sources = [rebuilt(cuda_backend.KERNEL, p) for p in args.sources]
    build_all([*builds, *sass.values(), *caps.values(), *sources])
    for name in SHAPES:
        print(json.dumps(measure(name, dev, time_ms, graph_ms)), flush=True)
    if args.variants or sources:
        variants(dev, args.rounds, graph_ms, VARIANTS if args.variants else [], caps,
                 sources)
    print(json.dumps({
        "registers": {k.name: resource_usage(k.library_path())
                      for k in [*builds, *caps.values(), *sources]},
        "sass_per_test": {kind: count_library(k.library_path(), "geom")
                          for kind, k in sass.items()}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
