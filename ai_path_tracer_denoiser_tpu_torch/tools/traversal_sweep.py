"""Times the two tile traversals, K7 (csrc/mesh_bvh_v2.cu, the tile-gated
index-order descent, at 128 and 1024 lanes) and K8 (csrc/mesh_bvh_v3.cu,
front to back by 128-ray subtiles), on whole frames: how their launch
shapes were chosen, and the A/B of a change to them.

Records every traversal call of frame 0 of the blob and of the statue at
their own 800x800, with the carry sort (the default) and without (the
calls are the same rays whatever traversal renders the frame).  For each
frame and traversal it prints one JSON line per round with the frame's
milliseconds two ways: device time (the frame's calls captured in one CUDA
graph and replayed, ``device_ms``) and CUDA events around each call alone
(the mean of 3 after a warm-up, summed over the calls: ``events_ms``, the
measure of chip_smoke.py's traversal table), and the frame's visits (the
(tile, cluster) pairs the kernel ran face tests for, its own count).
Rounds alternate the order of the traversals.

With ``--variants`` it also builds the sources with the edits of
``VARIANTS`` (other launch shapes), checks every build against the shipped
one bit for bit and visit for visit on every call of the four frames, and
prints each build's device ms per frame in ``--rounds`` rounds that
alternate their order.

It also runs on a tree whose traversals are the first versions (no visit
count): it then times what that tree's wrappers launch, so that one call
can time both sides of a change.  Then it prints the registers, stack and
spills of each build (``tools/sass_count.resource_usage``), and last the
card's name and power limit.

Run on an NVIDIA GPU, from the repository root (it uses chip_smoke.py's
timers):
    python -m ai_path_tracer_denoiser_tpu_torch.tools.traversal_sweep [--variants]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import os
import subprocess

import torch

from ..render import mesh_kernel, mesh_kernel_v3
from ..scene import load_scene, orbit_camera, orbit_params_from_camera
from ..utils.cuda_build import CudaKernel, build_all, edited_build, swapped
from .k4_sweep import flat, record_calls
from .sass_count import resource_usage

SCENES = {"blob": "cornell_mesh_blob.txt", "statue": "cornell_mesh_statue.txt"}
# traversal: (module whose KERNEL it launches, lanes; None for K8)
TRAVERSALS = {"k7@128": (mesh_kernel, 128), "k7@1024": (mesh_kernel, 1024),
              "k8": (mesh_kernel_v3, None)}


def blocks_per_sm(tiles_line: str, per_sm: int):
    """The edit that launches ``per_sm`` persistent blocks per SM instead of
    the resident wave: it sets ``wave`` after the line that counts the
    tiles."""
    return (tiles_line, f"""{tiles_line}
  int dev_ = 0, sms_ = 0;
  cudaGetDevice(&dev_);
  cudaDeviceGetAttribute(&sms_, cudaDevAttrMultiProcessorCount, dev_);
  wave = {per_sm} * sms_;""")


# name: (module, [(text of its source, its replacement)]); each text must
# occur exactly once in the source
VARIANTS = {
    "k7_one_block_per_sm": (mesh_kernel, [
        blocks_per_sm("  const int tiles = (n + lanes - 1) / lanes;", 1)]),
    "k8_two_blocks_per_sm": (mesh_kernel_v3, [
        blocks_per_sm("  const int tiles = (n + kLanes - 1) / kLanes;", 2)]),
}
REPS = 3


def counts_visits() -> bool:
    """Whether this tree's traversals count their visits."""
    return "visit_counter" in inspect.signature(mesh_kernel.mesh_intersect_bvh).parameters


def call(traversal: str, args, visit_counter=None):
    """One call of ``traversal`` on the recorded arguments (bvh, o, d, t_cull)."""
    module, lanes = TRAVERSALS[traversal]
    extra = {} if visit_counter is None else {"visit_counter": visit_counter}
    if lanes is None:
        return module.mesh_intersect_bvh_v3(*args, **extra)
    return module.mesh_intersect_bvh(*args, lanes=lanes, **extra)


def frame_visits(traversal: str, calls) -> int:
    """The visits of one frame's calls through ``traversal``, summed."""
    counter = torch.zeros(1, dtype=torch.int32, device=calls[0][3].device)
    total = 0
    for args in calls:
        call(traversal, args, counter)
        total += int(counter.item())
    return total


def frame_calls(root: str, dev):
    """{(scene, carry-sorted): recorded calls} of the four frames."""
    frames = {}
    for name, path in SCENES.items():
        sc = load_scene(os.path.join(root, "scenes", path), device=dev)
        ph, th, zm = orbit_params_from_camera(sc.camera)
        sc = dataclasses.replace(sc, camera=orbit_camera(sc.camera, ph, th, zm))
        for octant_sort in (True, False):
            frames[name, octant_sort] = record_calls(sc, octant_sort)
    return frames


def measure(traversal: str, calls, time_ms, graph_ms) -> dict:
    """Device and events ms of one frame's calls through ``traversal``."""
    out = {"device_ms": graph_ms(lambda: [call(traversal, a) for a in calls], REPS),
           "events_ms": sum(time_ms(lambda a=a: call(traversal, a), REPS, warmup=1)
                            for a in calls)}
    if counts_visits():
        out["visits"] = frame_visits(traversal, calls)
    return out


def launching(module, kernel: CudaKernel):
    """``module``'s wrapper launching another build of its source."""
    return swapped(module, "KERNEL", kernel)


def variant_builds():
    """(traversals it serves, build) for every variant."""
    return [(("k8",) if module is mesh_kernel_v3 else ("k7@128", "k7@1024"),
             edited_build(module.KERNEL, name, edits))
            for name, (module, edits) in VARIANTS.items()]


def variants(frames, rounds, graph_ms):
    """Every variant build against the shipped one (outputs and visits on
    every call of the four frames), then device ms per frame in rounds;
    returns the builds."""
    builds = variant_builds()
    build_all([b for _, b in builds])
    want = {(f, tr): ([flat(call(tr, a)) for a in calls], frame_visits(tr, calls))
            for f, calls in frames.items() for tr in TRAVERSALS}
    runs = [("shipped", tr, None) for tr in TRAVERSALS]
    for served, build in builds:
        module = TRAVERSALS[served[0]][0]
        with launching(module, build):
            for tr in served:
                for f, calls in frames.items():
                    got = [flat(call(tr, a)) for a in calls]
                    equal = all(all(torch.equal(g, w) for g, w in zip(gc, wc))
                                for gc, wc in zip(got, want[f, tr][0]))
                    visits = frame_visits(tr, calls)
                    if not equal or visits != want[f, tr][1]:
                        raise RuntimeError(f"{build.name} ({tr}) on {f}: equal {equal}, "
                                           f"visits {visits} against {want[f, tr][1]}")
                runs.append((build.name, tr, build))
    print(json.dumps({"variants_equal_to_shipped": [f"{n}:{tr}" for n, tr, b in runs if b]}),
          flush=True)
    for rnd in range(rounds):
        for (scene, octant_sort), calls in frames.items():
            ms = {}
            for label, tr, build in (runs if rnd % 2 == 0 else runs[::-1]):
                module = TRAVERSALS[tr][0]
                with launching(module, build) if build else contextlib.nullcontext():
                    ms[f"{label}:{tr}"] = graph_ms(lambda: [call(tr, a) for a in calls], REPS)
            print(json.dumps({"round": rnd, "scene": scene, "rays_carry_sorted": octant_sort,
                              "columns": "build:traversal", "device_ms_by_build": ms}),
                  flush=True)
    return builds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("traversal_sweep: needs an NVIDIA GPU")
    from chip_smoke import graph_ms, time_ms
    dev = torch.device("cuda")
    build_all([mesh_kernel.KERNEL, mesh_kernel_v3.KERNEL])
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    frames = frame_calls(root, dev)
    names = list(TRAVERSALS)
    builds = [mesh_kernel.KERNEL, mesh_kernel_v3.KERNEL]
    for rnd in range(args.rounds):
        for (scene, octant_sort), calls in frames.items():
            row = {tr: measure(tr, calls, time_ms, graph_ms)
                   for tr in (names if rnd % 2 == 0 else names[::-1])}
            print(json.dumps({"round": rnd, "scene": scene, "rays_carry_sorted": octant_sort,
                              "launches_per_frame": len(calls),
                              **{tr: row[tr] for tr in names}}), flush=True)
    if args.variants and counts_visits():
        builds += [b for _, b in variants(frames, args.rounds, graph_ms)]
    print(json.dumps({"registers": {k.name: resource_usage(k.library_path()) for k in builds}}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
