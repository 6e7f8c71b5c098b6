"""Times the binned mesh pipeline's kernels, K5 (bin subscription,
csrc/mesh_binned_phase1.cu) and K6 (pair test, csrc/mesh_binned_pair.cu),
on every call of one statue frame, and builds of their sources with small
edits (``VARIANTS``): how their shapes and branches were chosen.

Records every K5 and K6 call of frame 0 of the statue (and, with
``--scenes``, of other mesh scenes) rendered through the binned pipeline at
its own 800x800, and prints one JSON line with each call's live rays
(t_cull above -inf) or live pairs (a real key), then the shipped kernels'
time per frame, each call timed alone as chip_smoke.py times them: CUDA
events around 5 calls back to back (``ms``) and device time, 5 calls
captured in a CUDA graph and replayed (``device_ms``).

With ``--variants`` it also builds each variant (a copy of the source with
the variant's edits, one nvcc per build, all at once), checks that every
build returns the plain version's results bit for bit on every call, and
prints the device time per frame of each variant and of the shipped
build, in ``--rounds`` rounds that alternate the order of the builds; then
every build's registers and inner-loop instructions per test
(tools/sass_count.py).  The last line is the card's name and power limit.

Run on an NVIDIA GPU, from the repository root (it uses chip_smoke.py's
timers):
    python -m ai_path_tracer_denoiser_tpu_torch.tools.binned_sweep [--variants]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess

import torch

from ..config import RenderOptions
from ..render import mesh_binned, render_gbuffer_frame
from ..scene import load_scene, orbit_camera, orbit_params_from_camera
from ..utils.cuda_build import CudaKernel, build_all, edited_build, swapped
from .sass_count import count_library

REPS = 5
# name: (kernel, [(text of the source, its replacement)]); each text must
# occur exactly once in the source
VARIANTS = {
    "k5_nan_rule_always": ("phase1", [("if (warp_no_nan && rows_finite)", "if (false)")]),
    "k5_64_threads": ("phase1", [("kThreads = 128;", "kThreads = 64;")]),
    "k5_256_threads": ("phase1", [("kThreads = 128;", "kThreads = 256;")]),
    "k5_1_lane_per_ray": ("phase1", [("kLpr = 2;", "kLpr = 1;")]),
    "k5_4_lanes_per_ray": ("phase1", [("kLpr = 2;", "kLpr = 4;")]),
    "k6_64_pairs": ("pair", [("kPairs = 128;", "kPairs = 64;")]),
    "k6_256_pairs": ("pair", [("kPairs = 128;", "kPairs = 256;")]),
}
# kernel: (the wrapper's module attribute, wrapper, plain version, unit of sass_count)
KINDS = {"phase1": ("PHASE1_KERNEL", "_phase1", "_phase1_plain", "slab"),
         "pair": ("PAIR_KERNEL", "_pair_call", "_pair_plain", "face")}


def record_calls(scene):
    """The positional arguments of every K5 and K6 call of one frame
    rendered through the binned pipeline."""
    calls = {kind: [] for kind in KINDS}
    saved = {kind: getattr(mesh_binned, KINDS[kind][1]) for kind in KINDS}

    def recorder(kind):
        def wrapped(*args, **kwargs):
            calls[kind].append(args)
            return saved[kind](*args, **kwargs)
        return wrapped

    for kind in KINDS:
        setattr(mesh_binned, KINDS[kind][1], recorder(kind))
    try:
        render_gbuffer_frame(scene, RenderOptions(mesh_kernel_impl="binned"))
    finally:
        for kind, fn in saved.items():
            setattr(mesh_binned, KINDS[kind][1], fn)
    torch.cuda.synchronize()
    return calls


def launching(kind: str, kernel: CudaKernel):
    """The kernel's wrapper launching another build."""
    return swapped(mesh_binned, KINDS[kind][0], kernel)


def variant_build(name: str) -> CudaKernel:
    """A build of the shipped source with the variant's edits, written
    into the build directory."""
    kind, edits = VARIANTS[name]
    return edited_build(getattr(mesh_binned, KINDS[kind][0]), name, edits)


def frame_ms(calls, kind, timer) -> list:
    """Milliseconds of each of the frame's calls of one kernel."""
    fn = getattr(mesh_binned, KINDS[kind][1])
    return [timer(lambda a=a: fn(*a)) for a in calls[kind]]


def describe(kind: str, kernel: CudaKernel) -> dict:
    kernel.lib()
    return {"ptxas": [ln.strip() for ln in kernel.build_log.splitlines() if "registers" in ln],
            "sass": count_library(kernel.library_path(), KINDS[kind][3])}


def variants(scene_name, calls, rounds, graph_ms):
    """Every variant on one frame's calls: equal to the plain versions,
    then timed against the shipped build."""
    builds = {name: variant_build(name) for name in VARIANTS}
    build_all(list(builds.values()))
    want = {kind: [getattr(mesh_binned, KINDS[kind][2])(*a) for a in calls[kind]]
            for kind in KINDS}
    for name, k in builds.items():
        kind = VARIANTS[name][0]
        with launching(kind, k):
            fn = getattr(mesh_binned, KINDS[kind][1])
            equal = all(all(torch.equal(g, w) for g, w in zip(fn(*a), ref))
                        for a, ref in zip(calls[kind], want[kind]))
        if not equal:
            raise RuntimeError(f"{name} differs from the plain version on {scene_name}")
    runs = [(kind, "shipped", getattr(mesh_binned, KINDS[kind][0])) for kind in KINDS]
    runs += [(VARIANTS[name][0], name, k) for name, k in builds.items()]
    for rnd in range(rounds):
        ms = {}
        for kind, name, k in (runs if rnd % 2 == 0 else runs[::-1]):
            with launching(kind, k):
                ms[f"{kind}:{name}"] = sum(frame_ms(calls, kind, lambda f: graph_ms(f, REPS)))
        print(json.dumps({"scene": scene_name, "round": rnd,
                          "device_ms_per_frame_by_build": ms}), flush=True)
    for name, k in builds.items():
        print(json.dumps({"scene": scene_name, "build": name,
                          "equal_to_plain_on_every_call": True,
                          **describe(VARIANTS[name][0], k)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", nargs="+", default=["cornell_mesh_statue.txt"])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("binned_sweep: needs an NVIDIA GPU")
    from chip_smoke import graph_ms, time_ms
    dev = torch.device("cuda")
    build_all([mesh_binned.PHASE1_KERNEL, mesh_binned.PAIR_KERNEL])
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name in args.scenes:
        sc = load_scene(os.path.join(root, "scenes", name), device=dev)
        ph, th, zm = orbit_params_from_camera(sc.camera)
        sc = dataclasses.replace(sc, camera=orbit_camera(sc.camera, ph, th, zm))
        calls = record_calls(sc)
        print(json.dumps({"scene": name, "phase1_calls": [
            {"rays": a[2].shape[0], "live_rays": int((a[2] > float("-inf")).sum()),
             "bins": a[4], "skip": a[5], "c_out": a[6]} for a in calls["phase1"]],
            "pair_calls": [{"pairs": a[2].shape[0],
                            "live_pairs": int(((a[2] >= 0) & (a[2] < a[4])).sum())}
                           for a in calls["pair"]]}), flush=True)
        for label, timer in (("ms", lambda f: time_ms(f, REPS, warmup=1)),
                             ("device_ms", lambda f: graph_ms(f, REPS))):
            t = {kind: frame_ms(calls, kind, timer) for kind in KINDS}
            print(json.dumps({"scene": name, "timing": label, "per_call": t,
                              "frame": {k: sum(v) for k, v in t.items()}}), flush=True)
        if args.variants:
            variants(name, calls, args.rounds, graph_ms)
    print(json.dumps({"shipped": {kind: describe(kind, getattr(mesh_binned, KINDS[kind][0]))
                                  for kind in KINDS}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
