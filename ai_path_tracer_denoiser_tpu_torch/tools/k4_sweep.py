"""The live-ray threshold sweep of the per-ray traversal kernel K4
(csrc/mesh_bvh_v2p.cu): how ``mesh_kernel_v2p.K_THR`` was chosen.

Records every K4 call of frame 0 of the blob and of the statue at their
own 800x800, with the carry sort (the default) and without; builds K4 at
each threshold (one nvcc per build, all at once); checks that every build
returns the shipped K4's results bit for bit; and prints one JSON line per
frame and round with the frame's milliseconds at each threshold (each call
timed alone with CUDA events, the mean of 3 after one warm-up, as
chip_smoke.py times its traversal table, summed over the frame's calls).
Rounds alternate the order of the builds.  The last line is the card's
name and power limit.

Run on an NVIDIA GPU:  python -m ai_path_tracer_denoiser_tpu_torch.tools.k4_sweep
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess

import torch

from ..config import RenderOptions
from ..render import mesh_kernel_v2p, render_gbuffer_frame
from ..scene import load_scene, orbit_camera, orbit_params_from_camera
from ..utils.cuda_build import CudaKernel, build_all, swapped

THRESHOLDS = (1, 2, 4, 8, 12, 16, 24, 33)   # 1: every cluster lane by ray; 33: ray by ray
SCENES = ("cornell_mesh_blob.txt", "cornell_mesh_statue.txt")
REPS = 3


def launching(kernel: CudaKernel):
    """K4's wrapper launching another build of its source."""
    return swapped(mesh_kernel_v2p, "KERNEL", kernel)


def record_calls(scene, octant_sort: bool):
    """The positional arguments of every K4 call of one frame."""
    calls = []
    orig = mesh_kernel_v2p.mesh_intersect_bvh_v2p

    def wrapped(*args, **kwargs):
        calls.append(args[:4])
        return orig(*args, **kwargs)

    mesh_kernel_v2p.mesh_intersect_bvh_v2p = wrapped
    try:
        render_gbuffer_frame(scene, RenderOptions(mesh_kernel_impl="v2p",
                                                  mesh_octant_sort=octant_sort))
    finally:
        mesh_kernel_v2p.mesh_intersect_bvh_v2p = orig
    torch.cuda.synchronize()
    return calls


def frame_ms(calls) -> float:
    """Milliseconds of one frame's K4 calls, each timed alone."""
    total = 0.0
    for args in calls:
        mesh_kernel_v2p.mesh_intersect_bvh_v2p(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            mesh_kernel_v2p.mesh_intersect_bvh_v2p(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) / REPS
    return total


def flat(result):
    t, p, n, mat = result
    return (t, *p, *n, mat)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_sweep: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    builds = {k: (mesh_kernel_v2p.KERNEL if k == mesh_kernel_v2p.K_THR
                  else mesh_kernel_v2p.kernel_build(k, f"mesh_bvh_v2p_kthr{k}"))
              for k in THRESHOLDS}
    build_all(list(builds.values()))
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name in SCENES:
        sc = load_scene(os.path.join(root, "scenes", name), device=dev)
        ph, th, zm = orbit_params_from_camera(sc.camera)
        sc = dataclasses.replace(sc, camera=orbit_camera(sc.camera, ph, th, zm))
        for octant_sort in (True, False):
            calls = record_calls(sc, octant_sort)
            want = [flat(mesh_kernel_v2p.mesh_intersect_bvh_v2p(*a)) for a in calls]
            for rnd in range(args.rounds):
                order = THRESHOLDS if rnd % 2 == 0 else THRESHOLDS[::-1]
                ms = {}
                for k in order:
                    with launching(builds[k]):
                        equal = all(all(torch.equal(g, w) for g, w in zip(
                            flat(mesh_kernel_v2p.mesh_intersect_bvh_v2p(*a)), ref))
                            for a, ref in zip(calls, want))
                        if not equal:
                            raise RuntimeError(f"K4 at K_THR={k} differs from K_THR="
                                               f"{mesh_kernel_v2p.K_THR} on {name}")
                        ms[k] = frame_ms(calls)
                print(json.dumps({"scene": name, "rays_carry_sorted": octant_sort,
                                  "round": rnd, "launches_per_frame": len(calls),
                                  "frame_ms_by_k_thr": {k: ms[k] for k in THRESHOLDS},
                                  "builds_equal_to_shipped": True}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
