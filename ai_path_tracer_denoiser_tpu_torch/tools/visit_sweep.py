"""Times the visit-cost probe's two kernels, K9a (scalar visit,
csrc/mm_visit_vpu.cu) and K9b (tensor-core visit, csrc/mm_visit_mma.cu, in
TF32 and 3xTF32), at the probe's 32,768 visits of one 1024-ray tile, and
their launch shapes against each other: how the shipped shapes were chosen.

For each kernel and mode it prints one JSON line with the time per launch
two ways: CUDA events around launches through the wrapper back to back
(``events_ms``, the measure of chip_smoke.py's ``kernels`` line) and
device time, launches captured in a CUDA graph and replayed
(``device_ms``), with microseconds per visit and the number of blocks the
visits are split over (``splits``); then the same at ``splits`` = 1 (one
block on one SM) at chip_smoke.py's ``PROBE_ONE_SM_VISITS`` visits, the
figure of the first version.  Then,
for the tensor-core visit in each mode, how often its state filter lets a
division run (``division_share``).  Then each build's registers and
spills (the ptxas lines where this process built it, and ``cuobjdump
-res-usage``) and its SASS instructions per division (tools/sass_count.py
``--per face``): per face test in K9a's face loop, per (face, ray) in K9b's
visit loop (the products, fragment loads and hit tests of a visit over its
divisions).

With ``--variants`` it also builds the sources with the edits of
``VARIANTS`` (other block shapes: rays per thread of the scalar visit, warps
per block of the tensor-core visit, and the tensor-core visit without its
state filter, dividing wherever a warp has a hit), with ``--sources``
other versions of the two sources (the same C interface), runs each build
at one block per SM and at as many as fit, checks each against the
shipped build bit for bit at 200 visits, and prints the device time of
each at 32,768 visits in ``--rounds`` rounds that alternate their order.  ``--dump-sass DIR``
writes each build's SASS listing there.

It also runs on a tree whose kernels are the first versions (one block,
no split): it then times what that tree's wrappers launch, so that one
call can time both sides of a change.

Run on an NVIDIA GPU, from the repository root (it uses chip_smoke.py's
timers):
    python -m ai_path_tracer_denoiser_tpu_torch.tools.visit_sweep [--variants]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess

import torch

from . import mm_feasibility as mf
from ..utils.cuda_build import CudaKernel, build_all, edited_build, rebuilt, swapped
from .sass_count import _cuobjdump, count_library, resource_usage

# mode: (kernel, highest); highest None for the scalar visit
MODES = {"scalar": (mf.VPU_KERNEL, None), "tf32": (mf.MMA_KERNEL, False),
         "3xtf32": (mf.MMA_KERNEL, True)}
REPS = 3
# name: (source, [(text of the source, its replacement)]); each text must
# occur exactly once in the source
VARIANTS = {
    "k9a_2_rays_per_thread": ("mm_visit_vpu.cu", [("kRays = 1;", "kRays = 2;")]),
    "k9a_4_rays_per_thread": ("mm_visit_vpu.cu", [("kRays = 1;", "kRays = 4;")]),
    "k9b_8_warps": ("mm_visit_mma.cu", [("kWarps = 16;", "kWarps = 8;")]),
    "k9b_32_warps": ("mm_visit_mma.cu", [("kWarps = 16;", "kWarps = 32;")]),
    "k9b_no_state_filter": ("mm_visit_mma.cu", [
        ("((tn < lim * 1.00000095367431640625f) | (lim < 0x1p-100f))", "true")]),
}
# the state filter of csrc/mm_visit_mma.cu: a hit is divided where
# tn < t_state den (1 + 2^-20), or where t_state den < 2^-100
FILTER_SLACK = 1.00000095367431640625
FILTER_FLOOR = 2.0 ** -100


def split_api() -> bool:
    """Whether this tree's wrappers split the visits over blocks."""
    return hasattr(mf, "visit_ranges")


def launcher(mode, inputs, n_visits, **shape):
    """A function that launches ``mode``'s kernel once through its wrapper;
    ``shape``: ``splits`` and ``visit_counter`` where the tree takes them."""
    rays, faces, coeffs = inputs
    highest = MODES[mode][1]
    if highest is None:
        return lambda: mf.visit_vpu(rays, faces, n_visits, **shape)
    return lambda: mf.visit_mma(rays, coeffs, n_visits, highest, **shape)


def shipped_splits(mode, dev) -> int:
    """The blocks a launch is split over by default (1 on a tree whose
    kernels are the first versions)."""
    return mf.default_splits(dev, MODES[mode][1]) if split_api() else 1


def measure(mode, inputs, n_visits, time_ms, graph_ms, **shape) -> dict:
    """Events and device ms per launch at one shape; the visit count where
    the kernel keeps one."""
    out = {"mode": mode, "visits": n_visits}
    if split_api():
        counter = torch.zeros(1, dtype=torch.int32, device=inputs[0].device)
        launcher(mode, inputs, n_visits, visit_counter=counter, **shape)()
        out["visits_counted"] = int(counter.item())
        if out["visits_counted"] != n_visits:
            raise RuntimeError(f"{mode}: the kernel counted {out['visits_counted']} visits "
                               f"of {n_visits}")
    run = launcher(mode, inputs, n_visits, **shape)
    out["events_ms"] = time_ms(run, REPS, warmup=1)
    out["device_ms"] = graph_ms(run, REPS)
    out["us_per_visit"] = out["device_ms"] / max(n_visits, 1) * 1e3
    return out


def shipped_kernel(path: str) -> CudaKernel:
    """The wrappers' build whose C interface the source at ``path`` has."""
    with open(path) as f:
        return mf.MMA_KERNEL if "aptd_mm_visit_mma" in f.read() else mf.VPU_KERNEL


def variant_build(name: str) -> CudaKernel:
    """The shipped source with the variant's edits, written into the build
    directory."""
    source, edits = VARIANTS[name]
    shipped = mf.MMA_KERNEL if source == "mm_visit_mma.cu" else mf.VPU_KERNEL
    return edited_build(shipped, name, edits)


def launching(kernel: CudaKernel):
    """The wrappers launching another build of one of the two sources."""
    attr = "MMA_KERNEL" if kernel._declare is mf._declare_mma else "VPU_KERNEL"
    return swapped(mf, attr, kernel)


def division_share(inputs, n_visits: int, splits: int, highest: bool) -> dict:
    """How often the tensor-core visit's state filter lets a division run,
    on the plain version's products (both operands rounded to TF32 unless
    ``highest``): each block's range of the split schedule, each lane's
    state as the kernel keeps it (its own faces 8g + 2q + {0, 1} in the
    order g = 0 .. 3, the quad merged after each visit).  Shares of the
    (face, ray) positions that pass, of the warp votes (16 rays x 8 faces)
    that run the division, and of the votes that hold a hit (what runs the
    division without the filter), in each block's first 64 visits and
    after them."""
    rays, _, coeffs = inputs
    feats = mf.visit_features(rays)
    if not highest:
        feats, coeffs = mf.round_tf32(feats), mf.round_tf32(coeffs)
    ranges = mf.visit_ranges(n_visits, splits)
    lo = torch.tensor([a for a, _ in ranges], device=rays.device)
    length = torch.tensor([b - a for a, b in ranges], device=rays.device)
    state = torch.full((splits, 1, mf.LANES), mf.MISS, device=rays.device)
    sums = torch.zeros((2, 4), dtype=torch.float64, device=rays.device)
    for j in range(int(length.max())):
        live = (j < length).view(splits, 1, 1, 1)
        mm = coeffs[(lo + j) % mf.N_CLUSTERS].transpose(1, 2) @ feats    # (S, 128, 1024)
        # (S, value, g, q, e, ray): face 8g + 2q + e
        den, un, wn, tn = mm.view(splits, 4, 4, 4, 2, mf.LANES).unbind(1)
        hit = ((den >= mf._FLT_EPS) & (un >= 0) & (un <= den) & (wn >= 0) & (un + wn <= den)
               & (tn >= 0)) & live.unsqueeze(-1)
        t = torch.where(hit, tn / den, torch.full_like(tn, mf.MISS))
        lane = state.expand(splits, 4, mf.LANES)
        passed, votes, hit_votes = 0, 0, 0
        for g in range(4):
            lim = lane.unsqueeze(2) * den[:, g]
            need = hit[:, g] & ((tn[:, g] < lim * FILTER_SLACK) | (lim < FILTER_FLOOR))
            passed += int(need.sum())
            votes += int(need.view(splits, 8, 64, 16).any(-1).any(1).sum())
            hit_votes += int(hit[:, g].view(splits, 8, 64, 16).any(-1).any(1).sum())
            lane = torch.minimum(lane, t[:, g].amin(2))
        state = lane.amin(1, keepdim=True)
        n_live = int((j < length).sum())
        sums[int(j >= mf.N_CLUSTERS)] += torch.tensor(
            [passed, votes, hit_votes, n_live], dtype=torch.float64, device=rays.device)
    out = {}
    for phase, (p, v, h, n) in zip(("first_64_visits", "after"), sums.tolist()):
        out[phase] = {"block_visits": int(n),
                      "positions_passing": p / max(n * mf.CLUSTER * mf.LANES, 1),
                      "votes_dividing": v / max(n * 4 * mf.LANES / 16, 1),
                      "votes_with_a_hit": h / max(n * 4 * mf.LANES / 16, 1)}
    return out


def variants(inputs, dev, rounds, graph_ms, others):
    """The shipped builds and ``others`` at one block per SM and at as many
    as fit: equal to the shipped build bit for bit at 200 visits, then
    device ms at the probe's visit count."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    builds = [("shipped", None)] + [(k.name, k) for k in others]
    runs = []
    for mode, (kernel, highest) in MODES.items():
        want = launcher(mode, inputs, 200)()
        for name, build in builds:
            if build is not None and build._declare is not kernel._declare:
                continue
            with launching(build) if build is not None else contextlib.nullcontext():
                for per_sm in sorted({1, mf.fit_per_sm(dev, highest)}):
                    splits = sms * per_sm
                    if not torch.equal(launcher(mode, inputs, 200, splits=splits)(), want):
                        raise RuntimeError(f"{name} ({mode}) at {splits} blocks differs from "
                                           "the shipped build")
                    runs.append((f"{name}:{mode}:x{per_sm}", build, mode, splits))
    for rnd in range(rounds):
        ms = {}
        for label, build, mode, splits in (runs if rnd % 2 == 0 else runs[::-1]):
            with launching(build) if build is not None else contextlib.nullcontext():
                ms[label] = graph_ms(launcher(mode, inputs, mf.N_VISITS, splits=splits), REPS)
        print(json.dumps({"round": rnd, "columns": "build:mode:x blocks per SM",
                          "device_ms_by_build": ms}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sources", nargs="*", default=[],
                    help="other versions of csrc/mm_visit_vpu.cu or mm_visit_mma.cu")
    ap.add_argument("--dump-sass", metavar="DIR", help="write each build's SASS listing here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("visit_sweep: needs an NVIDIA GPU")
    from chip_smoke import PROBE_ONE_SM_VISITS, graph_ms, time_ms
    dev = torch.device("cuda")
    others = [rebuilt(shipped_kernel(p), p) for p in args.sources]
    if args.variants:
        others += [variant_build(name) for name in VARIANTS]
    builds = [mf.VPU_KERNEL, mf.MMA_KERNEL, *others]
    build_all(builds)
    inputs = mf.probe_inputs(0, dev)
    for mode in MODES:
        splits = shipped_splits(mode, dev)
        shape = {"splits": splits} if split_api() else {}
        row = measure(mode, inputs, mf.N_VISITS, time_ms, graph_ms, **shape)
        one = measure(mode, inputs, PROBE_ONE_SM_VISITS, time_ms, graph_ms,
                      **({"splits": 1} if split_api() else {}))
        print(json.dumps({**row, "splits": splits, "one_sm": one}), flush=True)
    for mode in ("tf32", "3xtf32"):
        splits = shipped_splits(mode, dev)
        print(json.dumps({"mode": mode, "splits": splits, "visits": mf.N_VISITS,
                          "division_share": division_share(inputs, mf.N_VISITS, splits,
                                                           MODES[mode][1])}), flush=True)
    if others and split_api():
        variants(inputs, dev, args.rounds, graph_ms, others)
    if args.dump_sass:
        os.makedirs(args.dump_sass, exist_ok=True)
        for k in builds:
            with open(os.path.join(args.dump_sass, f"{k.name}.sass"), "w") as f:
                f.write(subprocess.run([_cuobjdump(), "-sass", k.library_path()],
                                       capture_output=True, text=True, check=True,
                                       timeout=300).stdout)
    print(json.dumps({
        "ptxas": {k.name: [ln.strip() for ln in k.build_log.splitlines()
                           if "registers" in ln or "spill" in ln] for k in builds},
        "registers": {k.name: resource_usage(k.library_path()) for k in builds},
        "sass_per_division": {
            k.name: [{"function": r["function"],
                      "instructions_per_division": [lp["instructions_per_test"]
                                                    for lp in r["loops"]]}
                     for r in count_library(k.library_path(), "face") if r["loops"]]
            for k in builds}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
