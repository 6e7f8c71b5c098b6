"""The data-parallel train step against ``train_step`` on one card, and
where the step's extra host time goes.

Starts a world of one over NCCL (``parallel.make_mesh``), makes a train
state at the reference widths from ``--seed`` and one batch of random
bfloat16 inputs and targets (batch 4, 7-frame windows, 256x256 crops, the
shape ``chip_smoke.py`` times), and checks once that the data-parallel
step equals ``train_step`` bit for bit.  Then it times both in turns
(parallel, single, single, parallel, repeated ``--runs`` / 4 times), each
run ``--calls`` calls back to back: CUDA events ms and the host's ms until
the last call returned, per call.  Last it profiles one call of each
(``torch.profiler``, CPU and CUDA): the card's busy time (the sum of kernel
times), the collectives' rows, and the operators whose self CPU time
differs most between the two.  Prints one JSON line with the card's name
and power limit.

Run on an NVIDIA GPU:
    python -m ai_path_tracer_denoiser_tpu_torch.tools.dp_step_timing
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from ..config import ModelOptions, TrainOptions
from ..models import conv_kernel
from ..models.export import sorted_leaves
from ..parallel import make_dp_train_step, make_mesh, shard_batch
from ..parallel.mesh import destroy
from ..train import init_train_state, train_step
from ..utils.cuda_build import build_all

BATCH, CROP, SEQ = 4, 256, 7
COMM = re.compile(r"comm|c10d|nccl|all_reduce|allreduce|all_gather|AllReduce|AllGather")


def timed(fn, calls: int):
    """(events ms, host ms) per call over ``calls`` calls back to back."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / calls
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls, host


def profiled(fn):
    """One profiled call: its host ms and the profiler's rows (ms), keyed by
    operator name.  A trace without device events is taken once more."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = {e.key: {"count": e.count,
                        "cpu_ms": e.cpu_time_total / 1e3,
                        "self_cpu_ms": e.self_cpu_time_total / 1e3,
                        "self_device_ms": getattr(e, "self_device_time_total",
                                                  getattr(e, "self_cuda_time_total", 0)) / 1e3}
                for e in prof.key_averages()}
        busy = sum(r["self_device_ms"] for r in rows.values())
        if busy > 0:
            return wall, busy, rows
    raise RuntimeError("the profiler reported no device time")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8, help="a multiple of 4")
    ap.add_argument("--calls", type=int, default=5, help="calls per run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dp_step_timing needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    mesh = make_mesh()
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        build_all((conv_kernel.KERNEL,))
        mopt = ModelOptions()
        topt = TrainOptions(epochs=1, crop_size=CROP, batch_size=BATCH)
        state = init_train_state(torch.Generator().manual_seed(args.seed), mopt, topt,
                                 device=dev)
        rng = np.random.default_rng(args.seed)
        x = torch.from_numpy(rng.random((SEQ, BATCH, CROP, CROP, 10), dtype=np.float32))
        y = torch.from_numpy(rng.random((SEQ, BATCH, CROP, CROP, 3), dtype=np.float32))
        x, y = x.to(dev, torch.bfloat16), y.to(dev, torch.bfloat16)
        dp_step = make_dp_train_step(mesh, topt, mopt)
        xs, ys = shard_batch(x, y, mesh)
        sides = {"parallel": lambda: dp_step(state, xs, ys),
                 "single": lambda: train_step(state, x, y, topt, mopt)}
        (got, got_m), (want, want_m) = sides["parallel"](), sides["single"]()
        bitwise = (all(torch.equal(u, v) for (_, u), (_, v) in
                       zip(sorted_leaves(got.params), sorted_leaves(want.params)))
                   and all(torch.equal(got_m[k], want_m[k]) for k in want_m))
        for fn in sides.values():                      # second warm-up call each
            fn()
        runs = {s: {"events_ms": [], "host_ms": []} for s in sides}
        for side in ("parallel", "single", "single", "parallel") * (args.runs // 4):
            ev, host = timed(sides[side], args.calls)
            runs[side]["events_ms"].append(ev)
            runs[side]["host_ms"].append(host)
        prof = {s: profiled(fn) for s, fn in sides.items()}
    finally:
        destroy()
    par_rows, one_rows = prof["parallel"][2], prof["single"][2]
    gaps = sorted(((k, r["self_cpu_ms"] - one_rows.get(k, {}).get("self_cpu_ms", 0.0))
                   for k, r in par_rows.items()), key=lambda kv: -kv[1])
    out = {
        "phase": "dp_step_timing", "card": smi, "world": "1 rank, NCCL",
        "batch": [SEQ, BATCH, CROP, CROP], "bf16_compute": topt.bf16_compute,
        "dp_step_bitwise_train_step": bitwise, "calls_per_run": args.calls,
        "runs": runs,
        "events_ms_median": {s: statistics.median(r["events_ms"]) for s, r in runs.items()},
        "profile": {s: {"host_ms": p[0], "device_busy_ms": p[1],
                        "self_cpu_ms_sum": sum(r["self_cpu_ms"] for r in p[2].values()),
                        "collective_rows": {k: r for k, r in p[2].items() if COMM.search(k)}}
                    for s, p in prof.items()},
        "self_cpu_ms_more_in_parallel": [
            {"op": k, "ms": ms, "count": par_rows[k]["count"],
             "count_single": one_rows.get(k, {}).get("count", 0)} for k, ms in gaps[:25]],
        "columns": "runs: per run of calls_per_run calls, events ms and host ms per call, "
                   "in the order parallel, single, single, parallel; profile: one call "
                   "each, host_ms under the profiler (which slows the host), "
                   "device_busy_ms the sum of kernel times"}
    print(json.dumps(out))
    if not bitwise:
        raise SystemExit("the data-parallel step of a world of one is not train_step")


if __name__ == "__main__":
    main()
