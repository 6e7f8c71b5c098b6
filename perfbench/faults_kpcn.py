"""Faults planted under the kernel-predicting denoiser's timed path, each as
a ``program_hook`` for ``run.main`` (the run must then come out not
correct), and the readings that the cell's limits are set from.

    python3 perfbench/faults_kpcn.py --seconds 3 --seeds 12 --control-seeds 3 \\
        --fault-seeds 3 --seed0 <n> [--out <file>]

runs, in one process on the card, the program on many seeds, the control
(the reference with float8 convs in the program's place), the bfloat16
witness and each fault on a few, and prints one JSON line per run: mode,
seed, correct and the numbers compared.  The benchmark's own runs never
call this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELL = "kpcn-cornell-800-interactive"
FAULTS = ("window_shifted", "softmax_440", "frame_altered")


def _apply(logits, gbuffer, k):
    from ai_path_tracer_denoiser_tpu_torch.models import kernel_apply
    return kernel_apply(logits, gbuffer[None, 0:3], k)


def window_shifted(prog, render, denoise):
    """The apply's window one pixel to the right of the pixel."""
    def d(gbuffer):
        _, logits = denoise(gbuffer)
        return _apply(logits, gbuffer.roll(-1, dims=2), prog.model["kernel"]), logits
    return render, d


def softmax_440(prog, render, denoise):
    """The softmax over 440 of the 441 taps: the last (bottom right) left
    out, the others' weights normalised without it."""
    def d(gbuffer):
        _, logits = denoise(gbuffer)
        k2 = prog.model["kernel"] ** 2
        logits = logits.clone()
        logits[..., k2 - 1] = float("-inf")
        return _apply(logits, gbuffer, prog.model["kernel"]), logits
    return render, d


def frame_altered(prog, render, denoise):
    """The denoised frame 10% bright where the denoiser produces it."""
    def d(gbuffer):
        y, logits = denoise(gbuffer)
        return y * 1.1, logits
    return render, d


def witness(prog, render, denoise):
    """The reference rounded to bfloat16, as the program rounds, in the
    program's place: what bfloat16 alone reads against float32."""
    from perfbench.loops.interactive_kpcn import LowPrecisionDenoiser
    return render, LowPrecisionDenoiser(prog, quant="bf16")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--witness-seeds", type=int, default=0)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    from perfbench import run as bench
    plan = [("program", None, i) for i in range(a.seeds)]
    plan += [("control", None, 100 + i) for i in range(a.control_seeds)]
    plan += [("witness", witness, 150 + i) for i in range(a.witness_seeds)]
    plan += [(f"fault:{f}", globals()[f], 200 + 10 * j + i) for j, f in enumerate(FAULTS)
             for i in range(a.fault_seeds)]
    for mode, hook, k in plan:
        seed = a.seed0 + k
        argv = ["--workload", CELL, "--seed", str(seed), "--seconds", str(a.seconds),
                "--trace", "0"] + (["--control"] if mode == "control" else [])
        try:
            line = bench.main(argv, program_hook=hook)
            rec = {"mode": mode, "seed": seed, "correct": line["correct"],
                   "checks": {n: c["value"] for n, c in line["checks"].items()},
                   "metrics": {n: m["value"] for n, m in line["metrics"].items()}}
        except Exception as e:  # a control or fault that crashes has failed
            rec = {"mode": mode, "seed": seed, "correct": False, "error": repr(e)[:300]}
        text = json.dumps(rec)
        print("CAL " + text, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
