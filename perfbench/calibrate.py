"""Readings that a cell's limits are set from, in one process on the card:
the program on many seeds, the control (the reference one precision lower
in the program's place) and each fault of ``faults.py`` on a few.

    python3 perfbench/calibrate.py --workload <cell> --seconds 3 \\
        --seeds 12 --control-seeds 3 --fault-seeds 3 --seed0 <n> [--out <file>]

Prints one JSON line per run: mode, seed, correct and the numbers
compared.  The benchmark's own runs never call this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def witness(prog, a, b):
    """The reference rounded to bfloat16, as the program rounds, in the
    program's place: what bfloat16 alone reads against float32."""
    if hasattr(prog, "denoise"):
        from perfbench.loops.interactive import LowPrecisionDenoiser
        return a, LowPrecisionDenoiser(prog, quant="bf16")
    from perfbench.loops.train import LowPrecisionStep
    return a, LowPrecisionStep(prog.cfg, quant="bf16")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--witness-seeds", type=int, default=0,
                    help="runs with the reference in bfloat16 in the program's place")
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--faults", default="", help="comma list; default every fault of the loop")
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    from perfbench import common, faults
    from perfbench import run as bench
    kind = common.cell(a.workload)["traffic"]["loop"]
    names = [f for f in a.faults.split(",") if f] or list(faults.BY_LOOP[kind])
    plan = [("program", None, i) for i in range(a.seeds)]
    plan += [("control", None, 100 + i) for i in range(a.control_seeds)]
    plan += [("witness", "witness", 150 + i) for i in range(a.witness_seeds)]
    plan += [(f"fault:{f}", f, 200 + 10 * j + i) for j, f in enumerate(names)
             for i in range(a.fault_seeds)]
    for mode, fault, k in plan:
        seed = a.seed0 + k
        argv = ["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
                "--trace", "0"] + (["--control"] if mode == "control" else [])
        hook = witness if fault == "witness" else getattr(faults, fault) if fault else None
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
