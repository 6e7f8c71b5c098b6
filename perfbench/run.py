"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's config, traffic mix, limits and metric readers are found by
the names in BENCHMARK.json (perfbench/configs, traffic, limits,
metrics); the traffic file names the loop that drives it
(perfbench/loops/<loop>.py).  With ``--trace 0`` the result's metrics are
the cell's end-to-end ones, with ``--trace 1`` its per-layer ones.  The
last line of standard output is one JSON object; the numbers compared
with the plain reference are printed beside their limits as the last
lines of standard error and under the result's last key, ``checks``.

``--control`` puts the reference computed one precision lower in the
program's place (the run must then come out not correct); it is for
setting limits, and the benchmark's own runs never pass it.
"""
from __future__ import annotations

import time

T_PROC0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def set_caches():
    """Kernel caches at fixed paths inside the checkout, so that only the
    first run of a cell in a checkout builds."""
    base = os.path.join(ROOT, "perfbench", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def result_line(cell, out, device_info, trace: bool) -> dict:
    if trace:
        from perfbench import common
        metrics = {}
        for m in cell["per_layer"]:
            v = common.metric_reader(m["name"])(out["trace"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device_info}
    if trace and out["trace"] and out["trace"].get("profile"):
        prof = out["trace"]["profile"]
        line["device"] = dict(device_info, busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None, device=None, program_hook=None, cell=None) -> dict:
    """Run the cell; returns the result line (printed too).  ``device``,
    ``program_hook`` and ``cell`` (the cell with its sizes cut) are for the
    tests that drive a run on the CPU."""
    args = parse(argv)
    set_caches()
    from perfbench import common
    common.SETUP_MARKS.clear()
    cell = cell or common.cell(args.workload)
    import torch
    common.mark("imports")
    chips = cell["workload"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {smi.stdout.strip()}", file=sys.stderr)
        torch.cuda.init()
        common.mark("cuda")
    loop = common.loop_module(cell["traffic"]["loop"])
    out = loop.run(cell, args, T_PROC0, device, program_hook=program_hook)
    bad = common.forbidden_loaded()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = result_line(cell, out, info, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
