"""What every loop of the harness shares: finding a cell's files by name,
the guards a run must pass, timing helpers, and reading the profiler's
trace (union of device intervals, idle gaps, time by kernel)."""
from __future__ import annotations

import bisect
import hashlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "ai_path_tracer_denoiser_tpu")


SETUP_MARKS: List[Tuple[str, float]] = []


def mark(label: str) -> None:
    """Note the host clock at a stage of set-up (printed by the loops)."""
    import time
    SETUP_MARKS.append((label, time.time()))


def setup_parts(t_proc0: float) -> str:
    """Seconds each stage of set-up took, from the process's start."""
    out, at = [], t_proc0
    for label, t in SETUP_MARKS:
        out.append(f"{label} {t - at:.2f}")
        at = t
    return ", ".join(out)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the harness found by its file name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: str = ROOT) -> Dict:
    """Everything a run of the cell ``name`` needs, found by the names in
    BENCHMARK.json: its config file, ``traffic/<traffic>.json``,
    ``limits/<cell>.json`` and the metrics that apply to it."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "perfbench")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": w,
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        "limits": load_json(os.path.join(here, "limits", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "run_seconds": bench["run_seconds"],
    }


def loop_module(kind: str):
    return load_module(os.path.join(BENCH_DIR, "loops", kind + ".py"), f"perfbench_loop_{kind}")


def metric_reader(name: str):
    mod = load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                      "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def check_inputs(files: Dict[str, str]) -> None:
    """The scene and asset files a config names must be the ones it was
    measured with: the yardstick does not move when they are edited."""
    for rel, digest in files.items():
        got = file_digest(os.path.join(ROOT, rel))
        if got != digest:
            raise SystemExit(f"{rel} changed (sha256 {got}, config has {digest})")


def rel_l2(got, want) -> float:
    import torch
    got, want = got.double(), want.double()
    den = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got - want)) / max(den, 1e-30)


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Per leaf, |norm_prog - norm_ref| / max(norm_ref, median leaf's
    norm_ref): the gap between the norms, not the norm of the difference."""
    import statistics
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}


# ----------------------------------------------------------------- trace

def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of [start, end) intervals as a sorted list of disjoint ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in merge(intervals):
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def _labels(xs: List[Dict], gap_list) -> List[str]:
    """What the host was doing at each gap's midpoint: the innermost
    (shortest) harness span and the innermost operation or runtime call
    open then, as "span/op".  One sweep over the events in time order with
    a heap per kind, so a trace of many thousand gaps reads in seconds."""
    import heapq
    kinds = {"user_annotation": 0, **{c: 1 for c in HOST_CATS}}
    evs = sorted((e["ts"], e["ts"] + e["dur"], kinds[e["cat"]], e["name"])
                 for e in xs if e.get("cat") in kinds)
    heaps: List[list] = [[], []]
    out, i = [], 0
    for mid in sorted(0.5 * (a + b) for a, b in gap_list):
        while i < len(evs) and evs[i][0] <= mid:
            ts, end, k, name = evs[i]
            heapq.heappush(heaps[k], (end - ts, end, name))
            i += 1
        parts = []
        for h in heaps:
            while h and h[0][1] < mid:
                heapq.heappop(h)
            if h:
                parts.append(h[0][2])
        out.append("/".join(parts) or "python")
    return out


def read_trace(events: List[Dict], unit: str, spans=()) -> Dict:
    """Per-layer readings from a Chrome trace's complete events.

    The sub-window runs from the first ``unit`` span's start to the last
    one's end (host timeline; device and host share the trace's clock).
    Device time is the union of kernel, copy and fill intervals inside it.
    A kernel belongs to the span ``s`` whose host interval holds the call
    that launched it (matched by correlation id)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    units = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                   if e.get("cat") == "user_annotation" and e.get("name") == unit)
    if not units:
        return {}
    lo, hi = units[0][0], units[-1][1]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    dev_iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    launch = {e["args"]["correlation"]: e["ts"] for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    by_span = {}
    for s in spans:
        iv = merge([(e["ts"], e["ts"] + e["dur"]) for e in xs
                    if e.get("cat") == "user_annotation" and e.get("name") == s])
        starts = [a for a, _ in iv]

        def inside(t):
            j = bisect.bisect_right(starts, t) - 1
            return j >= 0 and t <= iv[j][1]

        mine = [e for e in dev if e.get("cat") == "kernel"
                and inside(launch.get(e.get("args", {}).get("correlation"), -1.0))]
        by_span[s] = {"kernels": len(mine),
                      "device_s": covered([(e["ts"], e["ts"] + e["dur"]) for e in mine],
                                          -1e30, 1e30) * 1e-6}
    kernels_in = [e for e in dev if e.get("cat") == "kernel" and lo <= e["ts"] < hi]
    per_name: Dict[str, float] = {}
    for e in dev:
        d = max(0.0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo))
        if d > 0:
            per_name[e["name"]] = per_name.get(e["name"], 0.0) + d * 1e-6
    idle: Dict[str, float] = {}
    for (a, b), label in zip(gaps(dev_iv, lo, hi), _labels(xs, gaps(dev_iv, lo, hi))):
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6

    return {"units": len(units), "window_s": (hi - lo) * 1e-6,
            "busy_s": covered(dev_iv, lo, hi) * 1e-6, "kernels": len(kernels_in),
            "spans": by_span, "device_ops": _top(per_name), "idle_gaps": _top(idle)}


class no_tf32:
    """Inside the block the reference's float32 convs and products stay
    float32 on the card; the program's settings come back after it."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def units_for(traffic, window_s: float, n: int) -> int:
    """Units to profile: about ``profile_seconds`` of the loop at the
    window's pace, and no fewer than ``profile_min_units``."""
    import math
    per = window_s / max(n, 1)
    return max(traffic["profile_min_units"], math.ceil(traffic["profile_seconds"] / per))


def read_device(events: List[Dict]) -> Dict:
    """Device readings of a trace taken with CUDA activity alone (the
    host's operators not traced, so the host runs near its own pace): the
    window from the first runtime call to the last device operation's end,
    the union of device intervals in it, kernels launched, time by name."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    calls = [e["ts"] for e in xs if e.get("cat") in HOST_CATS[1:]]
    if not dev or not calls:
        return {}
    lo, hi = min(calls), max(e["ts"] + e["dur"] for e in dev)
    per_name: Dict[str, float] = {}
    for e in dev:
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": covered([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi) * 1e-6,
            "kernels": sum(e.get("cat") == "kernel" for e in dev),
            "device_ops": _top(per_name)}


def _top(d):
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _traced(step, n_units: int, unit: str, acts) -> List[Dict]:
    import tempfile

    import torch
    from torch.profiler import profile, record_function, schedule
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts, schedule=schedule(wait=1, warmup=1, active=n_units),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(n_units + 2):
                with record_function(unit):
                    step()
                prof.step()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        return load_json(path)["traceEvents"]


def profile_units(step, n_units: int, unit: str, spans=()) -> Dict:
    """Profile ``n_units`` calls of ``step()`` twice (each after one unit to
    wait and one to warm the tracer).  First with CUDA activity alone: the
    device's busy time, its window, the kernels launched and the time by
    kernel.  Then with the host's operators too, whose tracing slows the
    host several fold: which kernels each span launched and what the host
    was doing in each idle gap."""
    import torch
    from torch.profiler import ProfilerActivity
    out = {"units": n_units}
    if torch.cuda.is_available():
        out.update(read_device(_traced(step, n_units, unit, [ProfilerActivity.CUDA])))
        both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    else:
        both = [ProfilerActivity.CPU]
    host = read_trace(_traced(step, n_units, unit, both), unit, spans)
    for k in ("spans", "idle_gaps"):
        out[k] = host.get(k, {} if k == "spans" else [])
    for k in ("window_s", "busy_s", "kernels", "device_ops"):
        out.setdefault(k, host.get(k))
    return out
