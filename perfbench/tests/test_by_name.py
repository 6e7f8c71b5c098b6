"""A configuration, a traffic mix, a cell and a per-layer metric are added
by adding files and entries, in a copy of the harness, with no file that
is there edited."""
import json
import os
import shutil
import subprocess
import sys

from perfbench import common


def test_added_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(common.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))
    before = {p: open(p, "rb").read() for p in (root / "perfbench").rglob("*") if p.is_file()}
    cfg = json.load(open(root / "perfbench/configs/rdae-cornell-800.json"))
    cfg["name"] = "rdae-cornell-640"
    cfg["scene"]["resolution"] = [640, 640]
    (root / "perfbench/configs/rdae-cornell-640.json").write_text(json.dumps(cfg))
    traffic = json.load(open(root / "perfbench/traffic/orbit-one-viewer.json"))
    traffic["dphi"] = 0.05
    (root / "perfbench/traffic/orbit-fast.json").write_text(json.dumps(traffic))
    (root / "perfbench/limits/cornell-640-fast.json").write_text(
        (root / "perfbench/limits/cornell-800-interactive.json").read_text())
    (root / "perfbench/metrics/frames_profiled.py").write_text(
        "def read(rec):\n    return (rec or {}).get('profile', {}).get('units')\n")
    bench["configs"].append({"name": "rdae-cornell-640", "source": "x",
                             "file": "perfbench/configs/rdae-cornell-640.json",
                             "reduced": ["resolution"], "why": "x"})
    bench["workloads"].append({"name": "cornell-640-fast", "config": "rdae-cornell-640",
                               "traffic": "orbit-fast", "chips": 1, "why": "x"})
    bench["end_to_end"][1]["workloads"].append("cornell-640-fast")
    bench["per_layer"].append({"name": "frames_profiled", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "app loop",
                               "moves": "frame_ms", "workloads": ["cornell-640-fast"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, %r); from perfbench import common; "
            "c = common.cell('cornell-640-fast'); "
            "print(c['config']['scene']['resolution'], c['traffic']['dphi'], "
            "[m['name'] for m in c['per_layer']][-1], "
            "common.metric_reader('frames_profiled')({'profile': {'units': 5}}), "
            "common.loop_module(c['traffic']['loop']).__name__)" % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(root))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[640,", "640]", "0.05", "frames_profiled", "5",
                                  "perfbench_loop_interactive"]
    for p, data in before.items():
        assert open(p, "rb").read() == data, f"{p} was edited"


def test_a_run_refuses_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the harness runs nothing."""
    shutil.copytree(common.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "cornell-800-interactive", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and not out.stdout.strip()
