"""BENCHMARK.json as the contract states it, and every name found by file."""
import json
import os
import re

from perfbench import common

B = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"] and B["paths"] == ["perfbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    cells = 24                                 # a check's cost with the full 24 cells
    runs = 2 + 14 * cells
    assert runs * (B["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(B).encode()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(common.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_every_cell_reports_what_its_metrics_need():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    for w in B["workloads"]:
        cell = common.cell(w["name"])
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in names, (w["name"], m["name"])
            assert common.metric_reader(m["name"])
        assert os.path.exists(os.path.join(common.BENCH_DIR, "loops",
                                           cell["traffic"]["loop"] + ".py"))
    for m in B["per_layer"]:
        assert "workloads" in m and set(m["workloads"]) <= {w["name"] for w in B["workloads"]}
