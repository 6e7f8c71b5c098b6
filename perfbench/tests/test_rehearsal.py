"""Each cell's loop run once on the CPU at a small size, through the
harness's entry point with the program's plain paths: the shapes, calls
and arguments of a chip run, and the result line's keys."""
import math

import pytest


def _line_keys(line, trace):
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert "busy_s" in line["device"] and "window_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and math.isfinite(c["value"])


@pytest.mark.parametrize("name,res,tail", [("cornell-800-interactive", 32, {"frame_ms_p95"}),
                                           ("statue-800-interactive", 16, set())])
def test_interactive_cells_run(cpu_run, name, res, tail):
    line = cpu_run(name, res=res)
    _line_keys(line, False)
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "frame_ms"} | tail
    assert set(line["checks"]) == {"gbuffer_off_share", "denoise_err_ratio",
                                   "denoise_gain_gap", "hidden_rel_l2"}
    assert line["checks"]["gbuffer_off_share"]["value"] == 0.0   # plain against plain


def test_traced_run_reports_per_layer_metrics(cpu_run):
    line = cpu_run("cornell-800-interactive", trace=1)
    _line_keys(line, True)
    # on the CPU no CUDA event or kernel exists: those readers stay silent
    assert set(line["metrics"]) == {"frame_dispatch_ms", "frame_mfu_pct",
                                    "device_idle_pct.frame"}
    assert line["metrics"]["device_idle_pct.frame"]["value"] == 100.0


def test_train_cell_runs(cpu_run):
    line = cpu_run("rdae-256-train", seconds=0.1)
    _line_keys(line, False)
    assert set(line["metrics"]) == {"setup_s", "train_step_ms"}
    assert set(line["checks"]) == {"bn_step1_err", "change_norm_gap", "bn_change_gap"}
