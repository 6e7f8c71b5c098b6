"""The kernel-predicting denoiser's cell (kpcn-cornell-800-interactive) run
once on the CPU at 32x32 through the harness's entry point with the
program's plain paths, its faults and control, its counts against hand
counts, and its two roofline readers."""
import copy
import math

import pytest

from perfbench import common, counts_kpcn, faults_kpcn
from perfbench.metrics import kpcn_apply_roofline, kpcn_conv_roofline

CELL = "kpcn-cornell-800-interactive"
CHECKS = {"gbuffer_off_share", "denoise_err_ratio", "denoise_gain_gap", "kernel_rel_l2"}


def small_cell(res=32):
    cell = copy.deepcopy(common.cell(CELL))
    cell["config"]["scene"]["resolution"] = [res, res]
    cell["traffic"].update(check_frames=1, warmup_frames=2)
    return cell


@pytest.fixture
def run_small():
    import torch
    from perfbench import run as bench
    torch.set_num_threads(2)

    def go(trace=0, seed=2**31 + 7, extra=(), hook=None):
        argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                "--trace", str(trace), *extra]
        return bench.main(argv, device=torch.device("cpu"), program_hook=hook, cell=small_cell())
    return go


def test_the_cell_runs_correct(run_small):
    line = run_small()
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "frame_ms", "frame_ms_p95"}
    assert set(line["checks"]) == CHECKS
    assert all(math.isfinite(c["value"]) for c in line["checks"].values())
    assert line["checks"]["gbuffer_off_share"]["value"] == 0.0   # plain against plain


def test_the_traced_run_reports_per_layer_metrics(run_small):
    line = run_small(trace=1)
    # on the CPU no CUDA event or kernel exists: those readers stay silent
    assert set(line["metrics"]) == {"frame_dispatch_ms", "frame_mfu_pct",
                                    "device_idle_pct.frame"}
    assert line["metrics"]["device_idle_pct.frame"]["value"] == 100.0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", ["kpcn_conv_roofline", "kpcn_apply_roofline"])
def test_the_traced_run_prints_its_rooflines(run_small, capsys, name):
    # BENCHMARK.json lists neither yet: the traced run prints each on
    # standard error, silent (None) on the CPU
    line = run_small(trace=1)
    assert name not in line["metrics"]
    assert f"[perfbench] {name} None" in capsys.readouterr().err


@pytest.mark.parametrize("fault", faults_kpcn.FAULTS)
def test_each_fault_fails(run_small, fault):
    line = run_small(hook=getattr(faults_kpcn, fault))
    assert not line["correct"], line["checks"]


def test_the_control_fails(run_small):
    assert not run_small(extra=["--control"])["correct"]


def test_counts_against_hand_counts():
    model = common.load_json(common.ROOT + "/perfbench/configs/kpcn-cornell-800.json")["model"]
    convs = counts_kpcn.kpcn_convs(800, 800, model)
    assert [c[3:] for c in convs] == [(30, 100)] + [(100, 100)] * 7 + [(100, 441)]
    # 150,000 + 7 x 500,000 + 2,205,000 FLOP a pixel
    assert counts_kpcn.conv_flops(convs) == 5_855_000 * 640_000 == 3_747_200_000_000
    assert counts_kpcn.conv_flops(convs[:1]) == 150_000 * 640_000
    assert counts_kpcn.conv_bytes(convs[-1:]) == 2 * (640_000 * 100 + 25 * 100 * 441
                                                      + 640_000 * 441)
    # every conv is bound by its operations: 3.747e12 / 989e12 s
    assert counts_kpcn.conv_bound_s(convs) == pytest.approx(3.747_2e12 / 989e12)
    assert counts_kpcn.apply_bytes(800, 800, 21) == 640_000 * 906
    assert counts_kpcn.apply_bound_s(800, 800, 21) * 1e3 == pytest.approx(0.17309, abs=1e-5)


@pytest.mark.parametrize("mod,span,key", [
    (kpcn_conv_roofline, "denoise.kpcn.convs", "conv_bound_s"),
    (kpcn_apply_roofline, "denoise.kpcn.apply", "apply_bound_s")])
def test_the_roofline_readers(mod, span, key):
    rec = {key: 0.004, "profile": {"units": 3, "spans": {span: {"kernels": 27, "device_s": 0.03}}}}
    assert mod.read(rec) == pytest.approx(40.0)
    for silent in (None, {}, {key: 0.004}, {key: 0.004, "profile": {"units": 3, "spans": {}}},
                   {key: 0.004, "profile": {"units": 3,
                                            "spans": {span: {"kernels": 0, "device_s": 0.0}}}},
                   {"profile": rec["profile"]}):
        assert mod.read(silent) is None, silent
