"""Idle share and breakdown arithmetic on synthetic traces."""
from pytest import approx

from perfbench import common


def test_union_not_sum_on_overlap():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert common.covered(iv, 0, 40) == 25          # a sum would read 31
    assert common.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert common.covered(iv, 8, 22) == 9


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_read_trace_idle_spans_and_labels():
    ev = [
        _ev("user_annotation", "frame", 0, 100), _ev("user_annotation", "frame", 100, 100),
        _ev("user_annotation", "render", 0, 40), _ev("user_annotation", "denoise", 40, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 2, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=3),
        _ev("cpu_op", "aten::item", 150, 40),
        _ev("kernel", "k_render", 20, 30, correlation=1),
        _ev("kernel", "k_conv", 55, 40, correlation=2),      # overlaps the next
        _ev("kernel", "k_conv", 70, 40, correlation=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 120, 10),
    ]
    r = common.read_trace(ev, "frame", ("render", "denoise"))
    assert r["units"] == 2 and r["window_s"] == approx(200e-6)
    # device busy: [20, 50), [55, 110) and [120, 130): 95 us, not 30 + 40 + 40 + 10
    assert r["busy_s"] == approx(95e-6)
    assert r["spans"]["render"]["kernels"] == 1
    assert r["spans"]["render"]["device_s"] == approx(30e-6)
    assert r["spans"]["denoise"]["kernels"] == 2
    assert r["spans"]["denoise"]["device_s"] == approx(55e-6)
    idle = dict(r["idle_gaps"])
    assert idle["frame/aten::item"] == approx(70e-6)     # the gap 130..200
    assert idle["render/cudaLaunchKernel"] == approx(20e-6)
    assert idle["denoise"] == approx(5e-6) and idle["frame"] == approx(10e-6)
    assert dict(r["device_ops"])["k_conv"] == approx(80e-6)


def test_idle_metric_from_reading():
    from perfbench import common as c
    read = c.metric_reader("device_idle_pct.frame")
    rec = {"frames": 2, "profile": {"busy_s": 0.25, "window_s": 1.0}}
    assert read(rec) == 75.0
    assert read({"steps": 3, "profile": {"busy_s": 0.25, "window_s": 1.0}}) is None
