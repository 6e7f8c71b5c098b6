"""The readers of the program's own spans and counters
(ai_path_tracer_denoiser_tpu_torch/utils/timers.py), on a registry filled
by hand; and their entries in BENCHMARK.json."""
import os
import statistics

import pytest
from pytest import approx

from perfbench import common

B = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))
PROGRAM_METRICS = ("render_host_ms", "denoise_host_ms", "render_sync_wait_ms",
                   "render_host_syncs", "binned_fast_share", "train_forward_host_ms",
                   "train_backward_host_ms", "train_optimizer_host_ms")
FRAME = {"frames": 3, "render_ms": 1.0, "profile": {"kernels": 10, "units": 2}}
STEP = {"steps": 3, "profile": {"kernels": 10, "units": 2}}


@pytest.fixture
def timers():
    from ai_path_tracer_denoiser_tpu_torch.utils import timers
    timers.reset()
    yield timers
    timers.reset()


def _spin(ms):
    import time
    t = time.perf_counter()
    while time.perf_counter() - t < ms * 1e-3:
        pass


def _frames(timers, n_frames, reads, fallback_at=()):
    """``n_frames`` render and denoise frames: each render frame reads the
    device ``reads`` times and takes the binned route twice (falling back
    on frames listed in ``fallback_at``)."""
    for k in range(n_frames):
        with timers.span("render.frame"):
            for _ in range(reads):
                with timers.host_read("site"):
                    _spin(0.2)
            timers.count("binned.fast")
            timers.count("binned.fallback" if k in fallback_at else "binned.fast")
        with timers.span("denoise.frame"):
            with timers.span("denoise.enc1"):
                _spin(0.1)


def _median_ms(timers, top, key):
    return 1e-6 * statistics.median(
        key(r) for r in timers.records(top))


def test_frame_readers(timers):
    _frames(timers, 5, reads=3, fallback_at=(1, 3))
    read = {n: common.metric_reader(n) for n in PROGRAM_METRICS}
    assert read["render_host_ms"](FRAME) == approx(
        _median_ms(timers, "render.frame", lambda r: r["spans"]["render.frame"]))
    assert read["denoise_host_ms"](FRAME) == approx(
        _median_ms(timers, "denoise.frame", lambda r: r["spans"]["denoise.frame"]))
    wait = read["render_sync_wait_ms"](FRAME)
    assert wait == approx(_median_ms(timers, "render.frame", lambda r: r["spans"]["sync.site"]))
    assert 0.6 <= wait <= read["render_host_ms"](FRAME)
    assert read["render_host_syncs"](FRAME) == 3.0
    assert read["binned_fast_share"](FRAME) == approx(100.0 * 8 / 10)


def test_train_readers(timers):
    for _ in range(3):
        with timers.span("train.crop"):
            pass
        with timers.span("train.step"):
            for phase, ms in (("forward", 0.3), ("loss", 0.1), ("backward", 0.5),
                              ("optimizer", 0.2)):
                with timers.span("train." + phase):
                    _spin(ms)
    for phase in ("forward", "backward", "optimizer"):
        got = common.metric_reader(f"train_{phase}_host_ms")(STEP)
        assert got == approx(_median_ms(timers, "train.step",
                                        lambda r: r["spans"]["train." + phase]))
    assert (common.metric_reader("train_backward_host_ms")(STEP)
            > common.metric_reader("train_forward_host_ms")(STEP))


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_silent_where_no_card_was_timed(timers, name):
    _frames(timers, 2, reads=1)
    with timers.span("train.step"):
        with timers.span("train.forward"):
            pass
    read = common.metric_reader(name)
    # the CPU rehearsal's records: no CUDA events, no kernels
    for rec in (None, {}, dict(FRAME, render_ms=None), {"steps": 3, "profile": {"units": 2}},
                {"steps": 3, "profile": {"kernels": 0, "units": 2}}):
        assert read(rec) is None, rec


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_silent_where_the_program_kept_nothing(timers, name):
    read = common.metric_reader(name)
    assert read(FRAME if "train" not in name else STEP) is None


def test_no_binned_calls_leave_the_share_silent(timers):
    with timers.span("render.frame"):
        pass
    assert common.metric_reader("binned_fast_share")(FRAME) is None
    assert common.metric_reader("render_host_syncs")(FRAME) == 0.0


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_entries_name_a_reader_and_a_reported_metric(name):
    (m,) = [m for m in B["per_layer"] if m["name"] == name]
    assert common.metric_reader(name)
    assert m["source"] in ("program_span", "program_counter")
    assert m["layer"] in {"render", "denoiser", "trainer"}
    assert m["workloads"]
    for cell in m["workloads"]:
        names = {e["name"] for e in common.cell(cell)["end_to_end"]}
        assert m["moves"] in names, (name, cell)
    assert [e["name"] for e in B["per_layer"][-len(PROGRAM_METRICS):]] == list(PROGRAM_METRICS)
