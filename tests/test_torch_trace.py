"""The port's spans and counters (utils/timers.py), on the CPU.

Off the profiler a span adds its host time to an in-memory record and makes
no profiler call; while a profiler collects it is a ``record_function`` and
keeps nothing.  The program's spans sit where the layers are: a mesh frame
through the binned route counts its reads of the device site by site, a
train step records its phases, a denoised frame its levels.  No program span
takes a name that the benchmark's own spans use (``perfbench/loops``).
"""
import dataclasses
import json
import pathlib
import re
import sys
import threading

import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, RenderOptions, TrainOptions
from ai_path_tracer_denoiser_tpu_torch.models import (init_autoencoder, init_hidden,
                                                      prepare_inference)
from ai_path_tracer_denoiser_tpu_torch.models.inference import apply_frame_fast_padded
from ai_path_tracer_denoiser_tpu_torch.render import render_gbuffer_frame, wavefront
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene
from ai_path_tracer_denoiser_tpu_torch.train.device_data import _crop_batch
from ai_path_tracer_denoiser_tpu_torch.train.trainer import init_train_state, train_step
from ai_path_tracer_denoiser_tpu_torch.utils import timers

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "ai_path_tracer_denoiser_tpu_torch"
HARNESS_SPANS = {"frame", "render", "denoise", "copy_back", "step", "crop", "train_step"}
WIDTHS = (8, 8, 8, 8, 8)


@pytest.fixture(autouse=True)
def fresh_registry():
    timers.reset()
    yield
    timers.reset()


def test_spans_off_the_profiler_make_records_and_no_annotation(monkeypatch):
    def refuse(*_):
        raise AssertionError("record_function called off the profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for _ in range(3):
        with timers.span("t.top"):
            with timers.span("t.inner"):
                with timers.host_read("site"):
                    pass
            with timers.span("t.inner"):
                timers.count("t.n", 2)
    timers.count("t.n")                       # outside a record: the totals only
    recs = timers.records("t.top")
    assert len(recs) == 3 and timers.records("t.inner") == []
    for rec in recs:
        assert set(rec["spans"]) == {"t.top", "t.inner", "sync.site"}
        assert rec["counts"] == {"sync.site": 1, "t.n": 2}
        assert rec["spans"]["t.top"] >= rec["spans"]["t.inner"] >= rec["spans"]["sync.site"] > 0
    assert timers.totals() == {"sync.site": 3, "t.n": 7}


def test_span_closes_its_record_when_the_block_raises():
    with pytest.raises(ValueError):
        with timers.span("t.top"):
            with timers.span("t.inner"):
                raise ValueError
    with timers.span("t.next"):
        pass
    assert set(timers.records("t.top")[0]["spans"]) == {"t.top", "t.inner"}
    assert set(timers.records("t.next")[0]["spans"]) == {"t.next"}


def test_profiler_collects_spans_in_its_active_steps_only(tmp_path):
    """The gate is on exactly in the schedule's active steps (its warm-up
    steps only prepare the tracer): those spans land in the trace as nested
    ``user_annotation`` events and nowhere in memory; the wait and warm-up
    steps' spans make records."""
    from torch.profiler import ProfilerActivity, profile, schedule
    path = tmp_path / "trace.json"
    gate = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=2),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(4):
            gate.append(torch._C._autograd._profiler_enabled())
            with timers.span("t.outer"):
                with timers.host_read("site"):
                    torch.ones(4).add_(1)
            prof.step()
    assert gate == [False, False, True, True]
    assert len(timers.records("t.outer")) == 2
    assert timers.totals() == {"sync.site": 4}
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    outer = [e for e in events if e["name"] == "t.outer"]
    inner = [e for e in events if e["name"] == "sync.site"]
    assert len(outer) == len(inner) == 2
    for o, i in zip(sorted(outer, key=lambda e: e["ts"]), sorted(inner, key=lambda e: e["ts"])):
        assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def _program_span_names():
    """Every span and host-read name written in the port's sources (an
    f-string's fields filled with the level numbers 1-5)."""
    names = set()
    for path in PORT.rglob("*.py"):
        if "_build" in path.parts:
            continue
        text = path.read_text()
        names |= set(re.findall(r'\bspan\("([^"]+)"\)', text))
        names |= {t.replace("{i}", str(i)) for t in re.findall(r'\bspan\(f"([^"]+)"\)', text)
                  for i in range(1, 6)}
        names |= {"sync." + s for s in re.findall(r'\bhost_read\("([^"]+)"\)', text)}
    return names


def test_no_program_span_is_named_as_a_harness_span():
    names = _program_span_names()
    assert {"render.frame", "render.bounce", "render.intersect", "render.intersect.mesh",
            "render.shade", "render.sort", "render.k1", "render.gbuffer", "denoise.frame",
            "denoise.bottleneck", "denoise.enc1", "denoise.dec5", "train.step", "train.forward", "train.loss",
            "train.backward", "train.optimizer", "train.crop", "sync.live_count",
            "sync.geom_materials", "sync.mesh_box", "sync.binned_fit", "sync.rng_scalar",
            "sync.rng_scale", "sync.loss_kernel"} <= names
    assert not names & HARNESS_SPANS
    assert all("." in n for n in names), names


def _mesh_scene(depth, res=16):
    scene = load_scene(str(REPO / "scenes" / "cornell_mesh_torus.txt"), device="cpu")
    c = scene.camera
    return dataclasses.replace(scene, trace_depth=depth, camera=derive_camera(
        (res, res), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))


def _rng_copies(depth, antialias=True):
    """The host-to-device copies of the parity RNG in a frame of ``depth``
    bounces: the iteration (and, for the jitter, the depth) as a device
    scalar and the float scale once per uniform, two uniforms per draw; a
    draw for the jitter and one per bounce."""
    draws = depth + antialias
    return {"sync.rng_scalar": depth + 2 * antialias, "sync.rng_scale": 2 * draws}


@pytest.mark.parametrize("depth", [1, 4])
def test_binned_frame_counts_its_host_reads_per_bounce(depth, monkeypatch):
    """With every bounce run (no early stop), a frame of ``depth`` bounces
    reads the geoms' materials, the mesh box's two corners and the binned
    route's fit test at each, the live count before each but the first, and
    copies the RNG's scalars onto the device (``_rng_copies``)."""
    calls = []
    isect = wavefront.intersect_scene_v
    monkeypatch.setattr(wavefront, "intersect_scene_v",
                        lambda *a, **k: (calls.append(1), isect(*a, **k))[1])
    opts = RenderOptions(mesh_kernel_impl="binned", stream_compaction=False)
    render_gbuffer_frame(_mesh_scene(depth), opts)
    assert len(calls) == depth
    (rec,) = timers.records("render.frame")
    c = rec["counts"]
    assert {k: v for k, v in c.items() if k.startswith("sync.")} == {
        "sync.geom_materials": depth, "sync.mesh_box": 2 * depth,
        "sync.binned_fit": depth, **({"sync.live_count": depth - 1} if depth > 1 else {}),
        **_rng_copies(depth)}
    assert sum(v for k, v in c.items() if k.startswith("sync.")) == 8 * depth + 3
    assert c.get("binned.fast", 0) + c.get("binned.fallback", 0) == depth
    assert {k: v for k, v in timers.totals().items() if k in c} == c
    spans = rec["spans"]
    assert {"render.frame", "render.bounce", "render.intersect", "render.intersect.mesh",
            "render.shade", "render.gbuffer"} <= set(spans)
    assert spans["render.frame"] >= spans["render.bounce"] >= spans["render.intersect"]
    assert spans["render.intersect"] >= spans["render.intersect.mesh"] >= spans["sync.binned_fit"]


def test_carry_sort_counts_its_box_reads():
    """The octant carry sort (per-ray traversal) reads the mesh box once more
    per later bounce, under ``render.sort``."""
    opts = RenderOptions(mesh_kernel_impl="v2p", mesh_octant_sort=True,
                         stream_compaction=False)
    render_gbuffer_frame(_mesh_scene(3), opts)
    (rec,) = timers.records("render.frame")
    assert rec["counts"]["sync.mesh_box"] == 2 * 3 + 2 * 2
    assert "render.sort" in rec["spans"] and "binned.fast" not in rec["counts"]


def test_analytic_frame_reads_only_the_geom_materials():
    scene = load_scene(str(REPO / "scenes" / "cornell_box.txt"), device="cpu")
    scene = dataclasses.replace(scene, trace_depth=2, camera=derive_camera(
        (16, 16), 45.0, scene.camera.position.numpy(), scene.camera.look_at.numpy(),
        scene.camera.up.numpy()))
    render_gbuffer_frame(scene, RenderOptions(backend="xla", stream_compaction=False))
    (rec,) = timers.records("render.frame")
    assert rec["counts"] == {"sync.geom_materials": 2, "sync.live_count": 1, "geoms.plain": 2,
                             **_rng_copies(2)}


def test_train_step_records_its_phases():
    topt = TrainOptions(bf16_compute=False)
    mopts = ModelOptions(widths=WIDTHS)
    state = init_train_state(torch.Generator().manual_seed(0), mopts, topt, device="cpu")
    g = torch.Generator().manual_seed(1)
    X, Y = torch.rand(4, 32, 32, 10, generator=g), torch.rand(4, 32, 32, 3, generator=g)
    x, y = _crop_batch(X, Y, [0, 1], [0, 0], [0, 0], 2, 32, 32)
    train_step(state, x, y, topt, mopts)
    assert len(timers.records("train.crop")) == 1
    (rec,) = timers.records("train.step")
    phases = ("train.forward", "train.loss", "train.backward", "train.optimizer")
    assert set(rec["spans"]) == {"train.step", "sync.loss_kernel", *phases}
    assert rec["spans"]["train.step"] >= sum(rec["spans"][p] for p in phases)
    assert rec["spans"]["train.loss"] >= rec["spans"]["sync.loss_kernel"]
    # the HFEN term's Laplacian kernel, copied onto the device for the
    # output and the target of each frame
    assert rec["counts"] == {"sync.loss_kernel": 2 * x.shape[0]}


def test_denoised_frame_records_its_levels():
    mopts = ModelOptions(widths=WIDTHS)
    params, bn = init_autoencoder(torch.Generator().manual_seed(0), mopts)
    folded = prepare_inference(params, bn, mopts)
    hidden = init_hidden(1, 32, 32, mopts, dtype=torch.bfloat16)
    apply_frame_fast_padded(folded, torch.rand(1, 30, 31, 10), hidden, mopts)
    (rec,) = timers.records("denoise.frame")
    levels = ([f"denoise.enc{i}" for i in range(1, 6)] + ["denoise.bottleneck"]
              + [f"denoise.dec{i}" for i in range(1, 6)])
    assert set(rec["spans"]) == {"denoise.frame", *levels}
    assert rec["spans"]["denoise.frame"] >= sum(rec["spans"][n] for n in levels)


def test_records_keep_the_newest_1024():
    assert timers.KEEP == 1024
    for i in range(1100):
        with timers.span("t.keep"):
            timers.count("t.i", i)
    recs = timers.records("t.keep")
    assert len(recs) == 1024
    assert [r["counts"]["t.i"] for r in recs] == list(range(76, 1100))


def test_threads_keep_their_own_records_and_lose_no_count():
    """More threads than cores, switching often: every count reaches the
    totals, and each thread's counts reach its own records only."""
    n_threads, per = 12, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(per):
                with timers.span(f"t.thread{k}"):
                    timers.count("t.all")
                    timers.count(f"t.own{k}")
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert timers.totals()["t.all"] == n_threads * per
    for k in range(n_threads):
        recs = timers.records(f"t.thread{k}")
        assert len(recs) == per
        assert all(r["counts"] == {"t.all": 1, f"t.own{k}": 1} for r in recs)
