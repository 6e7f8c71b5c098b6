#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's eleven CUDA kernels from csrc/ (and the kernel-predicting
denoiser's two, K11 and K12, at first use), holds each against its plain
PyTorch version on the card, and drives the main paths through the
CLI's entry point.  The wavefront's geom kernel K10 is held bit for bit
to its plain version on every analytic-geom query of an 800x800 statue
frame and timed there, with the frame itself through K10 and through the
plain version in turns.  K11 and K12 are held to their plain versions on
an 800x800 cornell frame denoised by KPCN at its published widths, and
timed there beside their bounds and cuDNN's conv at the same shapes;
then ``interactive --denoiser kpcn`` renders and denoises four such frames
through the CLI, with K1, K11 and K12's launches counted (1, 9 and 1 a
frame).  The render megakernel is also held bit for bit to its
one-pixel-per-thread witness build (the first version's schedule and
arithmetic) on six inputs, and timed as events around its wrapper's calls
and as device time of the launch alone, on the interactive frame and on a
datagen launch (512x512, 64 iterations), with its lane efficiency.
Training: `datagen` renders a 14-frame 512x512 corpus
of the Cornell box with the render megakernel, `train` takes one epoch (3
Adam steps) at batch 4 on 7-frame 256x256 crops at the reference widths in
bfloat16 with the corpus on the card (every conv's forward pass and input
gradient through the tile conv kernel), `export` writes the model and
`interactive` runs it with the tile conv kernel and with the row-band conv
kernel.  Serving: the interactive 1-spp render + denoise loop at 800x800,
depth 8, with the shipped denoiser, on scenes/cornell_box.txt (render
megakernel + conv kernel: 1 and 28 launches per frame) and on the mesh
scenes cornell_mesh_blob.txt (5,120 faces, per-ray BVH traversal kernel)
and cornell_mesh_statue.txt (81,920 faces, bin subscription + pair kernels;
plain wavefront, so no megakernel launch).  The mesh kernels are checked on
the calls recorded from an actual 800x800 frame of each scene (the per-ray
traversal on the primary rays and the first secondary bounce, bin
subscription and the pair test on every call of the frame rendered through
the binned pipeline, with their real cull distances and dead lanes), whole
and bit for bit, and the pair kernel's fast reciprocal against IEEE division
on every float it is used for.  The mesh-traversal experiment path: the
tile-gated and the front-to-back traversal kernels (`--mesh-kernel-impl v2`
and `v3`) on those same recorded calls against the dense scan and the
per-ray kernel, and on two whole-tile slices of each call against their
own plain walks, output and visits (the clusters each tile ran face tests
for), on a call with coincident faces in different clusters, and through
`interactive` (frames equal to the per-ray traversal's bit for bit, 8
launches per frame) and `bench`; `render` with material sort, first-bounce
cache and motion blur; the three traversals timed side by side on a sorted
and an unsorted frame of each mesh scene (events and device time, visits
per frame), with the tests a thread-per-ray warp would issue for them, the
per-ray kernel held to its plain version and to its builds at live-ray
thresholds 1 and 33 (each cluster tested one of its two ways), and the two
tile kernels to the per-ray kernel, on every call of those four frames;
and the visit-cost probe (`tools/mm_feasibility.py`: the scalar and the
tensor-core visit kernel, each launch's visits split over the card,
against their plain versions, one block against the split bit for bit,
every launch's visit count, then device time and microseconds per visit,
and one block's at fewer visits).  The command-line slice: `interactive`
on cornell at 800x800, 8 frames, with `--serve` and a viewer thread on
loopback (it reads `/`, sends `/camera?dphi=`, reads the first part of
`/stream`: an emitted frame, rounded to 8 bits with + 0.5; the PNG branch
also with PIL's import taken away) and without, each K1 x 8 and K2 x 28 x 8,
sustained wall ms per frame and device ms per frame, and one frame's
dispatch with no host sync; `render --hdr --save-gbuffer` (the RGBE decode
and the G-buffer against `render`); `randomize`, `datagen --variants 2`
(3 scenes x 8 frames at 256x256) and `fit_streamed` over that corpus, one
group per shard (every window once, the copy times and how much of them the
steps hid, one shard bit for bit `fit_device_data`); the denoiser with
`prepare_inference(pad_multiple=8)` against the default.  The
edge-gradient slice (`render/edge_grad.py`): every gradient function at
the JAX defaults (512 edge samples, 128 iterations) on cornell at 800x800
(the sphere, the ceiling light, the camera) and on the icosahedron scene,
the blob's boundary term, with no kernel launch but K10's (these renders
keep the plain wavefront under autograd; its geom queries where no
gradient passes take K10), the interior terms' peak memory, the
shoelace area oracle, the batched `mean_radiance` bit for bit its loop,
the card's gradients against the CPU's on the 64x64 edge scenes, and a
full-width backward that is not zero (the 800x800 edge box shaded by
|normal|) against the CPU's.  The parallel slice (`parallel/`) as a
world of one over NCCL: `train --data-parallel` on the training corpus,
`render_sharded` of cornell and the blob (bit for bit `render`),
`denoise_frame_spatial` with the shipped denoiser (against `apply_frame`),
the data-parallel step bit for bit `train_step`, each rank's render in 4
tiles (K1 at pixel offsets, the blob's BVH kernel) bit for bit the whole
frame, and the halo conv through K2 in 4 and 5 row slices against the
whole conv.  The conv
kernels are checked on the frame's 28 shapes (bfloat16, float32 and batched
input; the row-band kernel also on a zero-bordered input, odd and aligned
Cin), both also at shapes the frame never reaches (Co = 202, 3 -> 3, ragged
widths, a batch of 4), and the conv's autograd on the train step's 28 shapes against
the plain backward pass and `F.conv2d`'s; the conv kernels are timed by
CUDA graph replay (device time) beside the events-around-calls time.  It
checks that every path went through its kernels with the launch counts it
computes itself, that the
loss on a fixed batch is finite and falls, that the checkpoint reloads to the
same loss and that the frames are finite and decode, and times each kernel beside
its plain version, the least time the card could take (its bound) and,
where one exists, a PyTorch library call for the same function.  Each
phase prints one JSON line; the last lines are the `kernels` summary, the
card's name and power limit as nvidia-smi reports them, and
`{"ok": true, "device": {...}}`.  Any failed check raises and the script
exits non-zero.  Without a CUDA device it exits 2 at once.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "runs", "chip_smoke")
SCENE = os.path.join(ROOT, "scenes", "cornell_box.txt")
MESH_SCENES = {"blob": os.path.join(ROOT, "scenes", "cornell_mesh_blob.txt"),
               "statue": os.path.join(ROOT, "scenes", "cornell_mesh_statue.txt")}
MESH_FRAMES = 4
# Operations per test, counted from csrc/mesh_common.cuh as the megakernel's
# are (render/cuda_backend.py): one Moller-Trumbore face test, one slab test.
OPS_TRIANGLE = 60
OPS_AABB = 27
MODEL = os.path.join(ROOT, "artifacts", "denoiser_multiscene.npz")
FRAMES = 8
# The training cell: 14 orbit frames, one pan, one noise seed -> 14 windows,
# 3 steps of batch 4 in one epoch.
TRAIN_RES, TRAIN_FRAMES, TRAIN_GT_SPP = 512, 14, 64
TRAIN_BATCH, TRAIN_CROP, TRAIN_SEQ = 4, 256, 7
MODEL_FRAMES = 2              # interactive frames per conv impl, trained model
KPCN_FRAMES = 4               # interactive --denoiser kpcn frames at 800x800
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
IMPL_FRAMES = 2               # interactive frames per traversal and sort setting
BENCH_ITERS = {"cornell_box": 64, "blob": 3, "statue": 2}
PROBE_VISITS = 32768          # the visit-cost probe's own count
PROBE_ONE_SM_VISITS = 2048    # visits of the one-block (one SM) launches timed beside it
# K4 also built at these live-ray thresholds (mesh_kernel_v2p.K_THR): 1 tests
# every visited cluster lane by ray, 33 ray by ray; each must equal K4
K4_WITNESSES = (1, 33)
VISIT_SLICE = 2048            # rays of each whole-tile slice a tile kernel's visits are held on
STATUE_SLICE = 64000          # rays of a statue call held whole-plain past bounce 1
OPS_VISIT_TEST = 12           # hit test + division per (face, ray) of the product visit
OPS_EDGES = 6                 # v1 - v0, v2 - v0: per staged face, not per (face, ray)


SERVE_DPHI = 0.02             # the preview viewer's one camera input
RENDER_SPP = 16               # render --hdr --save-gbuffer
# datagen --variants: the scene and 2 randomized variants x 8 frames at
# 256x256, 16-spp truth; fit_streamed on 128x128 crops, one group per shard
VARIANTS, VARIANT_RES, VARIANT_FRAMES, VARIANT_GT_SPP = 2, 256, 8, 16
STREAM_CROP = 128
# The campaign driver (tools/train_pipeline.py) at the JAX defaults' shapes
# (512x512 frames, batch 4, 256x256 crops, 7-frame windows, default widths,
# bfloat16) with its counts cut: flag -> (value here, the driver's default).
CAMPAIGN_CUTS = {"train-scenes": (2, 28), "eval-scenes": (1, 4), "frames": (28, 48),
                 "noise-seeds": (1, 3), "movs": (1, 2), "gt-spp": (64, 800),
                 "gt-spp-eval": (128, 2000), "epochs": (2, 60), "bn-recal": (2, 120)}
CAMPAIGN_RES = 512
CAMPAIGN_TIMED_STEPS = 5      # timed train steps a side, remat and plain in turns
# rel L2 of the card's eval window against the CPU's.  Each conv rounds its
# input to bfloat16 and the recurrence carries a difference in sum order
# across frames; the bar sits above what sum order alone moves the window
# and below what a planted conv fault moves it (tools/eval_bar_probe.py)
CAMPAIGN_EVAL_BAR = 5e-3


def binned_paths():
    """Calls of the binned pipeline that took the packed path / fell back,
    from the port's counters (utils/timers.py)."""
    from ai_path_tracer_denoiser_tpu_torch.utils.timers import totals
    now = totals()
    return {side: now.get("binned." + side, 0) for side in ("fast", "fallback")}


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Milliseconds of device time per call of ``fn``: ``reps`` calls
    captured in one CUDA graph and replayed between two events, so the
    host's dispatch between calls is not counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm up off the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, ops, peak):
    t_bytes, t_ops = n_bytes / HBM_BPS, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def recording(module, name, calls, after=None):
    """Record the positional arguments of every call of ``module.name``;
    ``after()`` runs when a call has returned."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(args)
        out = orig(*args, **kwargs)
        if after is not None:
            after()
        return out

    setattr(module, name, wrapped)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def subset(planes, idx):
    """The lanes ``idx`` of a tuple of ray planes / Vec3s."""
    return tuple(type(p)(*(c[idx] for c in p)) if isinstance(p, tuple) else p[idx]
                 for p in planes)


def max_abs_diff(got, want):
    """Largest |difference| over paired tensors; inf == inf counts as 0."""
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        worst = max(worst, float(torch.nan_to_num(diff, nan=float("inf")).max()))
    return worst


def flat_hit(result):
    t, p, n, mat = result
    return (t, *p, *n, mat)


def reset_launches(kernels):
    for k in kernels:
        k.launches = 0


def nonzero_launches(kernels):
    return {k.name: k.launches for k in kernels if k.launches}


@contextlib.contextmanager
def preview_viewer(preview, dphi):
    """While the block runs, ``interactive --serve`` meets a viewer: at the
    server's first ``pop_camera`` a client thread reads ``/``, sends
    ``/camera?dphi=``, joins ``/stream`` (before the first frame is made)
    and reads its first part.  Yields a dict that gets ``page``,
    ``part`` (mime, bytes), ``pushed`` (every array pushed) and
    ``camera`` (what each ``pop_camera`` returned)."""
    import http.client
    import threading
    import urllib.request

    import numpy as np
    out = {"pushed": [], "camera": []}
    joined = threading.Event()
    cls = preview.PreviewServer
    orig_pop, orig_push = cls.pop_camera, cls.push

    def viewer(port):
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/", timeout=30) as page:
            out["page"] = (page.status, page.read())
        with urllib.request.urlopen(f"{base}/camera?dphi={dphi}", timeout=30) as cam:
            out["camera_status"] = cam.status
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        out["stream_type"] = resp.getheader("Content-Type")
        joined.set()
        require(b"--frame" in resp.fp.readline(), "multipart boundary")
        mime = resp.fp.readline().split(b":")[1].strip().decode()
        length = int(resp.fp.readline().split(b":")[1])
        resp.fp.readline()
        out["part"] = (mime, resp.fp.read(length))
        conn.close()

    def pop_camera(self):
        if "thread" not in out:
            out["thread"] = threading.Thread(target=viewer, args=(self.port,), daemon=True)
            out["thread"].start()
            require(joined.wait(60), "the viewer joined /stream")
        got = orig_pop(self)
        out["camera"].append(got)
        return got

    def push(self, frame):
        out["pushed"].append(np.array(frame))
        return orig_push(self, frame)

    cls.pop_camera, cls.push = pop_camera, push
    try:
        yield out
    finally:
        cls.pop_camera, cls.push = orig_pop, orig_push
        if "thread" in out:
            out["thread"].join(60)


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_geom_kernel(smi, dev):
    """K10 (csrc/geom_intersect.cu) against its plain version on every
    analytic-geom query of one 800x800 statue frame (frame 0 of the orbit,
    all 640,000 rays at every bounce, dead lanes included): all five
    outputs bit for bit, its launches per frame, its time per call (events
    around calls back to back, and device time from a CUDA graph replay)
    beside its bound and the plain version's time; then the frame itself
    through K10 and with the plain version forced, in turns, G-buffers
    bit for bit.  Returns the kernel's row of the ``kernels`` summary."""
    import dataclasses
    import torch
    from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
    from ai_path_tracer_denoiser_tpu_torch.ops import intersect as tintersect
    from ai_path_tracer_denoiser_tpu_torch.render import cuda_backend, render_gbuffer_frame
    from ai_path_tracer_denoiser_tpu_torch.scene import (load_scene, orbit_camera,
                                                         orbit_params_from_camera)
    from ai_path_tracer_denoiser_tpu_torch.utils.cuda_build import swapped
    from ai_path_tracer_denoiser_tpu_torch.utils.timers import totals
    kernel = tintersect.GEOM_KERNEL
    sc = load_scene(MESH_SCENES["statue"], device=dev)
    ph, th, zm = orbit_params_from_camera(sc.camera)
    sc = dataclasses.replace(sc, camera=orbit_camera(sc.camera, ph, th, zm))
    opts = RenderOptions()
    render_gbuffer_frame(sc, opts)                              # builds, warms
    torch.cuda.synchronize()
    calls = []
    launches, counted = kernel.launches, totals().get("geoms.kernel", 0)
    with recording(tintersect, "intersect_geoms_v", calls):
        _, gbuf_k, _ = render_gbuffer_frame(sc, opts)
    torch.cuda.synchronize()
    frame_launches = kernel.launches - launches
    require(frame_launches == len(calls) == totals().get("geoms.kernel", 0) - counted,
            "K10: one launch and one geoms.kernel count per query of the frame")

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def flat(r):
        return [r[0], *r[1], *r[2], r[3], r[4]]

    checks, err = [], 0.0
    for k, (geoms, o, d) in enumerate(calls):
        got = flat(tintersect.intersect_geoms_kernel(geoms, o, d))
        want = flat(tintersect.intersect_geoms_plain(geoms, o, d))
        equal = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
        err = max(err, max_abs_diff([a.float() for a in got], [b.float() for b in want]))
        checks.append({"call": k, "rays": o.x.numel(), "hits": int(torch.isfinite(want[0]).sum()),
                       "bits_equal": equal})
        require(equal, f"K10 equals its plain version bit for bit on call {k}")
    emit({"phase": "geom_check", "scene": "statue", "res": list(sc.camera.resolution),
          "geoms": sc.geoms.count, "calls": checks, "max_abs_err": err,
          "launches_per_frame": frame_launches})

    geoms, o, d = calls[0]
    n = o.x.numel()
    run = lambda: tintersect.intersect_geoms_kernel(geoms, o, d)      # noqa: E731
    plain = lambda: tintersect.intersect_geoms_plain(geoms, o, d)     # noqa: E731
    events = time_ms(run, 50)
    device = graph_ms(run, 50)
    plain_ms = time_ms(plain, 5)
    frame_events = sum(time_ms(lambda c=c: tintersect.intersect_geoms_kernel(*c), 10)
                       for c in calls)
    frame_device = sum(graph_ms(lambda c=c: tintersect.intersect_geoms_kernel(*c), 20)
                       for c in calls)
    frame_plain = sum(time_ms(lambda c=c: tintersect.intersect_geoms_plain(*c), 3)
                      for c in calls)
    n_bytes, ops = cuda_backend.geoms_work(n, sc.geoms.type_tuple)
    bound, by = bound_ms(n_bytes, ops, FP32_FLOPS)
    frame_bound = sum(bound_ms(*cuda_backend.geoms_work(c[1].x.numel(), sc.geoms.type_tuple),
                               FP32_FLOPS)[0] for c in calls)

    def frame_wall_ms(route):
        rule = tintersect.geoms_route if route == "kernel" else (lambda *a: "plain")
        with swapped(tintersect, "geoms_route", rule):
            torch.cuda.synchronize()
            t0 = time.time()
            out = render_gbuffer_frame(sc, opts)[1]
            torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    walls = {"kernel": [], "plain": []}
    gbuf_p = None
    for route in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        out, ms = frame_wall_ms(route)
        walls[route].append(ms)
        if route == "plain":
            gbuf_p = out
    require(torch.equal(bits(gbuf_k), bits(gbuf_p)),
            "the statue frame's G-buffer is the same on both routes")
    emit({"phase": "geom_timing", "card": smi, "rays": n, "geoms": sc.geoms.count,
          "events_ms": events, "device_ms": device, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": by, "bound_share": bound / device,
          "frame_events_ms": frame_events, "frame_device_ms": frame_device,
          "frame_bound_ms": frame_bound, "frame_plain_ms": frame_plain,
          "frame_calls": len(calls), "frame_wall_ms": walls,
          "note": "events/device/plain: the frame's first call (all rays); frame_*: "
                  "every call of the frame summed; frame_wall_ms: the whole statue "
                  "frame (render_gbuffer_frame, the card drained) by route, in turns"})
    return {"name": "geom_intersect", "route": "cuda",
            "source": "ai_path_tracer_denoiser_tpu_torch/csrc/geom_intersect.cu",
            "replaces": None, "launches": frame_launches, "max_abs_err": err,
            "ms": frame_events, "device_ms": frame_device, "per_call_ms": events,
            "per_call_device_ms": device, "plain_ms": frame_plain,
            "plain_per_call_ms": plain_ms, "bound_ms": frame_bound, "bound_by": by,
            "per_call_bound_ms": bound, "library_ms": None}


def phase_kpcn_kernels(smi, dev, reps=20):
    """K11 (csrc/conv5x5_act.cu) and K12 (csrc/kernel_apply.cu) on an 800x800
    cornell frame denoised by the kernel-predicting network at its published
    widths (weights from seed 0): each of the nine convs' calls against the
    plain version on the card (one bfloat16 step apart, values near zero
    within 1e-4 of the layer's largest), the apply against its plain
    version (1e-5); launches per frame; events and device ms (CUDA graph
    replay) of the nine convs and of the apply, beside their bounds
    (perfbench/counts_kpcn.py, from the published shapes), the plain
    versions' ms and, for the convs, ``F.conv2d``'s in bfloat16
    channels-last at the same shapes (cuDNN; the port never calls it);
    then each conv alone: events, device ms, its bound and share of it,
    and ``F.conv2d``'s ms.
    Returns the two kernels' rows of the ``kernels`` summary."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from ai_path_tracer_denoiser_tpu_torch.config import KPCNOptions, RenderOptions
    from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel, kpcn
    from ai_path_tracer_denoiser_tpu_torch.render import render_gbuffer_frame
    from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene
    from perfbench import counts_kpcn
    opts = KPCNOptions()
    sc = load_scene(SCENE, device=dev)
    c = sc.camera
    sc = dataclasses.replace(sc, camera=derive_camera(
        (800, 800), float(c.fov[1]), c.position.numpy(), c.look_at.numpy(), c.up.numpy()))
    gbuf = render_gbuffer_frame(sc, RenderOptions())[1]
    params = kpcn.init_kpcn(0, opts, dev)
    kpcn.apply_kpcn_frame(params, gbuf, opts)                   # builds, warms
    torch.cuda.synchronize()
    calls = []
    launches = (conv_kernel.KERNEL5.launches, kpcn.APPLY_KERNEL.launches)
    with recording(kpcn, "conv5x5_act", calls):
        y, logits = kpcn.apply_kpcn_frame(params, gbuf, opts, return_logits=True)
    torch.cuda.synchronize()
    per_frame = (conv_kernel.KERNEL5.launches - launches[0],
                 kpcn.APPLY_KERNEL.launches - launches[1])
    require(per_frame == (9, 1) and len(calls) == 9, "K11 9 and K12 1 launch a frame")
    conv_err = []
    for i, (x, w, b, relu) in enumerate(calls, 1):
        got = conv_kernel.conv5x5_act(x, w, b, relu).float()
        want = conv_kernel.conv5x5_act_plain(x, w, b, relu).float()
        tol = 2.0 ** -7 * want.abs() + 1e-4 * float(want.abs().max())
        bad = int(((got - want).abs() > tol).sum())
        conv_err.append({"layer": i, "shape": list(x.shape) + [w.shape[-1]],
                         "max_abs_err": float((got - want).abs().max()),
                         "out_max": float(want.abs().max()), "outside_tol": bad})
        require(bad == 0, f"K11 layer {i} within one bfloat16 step of its plain version")
    rad = gbuf[None, 0:3]
    got = kpcn.kernel_apply(logits, rad, opts.kernel)
    want = kpcn.kernel_apply_plain(logits, rad, opts.kernel)
    apply_err = float((got - want).abs().max())
    require(bool(((got - want).abs() <= 1e-5 * want.abs() + 4e-6).all()),
            "K12 within 1e-5 of its plain version")
    emit({"phase": "kpcn_check", "res": [800, 800], "convs": conv_err,
          "apply_max_abs_err": apply_err, "launches_per_frame": list(per_frame),
          "frame_finite": bool(torch.isfinite(y).all())})

    def convs(fn):
        return lambda: [fn(*a) for a in calls]

    def library(layers=calls):
        xs = [a[0].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
              for a in layers]
        ws = [a[1].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for a in layers]
        bs = [a[2].to(torch.bfloat16) for a in layers]
        return lambda: [F.conv2d(x, w, b, padding=2) for x, w, b in zip(xs, ws, bs)]
    apply = lambda: kpcn.kernel_apply(logits, rad, opts.kernel)           # noqa: E731
    m = {"in_channels": 30, "width": 100, "layers": 9, "kernel": 21}
    conv_bound = counts_kpcn.conv_bound_s(counts_kpcn.kpcn_convs(800, 800, m)) * 1e3
    apply_bound = counts_kpcn.apply_bound_s(800, 800, 21) * 1e3
    t = {"conv_ms": time_ms(convs(conv_kernel.conv5x5_act), reps),
         "conv_device_ms": graph_ms(convs(conv_kernel.conv5x5_act), reps),
         "conv_plain_ms": time_ms(convs(conv_kernel.conv5x5_act_plain), 2, warmup=1),
         "conv_library_ms": time_ms(library(), reps),
         "apply_ms": time_ms(apply, reps), "apply_device_ms": graph_ms(apply, reps),
         "apply_plain_ms": time_ms(lambda: kpcn.kernel_apply_plain(logits, rad, opts.kernel),
                                   2, warmup=1),
         "frame_ms": time_ms(lambda: kpcn.apply_kpcn_frame(params, gbuf, opts), reps)}
    # each layer alone: events, device time (graph replay), its own bound
    # from the published shapes, and cuDNN's conv at the same shape
    per_layer = [time_ms(lambda a=a: conv_kernel.conv5x5_act(*a), reps) for a in calls]
    layer_device = [graph_ms(lambda a=a: conv_kernel.conv5x5_act(*a), reps) for a in calls]
    layer_bound = [counts_kpcn.conv_bound_s([c]) * 1e3
                   for c in counts_kpcn.kpcn_convs(800, 800, m)]
    layer_library = [time_ms(library([a]), reps) for a in calls]
    emit({"phase": "kpcn_timing", "card": smi, **t, "conv_bound_ms": conv_bound,
          "apply_bound_ms": apply_bound, "conv_roofline_pct": 100 * conv_bound
          / t["conv_device_ms"], "apply_roofline_pct": 100 * apply_bound / t["apply_device_ms"],
          "conv_layer_ms": per_layer, "conv_layer_device_ms": layer_device,
          "conv_layer_bound_ms": layer_bound,
          "conv_layer_roofline_pct": [100 * b / d for b, d in zip(layer_bound, layer_device)],
          "conv_layer_library_ms": layer_library,
          "plans": [conv_kernel.conv5_plan(*a[0].shape[:3], a[1].shape[-1])._asdict()
                    for a in calls[::8]]})
    return [{"name": "conv5x5_act", "route": "cuda",
             "source": "ai_path_tracer_denoiser_tpu_torch/csrc/conv5x5_act.cu",
             "replaces": None, "launches": per_frame[0],
             "max_abs_err": max(e["max_abs_err"] for e in conv_err), "ms": t["conv_ms"],
             "device_ms": t["conv_device_ms"], "plain_ms": t["conv_plain_ms"],
             "bound_ms": conv_bound, "bound_by": "operations",
             "library_ms": t["conv_library_ms"], "layer_device_ms": layer_device},
            {"name": "kernel_apply", "route": "cuda",
             "source": "ai_path_tracer_denoiser_tpu_torch/csrc/kernel_apply.cu",
             "replaces": None, "launches": per_frame[1], "max_abs_err": apply_err,
             "ms": t["apply_ms"], "device_ms": t["apply_device_ms"],
             "plain_ms": t["apply_plain_ms"], "bound_ms": apply_bound, "bound_by": "bytes",
             "library_ms": None}]


def phase_kpcn_path(cli, kernels, smi, dev):
    """``interactive --denoiser kpcn`` on cornell at 800x800 through
    ``cli.main``, with every launch count and the program's counters
    zeroed just before: K1 once, K11 nine times and K12 once a frame and
    no other kernel, the convs and the apply counted on the kernel side
    alone, no counted host read in a frame's denoise, finite frames whose
    PNGs decode."""
    from ai_path_tracer_denoiser_tpu_torch.models import conv_kernel, kpcn
    from ai_path_tracer_denoiser_tpu_torch.utils import timers
    from ai_path_tracer_denoiser_tpu_torch.utils.imageio import read_png
    every = tuple(kernels) + (conv_kernel.KERNEL5, kpcn.APPLY_KERNEL)
    for k in every:
        k.launches = 0
    timers.reset()
    records = cli.main(["interactive", SCENE, "--denoiser", "kpcn",
                        "--frames", str(KPCN_FRAMES),
                        "--out-dir", os.path.join(OUT_DIR, "kpcn_frames")])
    launches = {k.name: k.launches for k in every}
    want = {**{k.name: 0 for k in every}, "render_megakernel": KPCN_FRAMES,
            "conv5x5_act": 9 * KPCN_FRAMES, "kernel_apply": KPCN_FRAMES}
    require(launches == want, f"K1 1, K11 9 and K12 1 launch a frame, no other: {launches}")
    kpcn_counts = {k: v for k, v in timers.totals().items() if k.startswith("kpcn.")}
    require(kpcn_counts == {"kpcn.conv.kernel": 9 * KPCN_FRAMES,
                            "kpcn.apply.kernel": KPCN_FRAMES},
            f"kpcn counters on the kernel side alone: {kpcn_counts}")
    denoise_reads = [sum(v for k, v in r["counts"].items() if k.startswith("sync."))
                     for r in timers.records("denoise.frame")]
    require(len(denoise_reads) == KPCN_FRAMES and not any(denoise_reads),
            f"no host read in a frame's denoise: {denoise_reads}")
    for rec in records:
        require(rec["finite"], f"kpcn frame {rec['frame']} finite")
        img = read_png(rec["path"])
        require(img.shape == (800, 800, 3) and img.std() > 0, "kpcn frame PNG decodes")
    emit({"phase": "kpcn_path", "scene": "cornell_box", "res": [800, 800],
          "frames": KPCN_FRAMES, "launches": launches, "counters": kpcn_counts,
          "denoise_host_reads": denoise_reads, "card": smi,
          "per_frame_ms": [{k: round(v, 3) for k, v in rec.items() if k.endswith("_ms")}
                           for rec in records]})


def phase_serve_path(cli, kernels, smi, dev):
    """``interactive`` on cornell at 800x800 with the shipped model, 8
    frames, with ``--serve`` and a viewer on loopback and without; then
    one frame's dispatch under the sync debug mode."""
    import urllib.request
    import warnings

    import numpy as np
    import torch

    from ai_path_tracer_denoiser_tpu_torch.models import (
        apply_frame_fast_padded, init_hidden, load_model, model_options_from_meta,
        prepare_inference)
    from ai_path_tracer_denoiser_tpu_torch.render import render_gbuffer_frame
    from ai_path_tracer_denoiser_tpu_torch.scene import load_scene
    from ai_path_tracer_denoiser_tpu_torch.utils import preview
    from ai_path_tracer_denoiser_tpu_torch.utils.imageio import (encode_png, read_png,
                                                                 save_png_scaled)
    runs = {}
    for serve in (True, False):
        name = "with_serve" if serve else "without_serve"
        out_dir = os.path.join(OUT_DIR, "serve", name)
        argv = ["interactive", SCENE, "--frames", str(FRAMES), "--model", MODEL,
                "--out-dir", out_dir]
        ctx = preview_viewer(preview, SERVE_DPHI) if serve else contextlib.nullcontext({})
        with ctx as seen:
            reset_launches(kernels)
            records = cli.main(argv + (["--serve", str(free_port())] if serve else []))
            launches = nonzero_launches(kernels)
        require(launches == {"render_megakernel": FRAMES, "conv3x3_act": 28 * FRAMES},
                f"{name}: launches {launches}")
        require([r["frame"] for r in records] == list(range(FRAMES)), f"{name}: frame order")
        for rec in records:
            img = read_png(rec["path"])
            require(rec["finite"] and img.shape == (800, 800, 3) and img.std() > 0,
                    f"{name}: frame {rec['frame']} finite, PNG decodes")
        emitted = [r["emitted_s"] for r in records]
        runs[name] = {
            "launches": launches,
            "sustained_wall_ms_per_frame": (emitted[-1] - emitted[0]) / (FRAMES - 1) * 1e3,
            "device_ms_per_frame_median_after_first": statistics.median(
                r["total_ms"] for r in records[1:]),
            "render_ms_median_after_first": statistics.median(
                r["render_ms"] for r in records[1:]),
            "denoise_ms_median_after_first": statistics.median(
                r["denoise_ms"] for r in records[1:])}
        if serve:
            mime, data = seen["part"]
            require(seen["page"][0] == 200 and b"/stream" in seen["page"][1]
                    and seen["camera_status"] == 204
                    and "multipart/x-mixed-replace" in seen["stream_type"], "viewer requests")
            require(any(abs(c.get("dphi", 0.0) - SERVE_DPHI) < 1e-12 for c in seen["camera"]),
                    f"the viewer's camera input reached the loop: {seen['camera']}")
            require(len(seen["pushed"]) == FRAMES, "every frame pushed")
            quantised = [(np.clip(a, 0, 1) * 255.0 + 0.5).astype(np.uint8)
                         for a in seen["pushed"]]
            served_path = os.path.join(out_dir, "served" + (".png" if mime == "image/png"
                                                              else ".jpg"))
            with open(served_path, "wb") as f:
                f.write(data)
            if mime == "image/png":
                shape = read_png(served_path).shape
                match = [i for i, q in enumerate(quantised) if encode_png(q) == data]
                require(bool(match), "the served PNG is encode_png of an emitted frame, "
                                     "rounded with + 0.5")
            else:
                from PIL import Image
                shape = np.asarray(Image.open(served_path).convert("RGB")).shape
                match = [i for i, q in enumerate(quantised) if preview._encode(q)[1] == data]
                require(bool(match), "the served JPEG is _encode of an emitted frame")
            require(shape == (800, 800, 3), f"served frame shape {shape}")
            # what was pushed is what was written (the PNG truncates, + 0 not + 0.5)
            for a, rec in zip(seen["pushed"], records):
                require(np.array_equal(read_png(rec["path"]),
                                       (np.clip(a, 0, 1) * 255.0).astype(np.uint8)),
                        f"frame {rec['frame']}: pushed array is the written frame")
            runs[name].update(served_mime=mime, served_bytes=len(data),
                              served_frame=match[0], camera_inputs=seen["camera"][:2])
            # the other branch of the encoder: PIL's import taken away
            saved_pil = sys.modules.get("PIL", "absent")
            sys.modules["PIL"] = None
            server = preview.PreviewServer(port=0)
            try:
                server.push(seen["pushed"][-1])
                with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stream",
                                            timeout=30) as resp:
                    require(b"--frame" in resp.readline(), "multipart boundary")
                    png_mime = resp.readline().split(b":")[1].strip().decode()
                    png = resp.read(int(resp.readline().split(b":")[1]) + 2)[2:]
            finally:
                server.close()
                if saved_pil == "absent":
                    del sys.modules["PIL"]
                else:
                    sys.modules["PIL"] = saved_pil
            png_path = os.path.join(out_dir, "served_without_pil.png")
            with open(png_path, "wb") as f:
                f.write(png)
            require(png_mime == "image/png" and png == encode_png(quantised[-1])
                    and read_png(png_path).shape == (800, 800, 3),
                    "without PIL the served part is encode_png of the frame, rounded with + 0.5")
            runs[name]["png_branch_bytes"] = len(png)
            # the host's share of a frame: the emit's encodes, each alone
            frame = seen["pushed"][-1]
            encode_ms = {}
            for key, fn in (("save_png_scaled", lambda: save_png_scaled(
                                os.path.join(out_dir, "encode_timing"), frame)),
                            ("encode_png", lambda: encode_png(quantised[-1])),
                            ("preview_encode", lambda: preview._encode(quantised[-1]))):
                t0 = time.perf_counter()
                for _ in range(3):
                    fn()
                encode_ms[key] = (time.perf_counter() - t0) / 3 * 1e3
            runs[name]["host_encode_ms"] = encode_ms
    # one frame dispatched (after a warm-up) under the sync debug mode: no
    # call in render_gbuffer_frame or apply_frame_fast_padded may wait for
    # the card, or the emit pipeline would be serial again
    scene = load_scene(SCENE, device=dev)
    params, bn_state, meta = load_model(MODEL, device=dev)
    mopts = model_options_from_meta(meta)
    folded = prepare_inference(params, bn_state, mopts)
    hidden = init_hidden(1, 800, 800, mopts, dtype=torch.bfloat16, device=dev)

    def dispatch(hd):
        _, gbuf, _ = render_gbuffer_frame(scene)
        return apply_frame_fast_padded(folded, gbuf.permute(1, 2, 0)[None], hd, mopts)[1]
    hidden = dispatch(hidden)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            dispatch(hidden)
            dispatch_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if not str(w.message).startswith("Synchronization debug mode is a prototype")})
    with_s, without_s = runs["with_serve"], runs["without_serve"]
    emit({"phase": "serve_path", "card": smi, "scene": "cornell_box", "res": [800, 800],
          "frames": FRAMES, "runs": runs,
          "serve_cost_ms_per_frame": with_s["sustained_wall_ms_per_frame"]
          - without_s["sustained_wall_ms_per_frame"],
          "device_idle_share_without_serve": max(0.0, 1.0 - without_s[
              "device_ms_per_frame_median_after_first"] / without_s[
              "sustained_wall_ms_per_frame"]),
          "host_syncs_in_one_frame_dispatch": syncs, "host_dispatch_ms_of_one_frame": dispatch_ms,
          "columns": "sustained_wall_ms_per_frame: host clock between the first and the last "
                     "frame's emit (records' emitted_s) over FRAMES - 1; device_ms: CUDA events "
                     "around render + denoise; host_syncs: torch.cuda.set_sync_debug_mode('warn') "
                     "while one frame's render and denoise are dispatched; host_encode_ms: the "
                     "host clock around each encode of the last frame (mean of 3): the written "
                     "PNG, the served PNG (no PIL) and the served part (JPEG where PIL imports)"})
    require(not syncs, f"host syncs in a frame's dispatch: {syncs}")


def phase_render_outputs(cli, kernels, smi, dev):
    """``render --hdr --save-gbuffer`` on cornell at 800x800: the HDR and
    the G-buffer against ``render`` on the same scene."""
    import numpy as np

    from ai_path_tracer_denoiser_tpu_torch.render import render
    from ai_path_tracer_denoiser_tpu_torch.scene import load_scene
    out = os.path.join(OUT_DIR, "render_outputs", "cornell")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    reset_launches(kernels)
    written = cli.main(["render", SCENE, "--spp", str(RENDER_SPP), "--out", out + ".png",
                        "--hdr", "--save-gbuffer"])
    launches = nonzero_launches(kernels)
    require(launches == {"render_megakernel": -(-RENDER_SPP // 64)},
            f"render launches {launches}")
    require(written == {"png": out + ".png", "hdr": out + ".hdr",
                        "gbuffer": out + "_gbuffer.npy"}, f"render wrote {written}")
    image, gbuffer, _ = render(load_scene(SCENE, device=dev), num_iterations=RENDER_SPP)
    image = image.flip(1).cpu().numpy()
    with open(written["hdr"], "rb") as f:
        data = f.read()
    head, _, rest = data.partition(b"\n\n")
    dims, _, body = rest.partition(b"\n")
    require(head == b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe" and dims == b"-Y 800 +X 800"
            and len(body) == 800 * 800 * 4, f"HDR header {head!r} {dims!r}")
    rgbe = np.frombuffer(body, np.uint8).reshape(800, 800, 4).astype(np.float64)
    scale = np.where(rgbe[..., 3] > 0, np.ldexp(1.0, rgbe[..., 3].astype(int) - 136), 0.0)
    decoded = (rgbe[..., :3] + 0.5) * scale[..., None]
    err = np.abs(decoded - image)
    rel = err / np.maximum(image.max(axis=-1, keepdims=True), 1e-30)
    hdr_ok = bool(np.all(err <= 2.0 ** -8 * image.max(axis=-1, keepdims=True) + 1e-30))
    saved = np.load(written["gbuffer"])
    want = gbuffer.cpu().numpy()
    emit({"phase": "render_outputs", "card": smi, "spp": RENDER_SPP, "launches": launches,
          "hdr_max_rel_err_of_pixel_max": float(rel.max()),
          "gbuffer_shape": list(saved.shape), "gbuffer_equal_to_render": bool(
              np.array_equal(saved, want)),
          "tolerance": "RGBE decode (mantissa + 0.5) within 2**-8 of each pixel's largest "
                       "channel of the displayed image; G-buffer equal bit for bit to "
                       "render()'s on the same scene"})
    require(hdr_ok, f"HDR decode vs image: max rel {float(rel.max())}")
    require(saved.shape == (10, 800, 800) and saved.dtype == np.float32
            and np.isfinite(saved).all() and np.array_equal(saved, want),
            "the saved G-buffer is render()'s")


def phase_variants_stream_path(cli, kernels, smi, dev):
    """``randomize``; ``datagen --variants 2`` on cornell (3 scenes x 8
    frames, 256x256, 16-spp truth); ``fit_streamed`` over it, one group per
    shard (3 shards, both buffers reused) against the same steps on the
    device-resident corpus, then one shard against ``fit_device_data``, both
    bit for bit."""
    import shutil

    import numpy as np
    import torch

    from ai_path_tracer_denoiser_tpu_torch.config import (ModelOptions, RenderOptions,
                                                          TrainOptions)
    from ai_path_tracer_denoiser_tpu_torch.data import SequenceDataset
    from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
    from ai_path_tracer_denoiser_tpu_torch.render import cuda_backend
    from ai_path_tracer_denoiser_tpu_torch.scene import parse_scene_text
    from ai_path_tracer_denoiser_tpu_torch.scene.randomizer import generate_variants
    from ai_path_tracer_denoiser_tpu_torch.train import (device_data, fit_device_data,
                                                         init_train_state, load_device_dataset,
                                                         stream_data)
    root = os.path.join(OUT_DIR, "variants")
    shutil.rmtree(root, ignore_errors=True)
    paths = cli.main(["randomize", SCENE, "--count", "2", "--seed", "0",
                      "--out-dir", os.path.join(root, "scenes")])
    require([os.path.basename(p) for p in paths] == ["scene_1.txt", "scene_2.txt"]
            and all(os.path.getsize(p) > 0 for p in paths), f"randomize wrote {paths}")
    with open(SCENE) as f:
        template = f.read()
    texts = list(generate_variants(template, VARIANTS, 0))
    with open(paths[0]) as f:
        require(f.read() == texts[0], "randomize and datagen draw the same variants")
    # a variant whose packed scene is past K1's shared memory renders plain
    eligible = [True] + [cuda_backend.pallas_eligible(parse_scene_text(
        t, base_dir=os.path.dirname(SCENE), device=dev), RenderOptions()) for t in texts]
    data_dir = os.path.join(root, "data")
    reset_launches(kernels)
    t0 = time.time()
    cli.main(["datagen", SCENE, "--variants", str(VARIANTS), "--seed", "0", "--res",
              str(VARIANT_RES), "--frames", str(VARIANT_FRAMES), "--gt-spp", str(VARIANT_GT_SPP),
              "--movs", "1", "--out-dir", data_dir])
    torch.cuda.synchronize()
    datagen_s = time.time() - t0
    datagen_launches = nonzero_launches(kernels)
    want_k1 = 2 * VARIANT_FRAMES * sum(eligible)
    # the plain wavefront of an ineligible variant queries its geoms through K10
    require({k: v for k, v in datagen_launches.items() if k != "geom_intersect"}
            == ({"render_megakernel": want_k1} if want_k1 else {})
            and ("geom_intersect" in datagen_launches) == (not all(eligible)),
            f"datagen --variants launches {datagen_launches}, scenes on K1 {eligible}")
    n_scenes = 1 + VARIANTS
    stems = [f"{s:03d}_0_0_{f:04d}.npy" for s in range(n_scenes) for f in range(VARIANT_FRAMES)]
    for sub in ("input", "gt"):
        require(sorted(os.listdir(os.path.join(data_dir, sub))) == stems, f"datagen {sub} stems")
    x0 = [np.load(os.path.join(data_dir, "input", f"{s:03d}_0_0_0000.npy"))
          for s in range(n_scenes)]
    require(all(x.shape == (VARIANT_RES, VARIANT_RES, 10) and np.isfinite(x).all() for x in x0)
            and not np.array_equal(x0[0], x0[1]) and not np.array_equal(x0[1], x0[2]),
            "the variants' frames")

    dataset = SequenceDataset(os.path.join(data_dir, "input"), os.path.join(data_dir, "gt"),
                              crop=True, crop_size=STREAM_CROP)
    mopt = ModelOptions()
    topt = TrainOptions(epochs=1, crop_size=STREAM_CROP, batch_size=TRAIN_BATCH)
    require(topt.bf16_compute and topt.sequence_length == TRAIN_SEQ, "the reference options")

    class Losses:
        def __init__(self):
            self.total = []

        def scalars(self, step, m):
            self.total.append(float(m["total"]))

    def state0():
        return init_train_state(torch.Generator().manual_seed(topt.seed), mopt, topt, device=dev)

    def differ(a, b):
        return [tree + "/" + "/".join(pa) for tree in ("params", "bn_state")
                for (pa, la), (_, lb) in zip(sorted_leaves(getattr(a, tree)),
                                             sorted_leaves(getattr(b, tree)))
                if not torch.equal(la, lb)]

    items, orig_crops = [], device_data.epoch_crops

    def crops(epoch, idxs, *a):
        items.extend(int(i) for i in idxs)
        return orig_crops(epoch, idxs, *a)

    timings, losses = [], Losses()
    device_data.epoch_crops = crops
    try:
        reset_launches(kernels)
        torch.cuda.synchronize()
        t0 = time.time()
        streamed = stream_data.fit_streamed(state0(), dataset, topt, shard_frames=VARIANT_FRAMES,
                                            logger=losses, log_every=1, model_options=mopt,
                                            timings=timings)
        torch.cuda.synchronize()
        stream_s = time.time() - t0
    finally:
        device_data.epoch_crops = orig_crops
    stream_launches = nonzero_launches(kernels)
    steps = n_scenes * (VARIANT_FRAMES // TRAIN_BATCH)
    k2_per_step = 28 * TRAIN_SEQ + (28 * TRAIN_SEQ - TRAIN_SEQ)
    require(len(timings) == n_scenes and sorted(t["shard"] for t in timings) == [0, 1, 2],
            f"three shards, each visited once: {timings}")
    require(sorted(items) == list(range(len(dataset))), "every window trained exactly once")
    require(streamed.step == steps and len(losses.total) == steps
            and all(np.isfinite(losses.total)), f"streamed steps and losses {losses.total}")
    require(stream_launches == {"conv3x3_act": steps * k2_per_step},
            f"fit_streamed launches {stream_launches}")
    # the same steps on the device-resident corpus: no buffer swap, no side
    # stream; a copy that overran a step would show here
    X, Y, starts = load_device_dataset(dataset, dtype=torch.bfloat16, device=dev)
    replay, quiet = state0(), types.SimpleNamespace(step=lambda *a: None)
    for _, idxs in stream_data._epoch_plan(stream_data.shard_plan(dataset, VARIANT_FRAMES), 0):
        replay, _ = device_data._train_windows(replay, X, Y, starts, idxs, 0, topt, mopt,
                                               quiet, 1)
    del X, Y
    torch.cuda.synchronize()
    differ_replay = differ(streamed, replay)
    # one shard: the device-resident fit, bit for bit
    single = stream_data.fit_streamed(state0(), dataset, topt, shard_frames=len(dataset),
                                      model_options=mopt)
    resident = fit_device_data(state0(), dataset, topt, model_options=mopt)
    torch.cuda.synchronize()
    differ_single = differ(single, resident)
    later = timings[1:]
    per_shard = [{"shard": t["shard"], "frames": t["frames"], "steps": t["steps"],
                  "read_s": t["read_s"], "upload_ms": t["upload_ms"],
                  "exposed_ms": t["exposed_ms"], "steps_ms": t["steps_ms"],
                  "step_ms": t["steps_ms"] / t["steps"]} for t in timings]
    bytes_per_shard = VARIANT_FRAMES * VARIANT_RES * VARIANT_RES * 13 * 2
    emit({"phase": "variants_stream_path", "card": smi,
          "datagen": {"scenes": n_scenes, "frames_per_scene": VARIANT_FRAMES,
                      "res": VARIANT_RES, "gt_spp": VARIANT_GT_SPP, "seconds": datagen_s,
                      "launches": datagen_launches, "scenes_on_k1": eligible},
          "fit_streamed": {"shards": len(timings), "steps": steps, "batch": TRAIN_BATCH,
                           "crop": STREAM_CROP, "sequence": TRAIN_SEQ, "bf16_compute": True,
                           "seconds": stream_s, "launches": stream_launches,
                           "losses": losses.total, "per_shard": per_shard,
                           "upload_bytes_per_shard": bytes_per_shard,
                           "upload_ms_mean": statistics.mean(t["upload_ms"] for t in timings),
                           "step_ms_mean": statistics.mean(
                               t["steps_ms"] / t["steps"] for t in timings),
                           "hidden_share_after_first_shard": statistics.mean(
                               max(0.0, 1.0 - t["exposed_ms"] / t["upload_ms"])
                               for t in later)},
          "three_shards_equal_resident_replay": not differ_replay,
          "replay_leaves_that_differ": differ_replay,
          "single_shard_equals_device_resident": not differ_single,
          "leaves_that_differ": differ_single,
          "columns": "upload_ms: CUDA events around the shard's copy on the side stream; "
                     "exposed_ms: from the compute stream reaching its wait for that copy to "
                     "the copy's end event (0 if it had ended); "
                     "hidden share = 1 - exposed / upload (the first shard of an epoch is "
                     "read and copied before any step); steps_ms: first step to last"})
    require(not differ_replay, f"three-shard fit_streamed vs its resident replay: {differ_replay}")
    require(not differ_single, f"single-shard fit_streamed vs fit_device_data: {differ_single}")


def phase_pad_channels(kernels, smi, dev):
    """The cornell frame's denoise with ``prepare_inference(pad_multiple=8)``
    against the default: outputs, launches, device ms (CUDA graph replay)."""
    import dataclasses

    import numpy as np
    import torch

    from ai_path_tracer_denoiser_tpu_torch.models import (
        apply_frame_fast_padded, init_hidden, load_model, model_options_from_meta,
        prepare_inference)
    from ai_path_tracer_denoiser_tpu_torch.render import render_gbuffer_frame
    from ai_path_tracer_denoiser_tpu_torch.scene import load_scene
    params, bn_state, meta = load_model(MODEL, device=dev)
    mopts = model_options_from_meta(meta)
    _, gbuf, _ = render_gbuffer_frame(load_scene(SCENE, device=dev))
    x = gbuf.permute(1, 2, 0)[None]
    nets = {}
    for mult in (0, 8):
        folded = prepare_inference(params, bn_state, mopts, pad_multiple=mult)
        widths = tuple(folded[f"enc{i}"]["conv1"]["w"].shape[-1] for i in range(1, 6))
        opts = dataclasses.replace(mopts, widths=widths)
        hidden = init_hidden(1, 800, 800, opts, dtype=torch.bfloat16, device=dev)
        reset_launches(kernels)
        y, new_hidden = apply_frame_fast_padded(folded, x, hidden, opts)
        torch.cuda.synchronize()
        nets[mult] = {"widths": widths, "launches": nonzero_launches(kernels),
                      "y": y[0].cpu().numpy(), "hidden": new_hidden,
                      "device_ms": graph_ms(lambda: apply_frame_fast_padded(
                          folded, x, hidden, opts), 10)}
    a, b = nets[8]["y"], nets[0]["y"]
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    close = float((np.abs(a - b) <= 1e-2 + 1.6e-2 * np.abs(b)).mean())
    exact = float((a == b).all(axis=-1).mean())
    pad_zero = all(not bool(nets[8]["hidden"][k][..., c:].any())
                   for k, c in zip(("enc1", "enc2", "enc3", "enc4", "enc5"), mopts.widths))
    emit({"phase": "pad_channels", "card": smi, "res": [800, 800],
          "widths": {str(m): list(v["widths"]) for m, v in nets.items()},
          "launches": {str(m): v["launches"] for m, v in nets.items()},
          "denoise_device_ms": {str(m): v["device_ms"] for m, v in nets.items()},
          "rel_l2_padded_vs_default": rel, "fraction_within_bf16_tolerance": close,
          "pixels_bitwise_equal": exact, "padded_hidden_lanes_zero": pad_zero,
          "tolerance": "rel L2 < 2e-2 and |a-b| <= 1e-2 + 1.6e-2|b| on >= 99% of values (the "
                       "two conv impls' bar); device_ms: one frame's denoise in a CUDA graph"})
    require(nets[8]["widths"] == (32, 48, 64, 80, 104), f"padded widths {nets[8]['widths']}")
    require(all(v["launches"] == {"conv3x3_act": 28} for v in nets.values()),
            f"pad_channels launches {[v['launches'] for v in nets.values()]}")
    require(rel < 2e-2 and close >= 0.99 and np.isfinite(a).all() and pad_zero,
            f"padded denoise vs default: rel L2 {rel}, close {close}")


# parallel/ on the one card: the render in this many tiles, the halo conv
# in these many row slices, iterations of the sharded render
PAR_TILES, PAR_SLICES, PAR_ITERS = 4, (4, 5), 4


def phase_parallel_path(cli, kernels, smi, dev, tr):
    """parallel/ as a world of one over NCCL, then each rank's own work on
    the one card without collectives.

    The main path (counts zeroed before, read after): ``train
    --data-parallel`` through ``cli.main`` on the training corpus (one
    sequence per step, 7-frame 256x256 crops, reference widths, bfloat16;
    K2's launches per step against the count computed here),
    ``render_sharded`` of cornell (K1) and of the blob (K4) at 800x800,
    ``denoise_frame_spatial`` with the shipped denoiser (K2).  Then: the
    data-parallel step bit for bit ``train_step`` on the fixed batch; both
    sharded renders bit for bit ``render``; the per-rank render of 4 tiles
    (K1 at pixel offsets N/4 apart, the blob's BVH kernel per tile),
    concatenated, bit for bit the whole frame; the halo conv (each row
    slice extended by its neighbours' rows, through K2, rows 1..h kept)
    against the whole-frame K2 conv on the 28 activation shapes of the
    800x800 frame in 4 and 5 slices; ``denoise_frame_spatial`` against
    ``apply_frame`` and 2 frames of ``denoise_sequence_spatial`` against
    its frame loop; events and host ms of each entry against its
    single-process one, and the collectives one call runs.
    Returns the path's launches per kernel."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
    from ai_path_tracer_denoiser_tpu_torch.models import (apply_frame, init_hidden, layers,
                                                          load_model, model_options_from_meta)
    from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
    from ai_path_tracer_denoiser_tpu_torch.parallel import (
        denoise_frame_spatial, denoise_sequence_spatial, make_dp_train_step, make_mesh,
        render_sharded, shard_batch)
    from ai_path_tracer_denoiser_tpu_torch.parallel import mesh as par_mesh
    from ai_path_tracer_denoiser_tpu_torch.parallel.mesh import destroy
    from ai_path_tracer_denoiser_tpu_torch.parallel.render_shard import render_tile
    from ai_path_tracer_denoiser_tpu_torch.render import render, render_gbuffer_frame
    from ai_path_tracer_denoiser_tpu_torch.scene import load_scene
    from ai_path_tracer_denoiser_tpu_torch.train import trainer
    t_phase = time.time()

    def counts():
        return {k.name: k.launches for k in kernels}

    def diff(after, before):
        return {n: after[n] - before[n] for n in after if after[n] - before[n]}

    # ---- the main path ----
    dp_dir = os.path.join(tr["train_dir"], "data_parallel")
    shutil.rmtree(dp_dir, ignore_errors=True)
    opts = RenderOptions()
    scenes = {"cornell": load_scene(SCENE, device=dev),
              "blob": load_scene(MESH_SCENES["blob"], device=dev)}
    params, bn, meta = load_model(MODEL, device=dev)
    mopts = model_options_from_meta(meta)
    _, gbuf, _ = render_gbuffer_frame(scenes["cornell"])
    frame = gbuf.permute(1, 2, 0)[None].contiguous()
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.time()
    dp_final = cli.main(["train", "--data-parallel", "--data-dir", tr["data_dir"],
                         "--model-dir", os.path.join(dp_dir, "models"),
                         "--log-dir", os.path.join(dp_dir, "logs"), "--epochs", "1",
                         "--crop-size", str(TRAIN_CROP)])
    torch.cuda.synchronize()
    train_s = time.time() - t0
    entry = {"train --data-parallel": diff(counts(), {k.name: 0 for k in kernels})}
    mesh = make_mesh()                       # the world of one the command started
    sharded = {}
    for name, scene in scenes.items():
        before = counts()
        niter = PAR_ITERS if name == "cornell" else 1
        sharded[name] = render_sharded(scene, opts, niter, mesh)
        torch.cuda.synchronize()
        entry[f"render_sharded {name}"] = diff(counts(), before)
    before = counts()
    y_sp, hidden_sp = denoise_frame_spatial(params, bn, frame, mesh)
    torch.cuda.synchronize()
    entry["denoise_frame_spatial"] = diff(counts(), before)
    path_launches = counts()
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            f"world of one over NCCL: {dist.get_backend()} x {dist.get_world_size()}")
    steps = TRAIN_FRAMES                     # one window per frame, one per step
    k2_per_step = 28 * TRAIN_SEQ + (28 * TRAIN_SEQ - TRAIN_SEQ)
    require(dp_final.step == steps, f"data-parallel steps {dp_final.step}")
    require(entry["train --data-parallel"] == {"conv3x3_act": steps * k2_per_step},
            f"train --data-parallel launches {entry['train --data-parallel']}, expected "
            f"{steps} x {k2_per_step} of K2 alone")
    with open(os.path.join(dp_dir, "logs", "metrics.jsonl")) as f:
        dp_logged = [json.loads(line)["total"] for line in f]
    require(len(dp_logged) == len(range(0, steps, 5)) and all(np.isfinite(dp_logged)),
            f"data-parallel losses {dp_logged}")
    require(os.path.exists(os.path.join(dp_dir, "models", "model_final.npz")),
            "data-parallel final checkpoint")
    require(entry["render_sharded cornell"] == {"render_megakernel": 1}
            and set(entry["render_sharded blob"]) == {"mesh_bvh_v2p", "geom_intersect"}
            and entry["denoise_frame_spatial"] == {"conv3x3_act": 28},
            f"parallel path launches {entry}")
    for need in ("render_megakernel", "conv3x3_act", "mesh_bvh_v2p"):
        require(path_launches[need] > 0, f"{need} launched on the parallel path")

    # ---- the data-parallel step against train_step on the fixed batch ----
    state, topt, mopt = tr["state"], tr["topt"], tr["mopt"]
    dp_step = make_dp_train_step(mesh, topt, mopt)
    xs, ys = shard_batch(tr["fixed_x"], tr["fixed_y"], mesh)
    want, want_m = trainer.train_step(state, tr["fixed_x"], tr["fixed_y"], topt, mopt)
    again, _ = trainer.train_step(state, tr["fixed_x"], tr["fixed_y"], topt, mopt)
    before = counts()
    got, got_m = dp_step(state, xs, ys)
    torch.cuda.synchronize()
    step_launches = diff(counts(), before)

    def same_trees(a, b):
        return all(torch.equal(u, v) for (_, u), (_, v) in zip(sorted_leaves(a), sorted_leaves(b)))

    deterministic = same_trees(want.params, again.params)
    require(step_launches == {"conv3x3_act": k2_per_step}, f"dp step launches {step_launches}")
    require(deterministic and same_trees(got.params, want.params)
            and same_trees(got.bn_state, want.bn_state)
            and all(torch.equal(got_m[k], want_m[k]) for k in want_m)
            and bool(torch.isfinite(got_m["total"])),
            "the data-parallel step of a world of one is train_step bit for bit")

    # ---- the sharded renders against render; the per-rank tiles ----
    render_equal, tiles_equal, tile_launches = {}, {}, {}
    whole = {}
    for name, scene in scenes.items():
        niter = PAR_ITERS if name == "cornell" else 1
        img, gb, st = render(scene, opts, niter)
        whole[name] = st
        simg, sgb, sst = sharded[name]
        render_equal[name] = bool(torch.equal(simg, img) and torch.equal(sgb, gb)
                                  and sst.segments == st.segments)
        before = counts()
        tiles = [render_tile(scene, opts, niter, i, PAR_TILES) for i in range(PAR_TILES)]
        torch.cuda.synchronize()
        tile_launches[name] = diff(counts(), before)
        tiles_equal[name] = bool(torch.equal(torch.cat([t.accum for t in tiles], 1), st.accum)
                                 and torch.equal(torch.cat([t.gbuf for t in tiles], 1), st.gbuf))
        require(bool(torch.isfinite(st.accum).all()) and float(st.accum.sum()) > 0,
                f"{name} render finite and lit")
    require(all(render_equal.values()), f"render_sharded bit for bit render: {render_equal}")
    require(all(tiles_equal.values()), f"{PAR_TILES} tiles bit for bit the frame: {tiles_equal}")
    require(tile_launches["cornell"] == {"render_megakernel": PAR_TILES}
            and set(tile_launches["blob"]) == {"mesh_bvh_v2p", "geom_intersect"},
            f"per-tile launches {tile_launches}")

    # ---- the halo conv against the whole-frame conv, through K2 ----
    gen = torch.Generator(device=dev).manual_seed(5)
    layer_res = [(f"enc{i}", 800 >> (i - 1)) for i in range(1, 6)] + [("bottleneck", 25)] + \
        [(f"dec{i}", 800 >> (i - 1)) for i in range(5, 0, -1)]
    halo = {n: {"layers": 0, "max_abs_err": 0.0, "bitwise": True} for n in PAR_SLICES}
    for block, res in layer_res:
        for conv_name in ("conv1", "conv2", "conv3"):
            if conv_name not in params[block]:
                continue
            w = params[block][conv_name]["w"].to(torch.bfloat16)
            x = torch.randn((1, res, res, w.shape[2]), generator=gen, device=dev).to(torch.bfloat16)
            ref = layers.Conv3x3Function.apply(x, w)
            zero = torch.zeros_like(x[:, :1])
            for n in PAR_SLICES:
                if res % n:
                    continue
                h = res // n
                for i in range(n):
                    lo, hi = i * h, (i + 1) * h
                    ext = torch.cat([x[:, lo - 1:lo] if lo else zero, x[:, lo:hi],
                                     x[:, hi:hi + 1] if hi < res else zero], 1)
                    y = layers.Conv3x3Function.apply(ext, w)[:, 1:h + 1]
                    part = ref[:, lo:hi]
                    halo[n]["max_abs_err"] = max(halo[n]["max_abs_err"],
                                                 float((y - part).abs().max()))
                    halo[n]["bitwise"] &= bool(torch.equal(y, part))
                    require(bool(((y - part).abs() <= 1e-3 + 1e-3 * part.abs()).all()),
                            f"halo conv at {block}.{conv_name}, slice {i} of {n}")
                halo[n]["layers"] += 1
    require(halo[4]["layers"] == 20 and halo[5]["layers"] == 28, f"halo conv layers {halo}")

    # ---- denoise_frame_spatial against apply_frame; the sequence ----
    hid = init_hidden(1, 800, 800, mopts, device=dev)

    def whole_denoise(bf16=False):
        with torch.no_grad():
            return apply_frame(params, bn, frame, hid, bf16=bf16, options=mopts)

    y_ref, hidden_ref, _ = whole_denoise()
    yb_ref = whole_denoise(bf16=True)[0]
    yb_sp, _ = denoise_frame_spatial(params, bn, frame, mesh, bf16=True)
    denoise = {"float32_max_abs_err": float((y_sp - y_ref).abs().max()),
               "float32_bitwise": bool(torch.equal(y_sp, y_ref)),
               "hidden_bitwise": all(torch.equal(hidden_sp[k], hidden_ref[k]) for k in hidden_ref),
               "bf16_rel_l2": float((yb_sp - yb_ref).norm() / yb_ref.norm())}
    require(bool(torch.isfinite(y_sp).all()) and tuple(y_sp.shape) == (1, 800, 800, 3)
            and bool(((y_sp - y_ref).abs() <= 1e-3 + 1e-3 * y_ref.abs()).all()),
            f"denoise_frame_spatial against apply_frame: {denoise}")
    require(denoise["bf16_rel_l2"] < 2e-2, f"bfloat16 denoise_frame_spatial: {denoise}")
    frames = torch.stack([frame, frame.flip(2)])
    seq = denoise_sequence_spatial(params, bn, frames, mesh)
    loop, hd = [], None
    for t in range(2):
        y_t, hd = denoise_frame_spatial(params, bn, frames[t], mesh, hd)
        loop.append(y_t)
    require(torch.equal(seq, torch.stack(loop)) and bool(torch.isfinite(seq).all())
            and not torch.equal(seq[0], seq[1]), "denoise_sequence_spatial is its frame loop")

    # ---- times: each entry against its single-process function, in turns
    # (parallel, single, single, parallel); events ms and the host's ms until
    # the call returned, per call; the collectives one call runs ----
    entries = {
        "dp_step": (lambda: dp_step(state, xs, ys), 2,
                    lambda: trainer.train_step(state, tr["fixed_x"], tr["fixed_y"], topt, mopt)),
        "render_sharded": (lambda: render_sharded(scenes["cornell"], opts, PAR_ITERS, mesh), 10,
                           lambda: render(scenes["cornell"], opts, PAR_ITERS)),
        "denoise_frame_spatial": (lambda: denoise_frame_spatial(params, bn, frame, mesh), 10,
                                  whole_denoise)}

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps, host

    times = {}
    for name, (parallel_fn, reps, single_fn) in entries.items():
        runs = {"events_ms": {"parallel": [], "single": []}, "host_ms": {"parallel": [], "single": []}}
        for side in ("parallel", "single", "single", "parallel"):
            ev, host = timed(parallel_fn if side == "parallel" else single_fn, reps)
            runs["events_ms"][side].append(ev)
            runs["host_ms"][side].append(host)
        calls = []
        with recording(dist, "all_reduce", calls), recording(dist, "all_gather", calls), \
                recording(par_mesh, "_gather_single", calls):
            parallel_fn()
        torch.cuda.synchronize()
        times[name] = {**runs, "calls_per_run": reps, "collectives_per_call": len(calls)}
    destroy()
    emit({"phase": "parallel_path", "card": smi, "world": "1 rank, NCCL",
          "launches": {"path": {n: v for n, v in path_launches.items() if v}, "by_entry": entry,
                       "dp_step_on_fixed_batch": step_launches, "tiles": tile_launches},
          "train": {"steps": steps, "batch_per_rank": 1, "crop": TRAIN_CROP,
                    "sequence": TRAIN_SEQ, "bf16_compute": topt.bf16_compute,
                    "k2_launches_per_step": k2_per_step, "logged_losses": dp_logged,
                    "seconds": train_s},
          "dp_step_bitwise_train_step": True, "train_step_deterministic": deterministic,
          "render_sharded_bitwise_render": render_equal,
          "tiles": {"count": PAR_TILES, "bitwise_whole_frame": tiles_equal,
                    "k1_pixel_offsets": [i * 800 * 800 // PAR_TILES for i in range(PAR_TILES)]},
          "halo_conv": {str(n): v for n, v in halo.items()},
          "denoise": denoise, "sequence_frames": 2, "times": times,
          "phase_seconds": time.time() - t_phase,
          "tolerance": "bit for bit: the dp step (params, BN state, metrics), the sharded "
                       "renders, the tiles, the sequence; halo conv and float32 "
                       "denoise |k-w| <= 1e-3 + 1e-3|w| (bitwise reported); bfloat16 denoise "
                       "rel L2 < 2e-2 (the halo conv rounds to bfloat16, apply_frame keeps "
                       "float32); times: events_ms = CUDA events around calls_per_run calls "
                       "back to back, host_ms = the host clock until the last returned, per "
                       "call, two runs per side in the order parallel, single, single, "
                       "parallel; collectives_per_call = all_reduce, all_gather and "
                       "all-gather-into-tensor calls in one call of the parallel entry"})
    return path_launches


def phase_campaign_path(kernels, smi, dev):
    """The training campaign driver, ``tools/train_pipeline.py``, through its
    ``main`` one stage at a time (counts zeroed before each, read after):
    datagen through K1 (``--render-backend pallas_operand``), train through
    K2 with ``remat_frames`` (batch 4) and the BatchNorm recalibration,
    eval, report; then ``--resume --epochs 3 --stages train`` (one epoch
    more from the 'final' checkpoint), ``tools/export_latest.py`` on the
    checkpoints, eval of that artifact and ``tools/compare_evals.py`` on
    the two eval records.  The artifacts go to a directory under runs/;
    the repository's artifacts/ must be left as it was.  Then: the artifact
    against the checkpoint and a recalibration redone here (bit for bit), a
    remat_frames step against a plain one on one batch of the corpus (bit
    for bit; launches, peak memory and ms in turns), and the card's eval
    window against the CPU's.  Returns the campaign's launches per kernel."""
    import hashlib
    import io
    import shutil

    import numpy as np
    import torch

    from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, TrainOptions
    from ai_path_tracer_denoiser_tpu_torch.data import SequenceDataset, sequence_batches
    from ai_path_tracer_denoiser_tpu_torch.models import load_model, model_options_from_meta
    from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
    from ai_path_tracer_denoiser_tpu_torch.tools import (compare_evals, export_latest,
                                                         train_pipeline)
    from ai_path_tracer_denoiser_tpu_torch.train import (load_checkpoint, recalibrate_bn,
                                                         trainer)
    t_phase = time.time()
    root = os.path.join(OUT_DIR, "campaign")
    shutil.rmtree(root, ignore_errors=True)          # datagen resumes: start empty
    art = os.path.join(root, "artifacts")
    shipped = os.path.join(ROOT, "artifacts")

    def tree_digest(path):
        h = hashlib.sha256()
        for name in sorted(os.listdir(path)):
            with open(os.path.join(path, name), "rb") as f:
                h.update(name.encode() + hashlib.sha256(f.read()).digest())
        return h.hexdigest()

    shipped_before = tree_digest(shipped)
    cut = {k: v for k, (v, _) in CAMPAIGN_CUTS.items()}
    argv = ["--out", root, "--artifacts-dir", art, "--device", dev.type,
            "--res", str(CAMPAIGN_RES), "--batch", str(TRAIN_BATCH), "--crop", str(TRAIN_CROP),
            "--render-backend", "pallas_operand"]
    for flag, value in cut.items():
        argv += [f"--{flag}", str(value)]
    stage_s, launches, total = {}, {}, {}
    os.makedirs(root)
    log = open(os.path.join(root, "stages.log"), "w")    # the stages' progress lines

    def run(name, fn):
        reset_launches(kernels)
        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.redirect_stdout(log):
            fn()
        torch.cuda.synchronize()
        stage_s[name] = time.time() - t0
        launches[name] = nonzero_launches(kernels)
        for k, v in launches[name].items():
            total[k] = total.get(k, 0) + v

    for stage in ("datagen", "train", "eval", "report"):
        run(stage, lambda: train_pipeline.main(argv + ["--stages", stage]))
    first_eval = os.path.join(root, "eval_epochs2.json")
    shutil.copy(os.path.join(root, "eval.json"), first_eval)
    model_dir = os.path.join(root, "models")
    ckpt_e2 = load_checkpoint(os.path.join(model_dir, "model_final.npz"), device=dev)
    run("train --resume --epochs 3",
        lambda: train_pipeline.main(argv + ["--stages", "train", "--resume", "--epochs", "3"]))
    ckpt = load_checkpoint(os.path.join(model_dir, "model_final.npz"), device=dev)
    run("export_latest", lambda: export_latest.main(
        ["--model-dir", model_dir, "--data", os.path.join(root, "data", "train"),
         "--artifacts-dir", art, "--device", dev.type, "--bn-recal", str(cut["bn-recal"]),
         "--batch", str(TRAIN_BATCH), "--crop", str(TRAIN_CROP)]))
    run("eval export_latest", lambda: train_pipeline.main(
        argv + ["--stages", "eval", "--artifact", "denoiser_multiscene_r4.npz"]))
    log.close()
    compared = io.StringIO()
    with contextlib.redirect_stdout(compared):
        compare_evals.main([first_eval, os.path.join(root, "eval.json")])
    shipped_after = tree_digest(shipped)

    # ---- what the stages wrote ----
    n_train = cut["train-scenes"] * cut["frames"] * cut["movs"] * cut["noise-seeds"]
    n_eval = cut["eval-scenes"] * max(14, cut["frames"] // 3)
    want_k1 = n_train * (1 + -(-cut["gt-spp"] // 64)) + n_eval * (1 + -(-cut["gt-spp-eval"] // 64))
    steps_per_epoch = n_train // TRAIN_BATCH
    k2_frame = 28 * TRAIN_SEQ
    k2_step = {"plain": k2_frame + (k2_frame - TRAIN_SEQ),
               "remat": 2 * k2_frame + (k2_frame - TRAIN_SEQ)}   # + the recomputed forward
    k2_recal = cut["bn-recal"] * k2_frame
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        losses = [json.loads(line)["total"] for line in f]
    with open(first_eval) as f:
        eval_e2 = json.load(f)
    with open(os.path.join(root, "eval.json")) as f:
        eval_r4 = json.load(f)
    compare_lines = compared.getvalue().splitlines()

    # the artifact (written by the resumed run): the checkpoint's weights and
    # a recalibration redone here
    dataset = SequenceDataset(os.path.join(root, "data", "train", "input"),
                              os.path.join(root, "data", "train", "gt"),
                              crop=True, crop_size=TRAIN_CROP)
    topt = {r: TrainOptions(batch_size=TRAIN_BATCH, crop_size=TRAIN_CROP, remat_frames=r)
            for r in (False, True)}
    mopt = ModelOptions()
    params, bn, meta = load_model(os.path.join(art, "denoiser_multiscene.npz"), device=dev)
    redone = recalibrate_bn(ckpt, sequence_batches(dataset, batch_size=TRAIN_BATCH,
                                                      seed=10_007),
                            cut["bn-recal"], topt[True], mopt)

    def same(a, b):
        return all(pa == pb and torch.equal(x, y) for (pa, x), (pb, y)
                   in zip(sorted_leaves(a), sorted_leaves(b)))

    artifact_equal = {"params_vs_checkpoint": same(params, ckpt.params),
                      "bn_state_vs_recalibration_redone": same(bn, redone.bn_state)}
    recal_moved = not same(redone.bn_state, ckpt.bn_state)

    # ---- remat_frames against the plain step, one batch of the corpus ----
    x, y = next(iter(sequence_batches(dataset, batch_size=TRAIN_BATCH, seed=0)))
    x = torch.from_numpy(x).to(dev, torch.bfloat16)
    y = torch.from_numpy(y).to(dev, torch.bfloat16)
    step_out, step_launches, peak = {}, {}, {}
    for name, remat in (("plain", False), ("remat", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches(kernels)
        step_out[name] = trainer.train_step(ckpt, x, y, topt[remat], mopt)
        torch.cuda.synchronize()
        step_launches[name] = nonzero_launches(kernels)
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    (sp, mp_), (sr, mr) = step_out["plain"], step_out["remat"]
    remat_equal = {"params": same(sr.params, sp.params), "bn_state": same(sr.bn_state, sp.bn_state),
                   "adam": same(sr.opt_state["mu"], sp.opt_state["mu"])
                   and same(sr.opt_state["nu"], sp.opt_state["nu"]),
                   "metrics": all(torch.equal(mr[k], mp_[k]) for k in mp_)}
    del step_out, sp, sr
    step_ms = {"plain": [], "remat": []}
    for i in range(CAMPAIGN_TIMED_STEPS + 1):
        for name in (("plain", "remat") if i % 2 else ("remat", "plain")):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            trainer.train_step(ckpt, x, y, topt[name == "remat"], mopt)
            b.record()
            b.synchronize()
            step_ms[name].append(a.elapsed_time(b))
    median = {k: statistics.median(v[1:]) for k, v in step_ms.items()}
    del x, y

    # ---- the card's eval window against the CPU's, on the campaign's artifact ----
    ev = SequenceDataset(os.path.join(root, "data", "eval", "input"),
                         os.path.join(root, "data", "eval", "gt"), crop=False)
    xw, _ = ev[0]
    mopt_art = model_options_from_meta(meta)
    card = train_pipeline.eval_window(params, bn, mopt_art, xw, dev)
    cpu_params, cpu_bn, _ = load_model(os.path.join(art, "denoiser_multiscene.npz"),
                                       device="cpu")
    t0 = time.time()
    cpu = train_pipeline.eval_window(cpu_params, cpu_bn, mopt_art, xw, torch.device("cpu"))
    cpu_s = time.time() - t0

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    eval_rel = rel_l2(card, cpu)
    eval_rel_frames = [rel_l2(a, b) for a, b in zip(card, cpu)]

    emit({"phase": "campaign_path", "card": smi,
          "command": "python -m ai_path_tracer_denoiser_tpu_torch.tools.train_pipeline "
                     + " ".join(argv[6:]),
          "cuts": {k: {"here": v, "default": d} for k, (v, d) in CAMPAIGN_CUTS.items()},
          "stage_seconds": stage_s, "launches": launches,
          "expected": {"datagen_k1": want_k1, "steps_per_epoch": steps_per_epoch,
                       "k2_per_step": k2_step, "k2_per_recalibration": k2_recal},
          "steps": {"after_epochs_2": ckpt_e2.step, "after_resume": ckpt.step},
          "logged_losses": losses, "meta": meta,
          "artifact_bit_for_bit": artifact_equal, "recalibration_moved_statistics": recal_moved,
          "eval": {"epochs_2": eval_e2, "export_latest": eval_r4},
          "compare_evals": compare_lines,
          "remat_step": {"bit_for_bit_plain": remat_equal, "launches": step_launches,
                         "peak_memory_gib_above_start": peak, "step_ms": step_ms,
                         "step_ms_median_after_first": median,
                         "remat_over_plain": median["remat"] / median["plain"]},
          "eval_window_card_vs_cpu": {
              "frames": int(xw.shape[0]), "res": list(xw.shape[1:3]), "rel_l2": eval_rel,
              "rel_l2_per_frame": eval_rel_frames, "bar": CAMPAIGN_EVAL_BAR,
              "cpu_seconds": cpu_s},
          "model_card_written": os.path.exists(os.path.join(art, "MODEL_CARD.md")),
          "shipped_artifacts_untouched": shipped_after == shipped_before,
          "phase_seconds": time.time() - t_phase,
          "columns": "stage_seconds: host clock around each main() call, the card drained; "
                     "step_ms: CUDA events around trainer.train_step on one batch of the "
                     "corpus (batch 4, 7 x 256 x 256, bf16), remat and plain in turns, "
                     "median of the 5 after the first; peak memory: "
                     "torch.cuda.max_memory_allocated over one step less the memory held "
                     "before it"})
    require(launches["datagen"] == {"render_megakernel": want_k1},
            f"datagen launches {launches['datagen']}, expected K1 x {want_k1}")
    require(ckpt_e2.step == 2 * steps_per_epoch and ckpt.step == 3 * steps_per_epoch
            and steps_per_epoch >= 2, f"steps {ckpt_e2.step}, {ckpt.step}")
    require(launches["train"] == {"conv3x3_act": 2 * steps_per_epoch * k2_step["remat"]
                                  + k2_recal}, f"train launches {launches['train']}")
    require(launches["train --resume --epochs 3"]
            == {"conv3x3_act": steps_per_epoch * k2_step["remat"] + k2_recal},
            f"resumed train launches {launches['train --resume --epochs 3']}")
    require(launches["export_latest"] == {"conv3x3_act": k2_recal},
            f"export_latest launches {launches['export_latest']}")
    require(launches["eval"] == {"conv3x3_act": k2_frame} == launches["eval export_latest"],
            f"eval launches {launches['eval']}, {launches['eval export_latest']}")
    require(not launches["report"], f"report launches {launches['report']}")
    # fit logs every 5th step of an epoch, 3 epochs in all
    require(len(losses) == 3 * -(-steps_per_epoch // 5) and all(np.isfinite(losses)),
            f"logged losses {losses}")
    require(meta["epochs"] == 3 and meta["bn_recalibrated_batches"] == cut["bn-recal"]
            and tuple(meta["widths"]) == mopt.widths, f"artifact meta {meta}")
    require(all(artifact_equal.values()) and recal_moved,
            f"the artifact against the checkpoint and the recalibration: {artifact_equal}")
    require(all(np.isfinite(v) for rec in (*eval_e2.values(), *eval_r4.values())
                for v in rec.values()) and len(eval_e2) == len(eval_r4) == 1,
            "finite eval records")
    require(os.path.exists(os.path.join(art, "MODEL_CARD.md")), "MODEL_CARD.md written")
    require(compare_lines[-1].startswith("B beats A on ") and len(compare_lines) == 4,
            f"compare_evals: {compare_lines}")
    require(all(remat_equal.values()), f"remat step vs plain step: {remat_equal}")
    require(step_launches == {n: {"conv3x3_act": k2_step[n]} for n in k2_step},
            f"step launches {step_launches}")
    require(eval_rel <= CAMPAIGN_EVAL_BAR and np.isfinite(card).all(),
            f"eval window card vs CPU {eval_rel} > {CAMPAIGN_EVAL_BAR}")
    require(shipped_after == shipped_before, "the smoke run changed the repository's artifacts/")
    return total


# The sphere-before-a-wall scene of the JAX package's edge-gradient tests
# (tests/test_edge_grad.py), with the cube and mesh variants: radiances
# there are deterministic (a black object before an emissive wall)
EDGE_SCENE = """MATERIAL 0
RGB         1 1 1
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   2

MATERIAL 1
RGB         0 0 0
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

CAMERA
RES         {res} {res}
FOVY        45
ITERATIONS  8
DEPTH       3
FILE        edge_test
EYE         0 0 6
LOOKAT      0 0 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       0 0 -6
ROTAT       0 0 0
SCALE       60 60 0.2

{object}
"""
EDGE_OBJECTS = {
    "sphere": "OBJECT 1\nsphere\nmaterial 1\nTRANS       1.2 0.4 0\nROTAT       0 0 0\n"
              "SCALE       2 2 2\n",
    "box": "OBJECT 1\ncube\nmaterial 1\nTRANS       1.2 0.4 0\nROTAT       20 35 10\n"
           "SCALE       1.6 1.2 1.4\n",
    "mesh": "MESH 0\nPATH        assets/icosahedron.obj\nmaterial 1\nTRANS       1.2 0.4 0\n"
            "ROTAT       15 30 0\nSCALE       1.8 1.8 1.8\n"}
ICO_SCENE = os.path.join(ROOT, "scenes", "cornell_mesh_icosahedron.txt")
EDGE_SPHERE, EDGE_LIGHT = 6, 0  # cornell_box.txt: the sphere; the ceiling light (a cube)


def phase_edge_grad_path(kernels, smi, dev):
    """The edge-sampled geometry gradients (render/edge_grad.py) at the JAX
    defaults (n_edge 512, spp 128) on cornell_box.txt at 800x800, depth 8,
    and on cornell_mesh_icosahedron.txt: no kernel launches but K10's, finite (3,)
    results on the card, each call three times (median and spread, and
    the host's garbage-collection pauses within each run); one
    profiled sphere gradient (its kernel launches and the card's busy
    time); the interior terms' time and peak memory with the allocator's
    state around them, before and after emptying its cache; a full-width
    backward that is not zero (the edge box scene at 800x800 shaded by
    |normal|) held to the CPU port; the blob's boundary term alone; the
    shoelace area oracle; the batched ``mean_radiance`` against its loop
    bit for bit; the card against the CPU port on the 64x64 edge scenes."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
    from ai_path_tracer_denoiser_tpu_torch.render import edge_grad as eg
    from ai_path_tracer_denoiser_tpu_torch.scene import load_scene, parse_scene_text
    t_phase = time.time()
    reps = 3
    reserved_at_start = torch.cuda.memory_reserved() / 2 ** 30
    opts = RenderOptions()
    normal_view = RenderOptions(mesh_normal_view=True)
    cornell = load_scene(SCENE, device=dev)
    ico = load_scene(ICO_SCENE, device=dev)
    blob = load_scene(MESH_SCENES["blob"], device=dev)
    box = {where: parse_scene_text(EDGE_SCENE.format(res=800, object=EDGE_OBJECTS["box"]),
                                   base_dir=ROOT, device=where) for where in (dev, "cpu")}

    def events_ms(fn):
        """(result, ms) of one call between two CUDA events."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def spread(times):
        return {"median": float(np.median(times)), "min": min(times), "max": max(times),
                "each": times}

    # the host's garbage collector: its pauses during each timed call
    gc_ms, gc_start = [0.0], [0.0]

    def gc_clock(stage, info):
        if stage == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_start[0]) * 1e3

    def timed_run(fn):
        """(result, ms, ms of garbage collection within it)."""
        before = gc_ms[0]
        out, t = events_ms(fn)
        return out, t, gc_ms[0] - before

    def box_interior(sc):
        """The interior term of the edge box's rotation, shaded by |normal|:
        the radiance depends on the rotation, so autograd goes back."""
        return eg._interior_gradient(sc, normal_view, lambda d: dataclasses.replace(
            sc, geoms=eg.retrs_geom(sc.geoms, 1, d, torch.zeros(3, device=sc.device))))

    calls = {
        "translation_sphere": lambda: eg.translation_gradient(cornell, opts, EDGE_SPHERE),
        "translation_sphere_boundary": lambda: eg.translation_gradient(
            cornell, opts, EDGE_SPHERE, include_interior=False),
        "rotation_light": lambda: eg.rotation_gradient(cornell, opts, EDGE_LIGHT),
        "scale_light": lambda: eg.scale_gradient(cornell, opts, EDGE_LIGHT),
        "camera": lambda: eg.camera_translation_gradient(cornell, opts),
        "mesh_icosahedron": lambda: eg.mesh_translation_gradient(ico, opts),
        "mesh_blob_boundary": lambda: eg.mesh_translation_gradient(
            blob, opts, include_interior=False),
        "rotation_edge_box_normal_view": lambda: eg.rotation_gradient(box[dev], normal_view, 1),
    }
    # the 64x64 edge scenes, on the card and on the CPU
    small = {(k, where): parse_scene_text(EDGE_SCENE.format(res=64, object=t), base_dir=ROOT,
                                          device=where)
             for k, t in EDGE_OBJECTS.items() for where in (dev, "cpu")}
    aa_off = RenderOptions(antialias=False)
    grads, ms = {}, {}
    reset_launches(kernels)
    # a small call first pays the libraries' set-up (the solver's, autograd's)
    _, setup_ms = events_ms(lambda: eg.translation_gradient(small["sphere", dev], aa_off, 1,
                                                            n_edge=128, spp=2))
    gc.callbacks.append(gc_clock)
    for name, fn in calls.items():
        runs = [timed_run(fn) for _ in range(reps)]
        grads[name] = [g for g, _, _ in runs]
        ms[name] = {**spread([t for _, t, _ in runs]), "gc_ms": [c for _, _, c in runs]}
    launches = nonzero_launches(kernels)
    # the interior terms alone: time, peak memory, and the caching
    # allocator's reserve and retries around each run; a second pass after
    # emptying the allocator's cache.  With the default shading the
    # radiance does not depend on a geom's move (a product of albedos and
    # an emittance): autograd records the forward and has nothing to go
    # back through.  The edge box shaded by |normal| goes back.
    interior = {
        "translation_sphere": lambda: eg._interior_gradient(
            cornell, opts, lambda d: dataclasses.replace(
                cornell, geoms=eg.translate_geom(cornell.geoms, EDGE_SPHERE, d))),
        "mesh_icosahedron": lambda: eg._interior_gradient(
            ico, opts, lambda d: dataclasses.replace(ico, mesh=eg.translate_mesh(ico.mesh, d))),
        "rotation_edge_box_normal_view": lambda: box_interior(box[dev])}
    interior_runs = {}
    reset_launches(kernels)
    for cache in ("as_left", "emptied"):
        if cache == "emptied":
            torch.cuda.empty_cache()
        for name, fn in interior.items():
            rows = []
            for _ in range(reps):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                before = torch.cuda.memory_stats()
                torch.cuda.reset_peak_memory_stats()
                g, t, collect = timed_run(fn)
                after = torch.cuda.memory_stats()
                rows.append({
                    "ms": t, "gc_ms": collect,
                    "peak_gib_above_start": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                    "reserved_gib_before": before.get("reserved_bytes.all.current", 0) / 2 ** 30,
                    "reserved_gib_after": after.get("reserved_bytes.all.current", 0) / 2 ** 30,
                    "device_mallocs": after.get("num_device_alloc", 0)
                    - before.get("num_device_alloc", 0),
                    "alloc_retries": after.get("num_alloc_retries", 0)
                    - before.get("num_alloc_retries", 0),
                    "gradient": g.tolist()})
            interior_runs[f"{name}:{cache}"] = {
                "ms": spread([r["ms"] for r in rows]), "runs": rows}
    gc.callbacks.remove(gc_clock)
    for k, v in nonzero_launches(kernels).items():
        launches[k] = launches.get(k, 0) + v
    # radiance estimates under no_grad, and queries whose rays and geoms carry
    # no gradient, take K10 (ops/intersect.py:geoms_route); nothing else launches
    require(set(launches) <= {"geom_intersect"}, f"edge gradients launched kernels: {launches}")
    for name, gs in grads.items():
        for g in gs:
            require(isinstance(g, torch.Tensor) and g.shape == (3,) and g.device.type == "cuda"
                    and bool(torch.isfinite(g).all()), f"{name}: {g}")
    # the full-width backward, held to the CPU port: finite, not zero
    box_card = torch.tensor(interior_runs["rotation_edge_box_normal_view:as_left"]
                            ["runs"][0]["gradient"])
    box_cpu = box_interior(box["cpu"])
    box_rel = float(((box_card - box_cpu).abs() / box_cpu.abs().clamp_min(1e-6)).max())
    box_ok = (bool(torch.isfinite(box_card).all()) and float(box_cpu.abs().min()) > 1e-6
              and float(box_card.abs().min()) > 1e-6 and box_rel <= 1e-3)

    # one sphere gradient under the profiler: its kernel launches and the
    # card's busy time (the sum of kernel times; the profiler slows the host)
    profiled = {}
    try:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eg.translation_gradient(cornell, opts, EDGE_SPHERE)
            torch.cuda.synchronize()
        avg = prof.key_averages()
        busy = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                   for e in avg) / 1e3
        n_launch = sum(e.count for e in avg if "LaunchKernel" in e.key)
        median = ms["translation_sphere"]["median"]
        profiled = {"kernel_launches": n_launch, "device_busy_ms": busy,
                    "unprofiled_median_ms": median,
                    "device_idle_share": (max(0.0, 1.0 - busy / median) if busy > 0 else None),
                    "ms_per_launch": median / n_launch if n_launch else None}
    except Exception as exc:  # a diagnostic: the phase's checks do not rest on it
        profiled = {"error": repr(exc)}

    # mean_radiance: the batch against the loop, 512 rays x 32 iterations
    uv = torch.from_numpy(np.random.default_rng(0).uniform(0, 800, (512, 2))
                          .astype(np.float32)).to(dev)
    o, d = eg.rays_through_pixels(cornell.camera, uv)
    mean_ms = {"batched": [], "loop": []}
    mean_equal = True
    for _ in range(reps):
        batch, t_b = events_ms(lambda: eg.mean_radiance(cornell, opts, o, d, 32))
        loop, t_l = events_ms(lambda: eg.mean_radiance_loop(cornell, opts, o, d, 32))
        mean_ms["batched"].append(t_b)
        mean_ms["loop"].append(t_l)
        mean_equal = mean_equal and all(torch.equal(a, b) for a, b in zip(batch, loop))

    # the shoelace area oracle (JAX tests/test_edge_grad.py:150), 128x128
    edge = parse_scene_text(EDGE_SCENE.format(res=128, object=EDGE_OBJECTS["sphere"]),
                            base_dir=ROOT, device=dev)
    g_edge = eg.translation_gradient(edge, RenderOptions(antialias=False), 1,
                                     n_edge=512, spp=2).cpu().numpy()
    phis = torch.linspace(0, 2 * np.pi, 8193)[:-1].to(dev)

    def area(delta):
        c = edge.geoms.translation[1] + torch.tensor(delta, device=dev)
        uv_ = eg.project_to_pixels(eg.silhouette_points_sphere(
            c, 1.0, edge.camera.position.to(dev), phis), edge.camera)
        uv_ = uv_.double().cpu().numpy()
        x0, y0 = uv_[:, 0], uv_[:, 1]
        return abs(np.sum(x0 * np.roll(y0, -1) - np.roll(x0, -1) * y0)) / 2.0

    oracle = []
    for axis in range(3):
        step = [0.0, 0.0, 0.0]
        step[axis] = 2e-3
        oracle.append(-2.0 * (area(step) - area([-s for s in step])) / 4e-3 / 128 ** 2)
    oracle_ok = bool(np.allclose(g_edge, oracle, rtol=0.04, atol=2e-6))

    # the card against the CPU port on the 64x64 edge scenes
    small_calls = {
        "translation_sphere": ("sphere", lambda s: eg.translation_gradient(
            s, aa_off, 1, n_edge=128, spp=2)),
        "translation_box": ("box", lambda s: eg.translation_gradient(
            s, aa_off, 1, n_edge=128, spp=2)),
        "rotation_box": ("box", lambda s: eg.rotation_gradient(s, aa_off, 1, n_edge=128, spp=2)),
        "scale_sphere": ("sphere", lambda s: eg.scale_gradient(s, aa_off, 1, n_edge=128, spp=2)),
        "camera_box": ("box", lambda s: eg.camera_translation_gradient(
            s, aa_off, n_edge=128, spp=2)),
        "mesh": ("mesh", lambda s: eg.mesh_translation_gradient(
            s, aa_off, samples_per_edge=8, spp=2))}
    card_vs_cpu = {}
    for name, (kind, fn) in small_calls.items():
        a, b = fn(small[kind, dev]).cpu().numpy(), fn(small[kind, "cpu"]).numpy()
        card_vs_cpu[name] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))
    emit({"phase": "edge_grad_path", "card": smi, "res": [800, 800], "depth": 8,
          "n_edge": 512, "spp": 128, "launches": launches,
          "gradients": {k: v[0].tolist() for k, v in grads.items()},
          "ms_per_call": ms, "setup_call_ms": setup_ms,
          "interior": interior_runs,
          "reserved_gib": {"phase_start": reserved_at_start,
                           "phase_end": torch.cuda.memory_reserved() / 2 ** 30},
          "profiled_translation_sphere": profiled,
          "full_width_backward_edge_box_800": {"card": box_card.tolist(),
                                               "cpu": box_cpu.tolist(), "max_rel": box_rel},
          "mean_radiance_512x32": {"batched_ms": spread(mean_ms["batched"]),
                                   "loop_ms": spread(mean_ms["loop"]),
                                   "bitwise_equal": mean_equal},
          "area_oracle": {"estimator": g_edge.tolist(), "oracle": oracle, "ok": oracle_ok},
          "card_vs_cpu_max_rel": card_vs_cpu,
          "phase_seconds": time.time() - t_phase,
          "tolerance": "launches: none during the full-width calls; oracle: rtol 0.04, "
                       "atol 2e-6 (the JAX test's bar); batched mean_radiance equal to the "
                       "loop bit for bit; card vs CPU: |a - b| / max(|b|, 1e-6) <= 1e-3 per "
                       "component on the 64x64 edge scenes and on the 800x800 edge box's "
                       "interior term, which must exceed 1e-6 per component",
          "timing": "CUDA events around one call with nothing else queued, each call "
                    f"{reps} times in a row, after a 64x64 translation_gradient "
                    "(setup_call_ms: the libraries' set-up); gc_ms: the host's "
                    "garbage-collection pauses inside each run (gc.callbacks)"})
    require(mean_equal, "batched mean_radiance differs from the loop")
    require(oracle_ok, f"area oracle: estimator {g_edge.tolist()} vs {oracle}")
    require(all(v <= 1e-3 for v in card_vs_cpu.values()), f"card vs CPU {card_vs_cpu}")
    require(box_ok, f"800x800 edge box interior term: card {box_card.tolist()}, "
                    f"CPU {box_cpu.tolist()}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import dataclasses
    import shutil

    import numpy as np
    import torch.nn.functional as F

    from ai_path_tracer_denoiser_tpu_torch.app import cli
    from ai_path_tracer_denoiser_tpu_torch.config import (ModelOptions, RenderOptions,
                                                          TrainOptions)
    from ai_path_tracer_denoiser_tpu_torch.data import SequenceDataset
    from ai_path_tracer_denoiser_tpu_torch.models import (
        conv_kernel, layers, load_model, model_options_from_meta, prepare_inference)
    from ai_path_tracer_denoiser_tpu_torch.models.export import sorted_leaves
    from ai_path_tracer_denoiser_tpu_torch.train import (device_data, init_train_state,
                                                         load_checkpoint, trainer)
    from ai_path_tracer_denoiser_tpu_torch.render import (
        assemble_gbuffer, cuda_backend, init_render_state, mesh_binned,
        mesh_kernel, mesh_kernel_v2p, mesh_kernel_v3, render, render_gbuffer_frame)
    from ai_path_tracer_denoiser_tpu_torch.scene import (
        derive_camera, load_scene, orbit_camera, orbit_params_from_camera)
    from ai_path_tracer_denoiser_tpu_torch.ops import bvh as mesh_bvh
    from ai_path_tracer_denoiser_tpu_torch.ops import intersect as tintersect
    from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
    from ai_path_tracer_denoiser_tpu_torch.tools import k1_sweep, k4_sweep, mm_feasibility
    from ai_path_tracer_denoiser_tpu_torch.utils.cuda_build import build_all
    from ai_path_tracer_denoiser_tpu_torch.utils.imageio import read_png, save_png_scaled

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "kind": kind, "count": count, "card": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build all eleven kernels (one nvcc per source, in parallel) ----
    kernels = (cuda_backend.KERNEL, conv_kernel.KERNEL, conv_kernel.ROWS_KERNEL,
               mesh_kernel_v2p.KERNEL, mesh_binned.PHASE1_KERNEL,
               mesh_binned.PAIR_KERNEL, mesh_kernel.KERNEL, mesh_kernel_v3.KERNEL,
               mm_feasibility.VPU_KERNEL, mm_feasibility.MMA_KERNEL, tintersect.GEOM_KERNEL)
    require(len(kernels) == 11, "eleven kernels")
    # K4 at the witness thresholds (phase 10e) and K1's one-pixel-per-thread
    # witness (phase 3), not counted among the eleven
    k4_witnesses = {k: mesh_kernel_v2p.kernel_build(k, f"mesh_bvh_v2p_kthr{k}")
                    for k in K4_WITNESSES}
    t0 = time.time()
    build_all(kernels + tuple(k4_witnesses.values()) + (cuda_backend.WITNESS,))
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln or "spill" in ln]
             for k in kernels + (cuda_backend.WITNESS,)}
    emit({"phase": "build", "seconds": round(time.time() - t0, 2), "ptxas": ptxas})

    # ---- 3. render megakernel vs its plain version (256x256, depth 8) ----
    base = load_scene(SCENE, device=dev)
    c = base.camera
    small = dataclasses.replace(base, camera=derive_camera(
        (256, 256), float(c.fov[1]), c.position.numpy(), c.look_at.numpy(),
        c.up.numpy()))
    opts = RenderOptions()
    k1_err = 0.0
    for niter in (1, 4):
        plain = cuda_backend.render_cuda_plain(small, opts, niter,
                                               init_render_state(small, opts))
        kern = cuda_backend.render_cuda(small, opts, niter)
        gp = assemble_gbuffer(plain, (256, 256), opts).cpu().numpy()
        gk = assemble_gbuffer(kern, (256, 256), opts).cpu().numpy()
        require(np.isfinite(gk).all(), "megakernel output finite")
        close = np.isclose(gk[3:], gp[3:], rtol=1e-5, atol=1e-5).all(axis=0)
        hit_same = ((gk[6] > 0) == (gp[6] > 0)).mean()
        rel = abs(gk[:3].mean() - gp[:3].mean()) / gp[:3].mean()
        mse = float(((gk[:3] - gp[:3]) ** 2).mean())
        psnr = 10 * np.log10(max(gp[:3].max(), 1.0) ** 2 / max(mse, 1e-30))
        k1_err = max(k1_err, float(np.abs(gk - gp).max()))
        emit({"phase": "render_check", "res": 256, "depth": 8, "iterations": niter,
              "gbuffer_close_frac": float(close.mean()),
              "gbuffer_exact_frac": float((gk[3:] == gp[3:]).all(axis=0).mean()),
              "hit_mask_same_frac": float(hit_same), "rgb_mean_rel": float(rel),
              "rgb_psnr_db": float(psnr), "rgb_exact_frac": float((gk[:3] == gp[:3]).mean()),
              "max_abs_err": float(np.abs(gk - gp).max()),
              "tolerance": "G-buffer isclose(rtol 1e-5, atol 1e-5) on >= 99.9% "
                           "of pixels, hit masks equal on >= 99.9%, RGB mean "
                           "rel < 1e-3 and PSNR >= 40 dB"})
        require(close.mean() >= 0.999, "megakernel G-buffer vs plain")
        require(hit_same >= 0.999, "megakernel hit mask vs plain")
        require(rel < 1e-3 and psnr >= 40.0, "megakernel radiance vs plain")
    # K1 against its one-pixel-per-thread witness (the first version's
    # schedule and arithmetic), bit for bit: the main path's frame, several
    # iterations, the small mesh with its AABB gate on and off, a tile of a
    # length no multiple of 32 at a pixel offset, the datagen launch
    mesh_small = load_scene(os.path.join(ROOT, "scenes", "cornell_mesh_icosahedron.txt"),
                            device=dev)
    mc = mesh_small.camera
    mesh_small = dataclasses.replace(mesh_small, camera=derive_camera(
        (256, 256), float(mc.fov[1]), mc.position.numpy(), mc.look_at.numpy(),
        mc.up.numpy()))
    frame_scene = k1_sweep.shape_scene("cornell_800_niter1", dev)[0]
    datagen_scene, datagen_niter = k1_sweep.shape_scene("cornell_512_niter64", dev)
    full = init_render_state(frame_scene, opts)
    tile_state = dataclasses.replace(full, accum=full.accum[:, :100001].contiguous() + 0.5,
                                     gbuf=full.gbuf[:, :100001].contiguous(), iteration=1,
                                     rng_offset=7919)
    witness_cases = [
        ("cornell 800x800, 1 iteration", frame_scene, opts, 1, None, 0),
        ("cornell 256x256, 4 iterations", small, opts, 4, None, 0),
        ("icosahedron 256x256, culling on", mesh_small, opts, 2, None, 0),
        ("icosahedron 256x256, culling off", mesh_small,
         dataclasses.replace(opts, ray_culling=False), 2, None, 0),
        ("cornell 800x800, tile of 100,001 at 123,457, iteration 2", frame_scene, opts, 1,
         tile_state, 123457),
        ("cornell 512x512, 64 iterations", datagen_scene, opts, datagen_niter, None, 0)]
    for label, sc_, op_, niter, st_, off in witness_cases:
        got = cuda_backend.render_cuda(sc_, op_, niter, st_, off)
        want = cuda_backend.render_cuda(sc_, op_, niter, st_, off, kernel=cuda_backend.WITNESS)
        require(torch.equal(got.accum, want.accum) and torch.equal(got.gbuf, want.gbuf),
                f"K1 equals its witness bit for bit: {label}")
        require(bool(torch.isfinite(got.accum).all()) and float(got.accum.sum()) > 0,
                f"K1 output finite and lit: {label}")
    emit({"phase": "render_witness_check", "cases": [c[0] for c in witness_cases],
          "witness_launches": cuda_backend.WITNESS.launches,
          "check": "accum and G-buffer torch.equal to the -DK1_ONE_PIXEL_PER_THREAD build "
                   "(one pixel per thread, nested loops, every geom's world normal, min/max "
                   "by compare and select)"})
    del full, tile_state

    # ---- 4. conv kernel vs its plain version at the frame's 28 shapes ----
    params, bn_state, meta = load_model(MODEL, device=dev)
    mopts = model_options_from_meta(meta)
    folded = prepare_inference(params, bn_state, mopts)
    w0, h0 = base.camera.resolution
    shapes = []                                   # (layer, H, conv, affine)
    res = h0
    for i in range(1, 6):
        p = folded[f"enc{i}"]
        shapes += [(f"enc{i}.conv1", res, p["conv1"], None),
                   (f"enc{i}.conv2", res, p["conv2"], p["affine2"]),
                   (f"enc{i}.conv3", res, p["conv3"], None)]
        res //= 2
    p = folded["bottleneck"]
    shapes += [(f"bottleneck.conv{j}", res, p[f"conv{j}"], None) for j in (1, 2, 3)]
    for i in range(5, 0, -1):
        res *= 2
        p = folded[f"dec{i}"]
        shapes += [(f"dec{i}.conv1", res, p["conv1"], None),
                   (f"dec{i}.conv2", res, p["conv2"], None)]
    require(len(shapes) == 28, "28 convs per frame")
    gen = torch.Generator(device=dev).manual_seed(0)

    def within(got, want, f32):
        """(ok, max abs err) at the stated tolerance of the output type."""
        got, want = got.float(), want.float()
        err = (got - want).abs()
        tol = 1e-3 + 1e-3 * want.abs() if f32 else 1e-2 + 1.6e-2 * want.abs()
        return bool((err <= tol).all()) and bool(torch.isfinite(got).all()), float(err.detach().max())

    conv_rows = []
    errs = {"k2_bf16": 0.0, "k2_bf16_f32out": 0.0, "k2_f32in": 0.0, "k2_batched": 0.0,
            "k3_bf16": 0.0, "k3_f32in": 0.0, "k3_vs_k2_plain_bf16": 0.0}
    for name, r, conv, aff in shapes:
        cin, co = conv["w"].shape[2], conv["w"].shape[3]
        wd = r * w0 // h0
        x32 = torch.randn((r, wd, cin), generator=gen, device=dev)
        x = x32.to(torch.bfloat16)
        w, b = conv["w"], conv["b"]
        checks = {
            # the tile kernel: bfloat16 in and out, float32 out, float32 in, a batch of 2
            "k2_bf16": (conv_kernel.conv3x3_act_chw(x, w, b, 0.1, aff),
                        conv_kernel.conv3x3_act_plain(x, w, b, 0.1, aff), False),
            "k2_bf16_f32out": (conv_kernel.conv3x3_act_chw(x, w, b, 0.1, aff, "float32"),
                               conv_kernel.conv3x3_act_plain(x, w, b, 0.1, aff, "float32"),
                               True),
            "k2_f32in": (conv_kernel.conv3x3_act_chw(x32, w, b, 0.1, aff),
                         conv_kernel.conv3x3_act_plain(x32, w.float(), b, 0.1, aff), True),
            # the row-band kernel against its own plain version, and the tile kernel's
            "k3_bf16": (conv_kernel.conv3x3_act(x, w, b, 0.1, aff),
                        conv_kernel.conv3x3_act_rows_plain(x, w, b, 0.1, aff), False),
            "k3_f32in": (conv_kernel.conv3x3_act(x32, w, b, 0.1, aff),
                         conv_kernel.conv3x3_act_rows_plain(x32, w.float(), b, 0.1, aff), True),
        }
        checks["k3_vs_k2_plain_bf16"] = (checks["k3_bf16"][0], checks["k2_bf16"][1], False)
        xb = torch.stack([x, x.flip(0)])
        checks["k2_batched"] = (conv_kernel.conv3x3_act_chw(xb, w, b, 0.1, aff),
                                conv_kernel.conv3x3_act_plain(xb, w, b, 0.1, aff), False)
        for key, (got, want, f32) in checks.items():
            ok, err = within(got, want, f32)
            errs[key] = max(errs[key], err)
            require(got.shape == want.shape and got.dtype == want.dtype and ok,
                    f"conv check {key} at {name}: max abs err {err}")
        conv_rows.append({"layer": name, "shape": [r, wd, cin, co],
                          "affine": aff is not None, "x": x, "conv": conv, "aff": aff})
    # both conv kernels at shapes the frame's forward convs never reach (the
    # tile kernel in bfloat16 and float32 out, the row-band kernel in
    # bfloat16): Co = 202 (the input gradient of enc5.conv2 and
    # bottleneck.conv2), Co = Cin = 3, widths that are no multiple of the
    # pixel tile or the 64-pixel segment, a batch of 4
    stress = [("enc5.conv2 dgrad", 0, 50, 50, 101, 202),
              ("bottleneck.conv2 dgrad", 0, 25, 25, 101, 202),
              ("3 -> 3", 0, 64, 64, 3, 3), ("ragged 37x53", 0, 37, 53, 43, 57),
              ("ragged 800x64", 0, 800, 64, 64, 3), ("batch of 4", 4, 100, 100, 57, 76),
              ("batch of 4, dgrad", 4, 25, 25, 101, 202)]
    errs.update({"k2_stress_bf16": 0.0, "k2_stress_f32out": 0.0, "k3_stress_bf16": 0.0})
    for name, n_img, r, wd, cin, co in stress:
        x = torch.randn(((n_img,) if n_img else ()) + (r, wd, cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = (torch.randn((3, 3, cin, co), generator=gen, device=dev)
             * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
        b = torch.randn(co, generator=gen, device=dev) * 0.1
        aff = {"s": torch.rand(co, generator=gen, device=dev) + 0.5,
               "t": torch.randn(co, generator=gen, device=dev) * 0.1}
        for key, od in (("k2_stress_bf16", None), ("k2_stress_f32out", "float32")):
            got = conv_kernel.conv3x3_act_chw(x, w, b, 0.1, aff, od)
            want = conv_kernel.conv3x3_act_plain(x, w, b, 0.1, aff, od)
            ok, err = within(got, want, od is not None)
            errs[key] = max(errs[key], err)
            require(got.shape == want.shape and got.dtype == want.dtype and ok,
                    f"conv check {key} at {name}: max abs err {err}")
        got = conv_kernel.conv3x3_act(x, w, b, 0.1, aff)
        want = conv_kernel.conv3x3_act_rows_plain(x, w, b, 0.1, aff)
        ok, err = within(got, want, False)
        errs["k3_stress_bf16"] = max(errs["k3_stress_bf16"], err)
        require(got.shape == want.shape and got.dtype == want.dtype and ok,
                f"conv check k3_stress_bf16 at {name}: max abs err {err}")
        # the card's weight packing (a fresh tensor misses the cache) against
        # the plain packing, element for element, at both kernels' widths
        for n_cols in (conv_kernel.conv_plan(max(n_img, 1), r, wd, co).n_cols,
                       conv_kernel.rows_plan(max(n_img, 1), r, wd, cin, co).n_cols):
            require(torch.equal(conv_kernel._packed_weights(w.clone(), torch.bfloat16, dev,
                                                            n_cols),
                                conv_kernel.pack_weights_sm90(w, n_cols)),
                    f"weight packing on the card differs from pack_weights_sm90 at {name}")
    # the row-band kernel on a zero-bordered input: enc1.conv2 (64 -> 32,
    # affine; Cin a multiple of 8) and enc2.conv2 (86 -> 43, odd Cin)
    errs["k3_pre_padded"] = 0.0
    for i in (1, 4):
        name, r, conv, aff = shapes[i]
        x = conv_rows[i]["x"]
        got = conv_kernel.conv3x3_act(conv_kernel.conv_input_pad(x).contiguous(), conv["w"],
                                      conv["b"], 0.1, aff, pre_padded=True, width=x.shape[1])
        ok, err = within(
            got, conv_kernel.conv3x3_act_rows_plain(x, conv["w"], conv["b"], 0.1, aff), False)
        errs["k3_pre_padded"] = max(errs["k3_pre_padded"], err)
        require(ok, f"row-band kernel on a pre-padded input at {name}")
    torch.cuda.synchronize()
    k2_err, k3_err = errs["k2_bf16"], errs["k3_bf16"]
    emit({"phase": "conv_check", "shapes": len(shapes), "max_abs_err": errs,
          "checks": "tile kernel (K2): bf16 in/out, bf16 in f32 out, f32 in/out, batch "
                    "of 2 at the 28 frame shapes; bf16 in, bf16 and f32 out at "
                    f"{[st[0] for st in stress]}, and the weight packing on the card bit for "
                    "bit against pack_weights_sm90 there at both kernels' widths; row-band "
                    "kernel (K3): bf16, f32 in/out at the 28 frame shapes, each against its own "
                    "plain version, K3 also against K2's plain version, bf16 at the same "
                    "stress shapes, and on a pre-padded input (enc1.conv2, enc2.conv2)",
          "tolerance": "bf16 out |k-p| <= 1e-2 + 1.6e-2|p| (one bf16 rounding "
                       "step); f32 out |k-p| <= 1e-3 + 1e-3|p| (summation order)"})

    # ---- 5. the main path: interactive 800x800, depth 8, shipped model ----
    for k in kernels:
        k.launches = 0
    frames_dir = os.path.join(OUT_DIR, "frames")
    records = cli.main(["interactive", SCENE, "--frames", str(FRAMES),
                        "--model", MODEL, "--out-dir", frames_dir])
    launches = {k.name: k.launches for k in kernels}
    require(launches["render_megakernel"] == FRAMES, f"K1 launches {launches}")
    require(launches["conv3x3_act"] == 28 * FRAMES, f"K2 launches {launches}")
    require(sum(launches.values()) == 29 * FRAMES,
            f"launches of kernels off the main path {launches}")
    for rec in records:
        require(rec["finite"], f"frame {rec['frame']} finite")
        img = read_png(rec["path"])
        require(img.shape == (h0, w0, 3) and img.std() > 0, "frame PNG decodes")
    steady = records[1:]
    emit({"phase": "main_path", "scene": "cornell_box", "res": [w0, h0],
          "depth": base.trace_depth, "frames": FRAMES, "launches": launches,
          "card": smi,
          "per_frame_ms": [{k: round(v, 3) for k, v in rec.items()
                            if k.endswith("_ms")} for rec in records],
          "median_after_warmup_ms": {
              k: statistics.median(r[k] for r in steady)
              for k in ("render_ms", "denoise_ms", "total_ms")}})

    # ---- 6. timing at the main path's shapes ----
    phi, theta, zoom = orbit_params_from_camera(base.camera)
    frame0 = dataclasses.replace(base, camera=orbit_camera(base.camera, phi, theta, zoom))
    state0 = init_render_state(frame0, opts)
    k1_ms = time_ms(lambda: cuda_backend.render_cuda(frame0, opts, 1, state0), 20)
    plain_state = {}

    def plain_render():
        plain_state["s"] = cuda_backend.render_cuda_plain(frame0, opts, 1, state0)
    k1_plain_ms = time_ms(plain_render, 3, warmup=1)
    n_bytes, ops = cuda_backend.render_work(frame0, w0 * h0, 1, plain_state["s"].segments)
    k1_bound, k1_by = bound_ms(n_bytes, ops, FP32_FLOPS)
    # device time of the launch alone (CUDA graph replay), the datagen
    # launch, lane efficiencies (tools/k1_sweep.py)
    k1_shapes = {name: k1_sweep.measure(name, dev, time_ms, graph_ms)
                 for name in k1_sweep.SHAPES}
    k1_device_ms = k1_shapes["cornell_800_niter1"]["device_ms"]
    dg = k1_shapes["cornell_512_niter64"]
    dg_scene = k1_sweep.shape_scene("cornell_512_niter64", dev)[0]
    dg_bound = bound_ms(*cuda_backend.render_work(dg_scene, 512 * 512, dg["niter"],
                                                  dg["segments"]), FP32_FLOPS)
    emit({"phase": "render_timing", "card": smi, "kernel_ms": k1_ms,
          "device_ms": k1_device_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
          "bound_by": k1_by, "segments": plain_state["s"].segments, "bytes": n_bytes,
          "ops": ops, "registers": ptxas["render_megakernel"],
          "witness_registers": ptxas["render_megakernel_witness"],
          "shapes": k1_shapes, "datagen_bound_ms": dg_bound[0],
          "columns": "kernel_ms: CUDA events around render_cuda calls back to back (scene "
                     "packing and buffer copies included); device_ms: the launch alone, "
                     "CUDA graph replay; shapes: tools/k1_sweep.py's measure (lane "
                     "efficiency of one pixel per thread from the plain per-pixel segment "
                     "counts, the kernel's own from its lane-step count)"})

    # Both conv kernels per shape of the frame, side by side, beside their
    # plain versions, the bound and F.conv2d: device time per call (graph
    # replay); call_ms are events around calls made back to back, which
    # count the host's dispatch where it is slower than the card.
    conv_sum = {k: 0.0 for k in ("ms", "rows_ms", "plain_ms", "rows_plain_ms",
                                 "library_ms", "call_ms", "rows_call_ms", "bound_ms",
                                 "bytes_s", "ops_s")}
    per_shape = []
    for row in conv_rows:
        x, conv, aff = row["x"], row["conv"], row["aff"]
        r, wd, cin, co = row["shape"]
        w, b = conv["w"], conv["b"]
        xn = x.permute(2, 0, 1)[None]                       # NCHW view, channels-last
        wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bn = b.to(torch.bfloat16)
        nb, macs = conv_kernel.conv_work(r, wd, cin, co)
        t = {"ms": graph_ms(lambda: conv_kernel.conv3x3_act_chw(x, w, b, 0.1, aff), 20),
             "rows_ms": graph_ms(lambda: conv_kernel.conv3x3_act(x, w, b, 0.1, aff), 20),
             "plain_ms": graph_ms(lambda: conv_kernel.conv3x3_act_plain(x, w, b, 0.1, aff), 5),
             "rows_plain_ms": graph_ms(
                 lambda: conv_kernel.conv3x3_act_rows_plain(x, w, b, 0.1, aff), 5),
             "library_ms": graph_ms(lambda: F.conv2d(xn, wn, bn, padding=1), 20),
             "call_ms": time_ms(lambda: conv_kernel.conv3x3_act_chw(x, w, b, 0.1, aff), 20),
             "rows_call_ms": time_ms(lambda: conv_kernel.conv3x3_act(x, w, b, 0.1, aff), 20),
             "bound_ms": bound_ms(nb, 2 * macs, BF16_FLOPS)[0],
             "bytes_s": nb / HBM_BPS, "ops_s": 2 * macs / BF16_FLOPS}
        for k, v in t.items():
            conv_sum[k] += v
        plan = conv_kernel.conv_plan(1, r, wd, co)
        rplan = conv_kernel.rows_plan(1, r, wd, cin, co)
        per_shape.append({"layer": row["layer"], "shape": row["shape"],
                          "affine": row["affine"],
                          **{k: v for k, v in t.items() if k.endswith("_ms") or k == "ms"},
                          "pct_of_bound": 100 * t["bound_ms"] / t["ms"],
                          "rows_pct_of_bound": 100 * t["bound_ms"] / t["rows_ms"],
                          "blocks": plan.blocks, "block_channels": 8 * plan.nb,
                          "channel_groups": plan.groups, "tile": [plan.tw, plan.th],
                          "rows_blocks": rplan.blocks, "rows_smem_bytes": rplan.smem,
                          "rows_block_channels": 8 * rplan.nb,
                          "rows_channel_groups": rplan.groups, "rows_band": [64, rplan.th]})
    conv_bound_by = "bytes" if conv_sum["bytes_s"] >= conv_sum["ops_s"] else "operations"
    emit({"phase": "conv_timing", "card": smi, "per_shape": per_shape,
          "frame_pct_of_bound": 100 * conv_sum["bound_ms"] / conv_sum["ms"],
          "frame_rows_pct_of_bound": 100 * conv_sum["bound_ms"] / conv_sum["rows_ms"],
          "frame_ms": conv_sum["ms"], "frame_rows_ms": conv_sum["rows_ms"],
          "frame_plain_ms": conv_sum["plain_ms"],
          "frame_rows_plain_ms": conv_sum["rows_plain_ms"],
          "frame_library_ms": conv_sum["library_ms"], "frame_bound_ms": conv_sum["bound_ms"],
          "frame_call_ms": conv_sum["call_ms"], "frame_rows_call_ms": conv_sum["rows_call_ms"],
          "bound_by": conv_bound_by,
          "columns": "ms = tile kernel (K2), rows_ms = row-band kernel (K3): device time "
                     "per call, CUDA graph replay; call_ms = CUDA events around calls back "
                     "to back (the host's dispatch included where it is slower); rows_blocks, "
                     "rows_smem_bytes = K3's launch: blocks and dynamic shared memory per "
                     "block (rows_band = segment x band rows)",
          "library_call": "F.conv2d(bf16, channels_last, bias) -- conv + bias only"})
    del conv_rows

    def busy_ms(fn):
        """The card's busy time in ``fn()``: the profiler's sum of kernel
        times.  A trace that comes back without device events is taken once
        more before the check fails."""
        from torch.profiler import ProfilerActivity, profile
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            total_us = sum(getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0))
                           for e in prof.key_averages())
            if total_us > 0:
                return total_us / 1e3
        require(False, "the profiler reported device time")

    def timed_calls(module, name, bucket_of):
        """Context manager: time every call of ``module.name`` with CUDA events
        into ``spans[bucket_of(args, kwargs)]``; ``total_ms()`` after a
        synchronise sums each bucket."""
        spans = {}

        @contextlib.contextmanager
        def cm():
            orig = getattr(module, name)

            def wrapped(*args, **kwargs):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = orig(*args, **kwargs)
                b.record()
                spans.setdefault(bucket_of(args, kwargs), []).append((a, b))
                return out

            setattr(module, name, wrapped)
            try:
                yield
            finally:
                setattr(module, name, orig)

        def total_ms():
            return {k: (len(v), sum(a.elapsed_time(b) for a, b in v))
                    for k, v in spans.items()}
        return cm, total_ms

    # ---- 6b. the conv's autograd at the train step's 28 shapes ----
    # Conv3x3Function (forward and input gradient through the tile kernel,
    # weight gradient as plain contractions) against the plain backward pass
    # (the forward pass's scatter, float32) and against F.conv2d's autograd in
    # float32, on a batch of 4 at 256x256 down to 8x8, the reference widths;
    # then the times of its three parts and of F.conv2d's forward + backward.
    mopt = ModelOptions()
    ref_params, _ = trainer.init_autoencoder(torch.Generator().manual_seed(0), mopt)
    train_shapes = []                                   # (layer, H, Cin, Co)
    res = TRAIN_CROP
    for i in range(1, 6):
        train_shapes += [(f"enc{i}.conv{j}", res, *ref_params[f"enc{i}"][f"conv{j}"]["w"].shape[2:])
                         for j in (1, 2, 3)]
        res //= 2
    train_shapes += [(f"bottleneck.conv{j}", res,
                      *ref_params["bottleneck"][f"conv{j}"]["w"].shape[2:]) for j in (1, 2, 3)]
    for i in range(5, 0, -1):
        res *= 2
        train_shapes += [(f"dec{i}.conv{j}", res, *ref_params[f"dec{i}"][f"conv{j}"]["w"].shape[2:])
                         for j in (1, 2)]
    require(len(train_shapes) == 28 and train_shapes[0][1:] == (256, 10, 32)
            and train_shapes[-1][1:] == (256, 3, 3), "the train step's 28 conv shapes")
    grad_err = {"bfloat16": {"y": 0.0, "dx": 0.0, "dw": 0.0, "dx_lib": 0.0, "dw_lib": 0.0},
                "float32": {"y": 0.0, "dx": 0.0, "dw": 0.0, "dx_lib": 0.0, "dw_lib": 0.0}}
    grad_rows = []
    grad_sum = {k: 0.0 for k in ("fwd_ms", "dgrad_ms", "wgrad_ms", "library_fwd_bwd_ms",
                                 "fwd_device_ms", "dgrad_device_ms",
                                 "fwd_bound_ms", "dgrad_bound_ms")}
    n = TRAIN_BATCH
    for name, r, cin, co in train_shapes:
        x32 = torch.randn((n, r, r, cin), generator=gen, device=dev)
        w32 = torch.randn((3, 3, cin, co), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        g32 = torch.randn((n, r, r, co), generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            f32 = dtype == torch.float32
            x = x32.to(dtype, copy=True).requires_grad_(True)
            w = w32.to(dtype, copy=True).requires_grad_(True)
            before = conv_kernel.KERNEL.launches
            y = layers.Conv3x3Function.apply(x, w)
            dx, dw = torch.autograd.grad(y, (x, w), g32)
            require(conv_kernel.KERNEL.launches == before + 2, f"{name}: forward + dgrad launches")
            require(y.dtype == torch.float32 and dx.dtype == dtype and dw.dtype == dtype,
                    f"{name}: dtypes of y, dx, dw")
            g = g32.to(dtype)                     # the backward pass rounds g to x's dtype
            want_y = conv_kernel.conv3x3_act_plain(x.detach(), w.detach(), torch.zeros(co, device=dev),
                                                   1.0, None, "float32")
            want_dx, want_dw = conv_kernel.conv3x3_backward_plain(x.detach(), w.detach(), g)
            xl = x.detach().float().permute(0, 3, 1, 2).requires_grad_(True)
            wl = w.detach().float().permute(3, 2, 0, 1).requires_grad_(True)
            lib_dx, lib_dw = torch.autograd.grad(F.conv2d(xl, wl, padding=1), (xl, wl),
                                                 g.float().permute(0, 3, 1, 2))
            pairs = {"y": (y, want_y, True), "dx": (dx, want_dx, f32), "dw": (dw, want_dw, f32),
                     "dx_lib": (dx, lib_dx.permute(0, 2, 3, 1), f32),
                     "dw_lib": (dw, lib_dw.permute(2, 3, 1, 0), f32)}
            for key, (got, want, tight) in pairs.items():
                # dw sums N*H*W products: its tolerance scales with its size
                scale = float(want.abs().max()) if key.startswith("dw") else 1.0
                ok, err = within(got / scale, want / scale, tight)
                grad_err[str(dtype)[6:]][key] = max(grad_err[str(dtype)[6:]][key], err)
                require(ok, f"conv grad check {key} at {name} ({dtype}): err {err} of scale {scale}")
        # no input gradient asked for: the dgrad launch is skipped
        before = conv_kernel.KERNEL.launches
        xb = x32.to(torch.bfloat16)
        wb = w32.to(torch.bfloat16).requires_grad_(True)
        torch.autograd.grad(layers.Conv3x3Function.apply(xb, wb), (wb,), g32)
        require(conv_kernel.KERNEL.launches == before + 1, f"{name}: dgrad skipped")
        # times of the three parts (bfloat16), and F.conv2d forward + backward
        wb = wb.detach()
        gb = g32.to(torch.bfloat16)
        wt = wb.flip(0, 1).transpose(2, 3).contiguous()
        zb_o, zb_i = torch.zeros(co, device=dev), torch.zeros(cin, device=dev)
        xn = xb.permute(0, 3, 1, 2).requires_grad_(True)
        wn = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        gn = gb.permute(0, 3, 1, 2)
        fb, fmacs = conv_kernel.conv_work(r, r, cin, co, out_bytes=4, n=n)
        db, dmacs = conv_kernel.conv_work(r, r, co, cin, out_bytes=2, n=n)
        t = {"fwd_ms": time_ms(lambda: conv_kernel.conv3x3_act_chw(xb, wb, zb_o, 1.0, None, "float32"), 10),
             "dgrad_ms": time_ms(lambda: conv_kernel.conv3x3_act_chw(gb, wt, zb_i, 1.0), 10),
             "wgrad_ms": time_ms(lambda: conv_kernel.conv3x3_wgrad(xb, gb), 5),
             "library_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                 F.conv2d(xn, wn, padding=1), (xn, wn), gn), 10),
             "fwd_device_ms": graph_ms(lambda: conv_kernel.conv3x3_act_chw(
                 xb, wb, zb_o, 1.0, None, "float32"), 10),
             "dgrad_device_ms": graph_ms(lambda: conv_kernel.conv3x3_act_chw(gb, wt, zb_i, 1.0), 10),
             "fwd_bound_ms": bound_ms(fb, 2 * fmacs, BF16_FLOPS)[0],
             "dgrad_bound_ms": bound_ms(db, 2 * dmacs, BF16_FLOPS)[0]}
        for k, v in t.items():
            # per step: 7 frames; the input layer's dgrad is never asked for
            if not (name == "enc1.conv1" and k.startswith("dgrad")):
                grad_sum[k] += TRAIN_SEQ * v
        grad_rows.append({"layer": name, "shape": [n, r, r, cin, co], **t,
                          "fwd_pct_of_bound": 100 * t["fwd_bound_ms"] / t["fwd_device_ms"],
                          "dgrad_pct_of_bound": 100 * t["dgrad_bound_ms"] / t["dgrad_device_ms"],
                          "fwd_blocks": conv_kernel.conv_plan(n, r, r, co).blocks,
                          "dgrad_blocks": conv_kernel.conv_plan(n, r, r, cin).blocks})
    torch.cuda.synchronize()
    emit({"phase": "conv_grad_check", "shapes": len(train_shapes), "batch": n,
          "max_abs_err": grad_err,
          "against": "y, dx, dw: the plain forward/backward pass in float32 on the same "
                     "(rounded) inputs; dx_lib, dw_lib: F.conv2d's autograd in float32 "
                     "(TF32 off); dw compared relative to its largest entry",
          "tolerance": "bfloat16 dx, dw |k-p| <= 1e-2 + 1.6e-2|p| (rounded once to "
                       "bfloat16); float32 y, dx, dw |k-p| <= 1e-3 + 1e-3|p|",
          "launches_checked": "forward + dgrad = 2 per call, 1 when x needs no gradient"})
    emit({"phase": "conv_grad_timing", "card": smi, "per_shape": grad_rows,
          "per_step_ms": grad_sum,
          "per_step_pct_of_bound": {
              "fwd": 100 * grad_sum["fwd_bound_ms"] / grad_sum["fwd_device_ms"],
              "dgrad": 100 * grad_sum["dgrad_bound_ms"] / grad_sum["dgrad_device_ms"]},
          "per_step": "7 frames x 28 convs, less the input layer's 7 dgrads; batch 4, "
                      "bfloat16 in, forward float32 out; *_ms: CUDA events around calls "
                      "back to back, *_device_ms: CUDA graph replay (device time only)",
          "library_call": "F.conv2d(bf16, channels_last) forward + autograd backward "
                          "(dx and dw)"})

    # ---- 6c. the training path: datagen -> train -> export -> interactive ----
    train_dir = os.path.join(OUT_DIR, "train")
    shutil.rmtree(train_dir, ignore_errors=True)     # datagen resumes: start empty
    data_dir, model_dir = os.path.join(train_dir, "data"), os.path.join(train_dir, "models")
    log_dir = os.path.join(train_dir, "logs")

    def reset_counts():
        for k in kernels:
            k.launches = 0

    def launch_counts():
        return {k.name: k.launches for k in kernels}

    reset_counts()
    t0 = time.time()
    cli.main(["datagen", SCENE, "--res", str(TRAIN_RES), "--frames", str(TRAIN_FRAMES),
              "--movs", "1", "--gt-spp", str(TRAIN_GT_SPP), "--noise-seeds", "1",
              "--out-dir", data_dir])
    torch.cuda.synchronize()
    datagen_s = time.time() - t0
    datagen_launches = launch_counts()
    # per frame: one launch for the 64-spp ground truth, one for the 1-spp input
    require(datagen_launches["render_megakernel"] == 2 * TRAIN_FRAMES
            and sum(datagen_launches.values()) == 2 * TRAIN_FRAMES,
            f"datagen launches {datagen_launches}")
    dataset = SequenceDataset(os.path.join(data_dir, "input"), os.path.join(data_dir, "gt"),
                              crop=True, crop_size=TRAIN_CROP)
    require(len(dataset) == TRAIN_FRAMES and dataset.inputs[0] == "000_0_0_0000.npy"
            and dataset.inputs[-1] == f"000_0_0_{TRAIN_FRAMES - 1:04d}.npy", "datagen's stems")
    x0, y0 = np.load(dataset.path_of(0)), np.load(dataset.path_of(0, gt=True))
    require(x0.shape == (TRAIN_RES, TRAIN_RES, 10) and y0.shape == (TRAIN_RES, TRAIN_RES, 3)
            and x0.dtype == y0.dtype == np.float32 and np.isfinite(x0).all()
            and 0.0 <= y0.min() and y0.max() <= 1.0 and y0.std() > 0.05
            and (x0[..., 6] > 0).mean() > 0.8, "datagen's arrays")

    topt = TrainOptions(epochs=1, crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH)
    require(topt.bf16_compute and topt.sequence_length == TRAIN_SEQ and not topt.remat_frames,
            "the reference train options")
    X, Y, starts = device_data.load_device_dataset(dataset, dtype=torch.bfloat16, device=dev)
    fixed_x, fixed_y = device_data._crop_batch(
        X, Y, starts[[0, 3, 6, 9]].tolist(), [0, 0, TRAIN_CROP, TRAIN_CROP],
        [0, TRAIN_CROP, 0, TRAIN_CROP], TRAIN_SEQ, TRAIN_CROP, TRAIN_CROP)
    require(fixed_x.shape == (TRAIN_SEQ, TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 10), "fixed batch")

    def fixed_loss(state):
        with torch.no_grad():
            total, _ = trainer.loss_fn(state.params, state.bn_state, fixed_x, fixed_y, topt,
                                       topt.bf16_compute, mopt)
        return float(total)

    state0 = init_train_state(torch.Generator().manual_seed(topt.seed), mopt, topt, device=dev)
    loss_before = fixed_loss(state0)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    final = cli.main(["train", "--data-dir", data_dir, "--model-dir", model_dir,
                      "--log-dir", log_dir, "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
                      "--crop-size", str(TRAIN_CROP), "--device-data", "--log-every", "1"])
    torch.cuda.synchronize()
    train_s = time.time() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    train_launches = launch_counts()
    steps = TRAIN_FRAMES // TRAIN_BATCH
    k2_per_step = 28 * TRAIN_SEQ + (28 * TRAIN_SEQ - TRAIN_SEQ)   # forward + dgrad
    require(final.step == steps and steps >= 3, f"optimiser steps {final.step}")
    require(train_launches["conv3x3_act"] == steps * k2_per_step
            and sum(train_launches.values()) == steps * k2_per_step,
            f"train launches {train_launches}, expected {steps} x {k2_per_step} of K2 alone")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line)["total"] for line in f]
    loss_after = fixed_loss(final)
    ckpt = os.path.join(model_dir, "model_final.npz")
    loss_reloaded = fixed_loss(load_checkpoint(ckpt, device=dev))
    require(len(logged) == steps and all(np.isfinite(logged))
            and np.isfinite([loss_before, loss_after]).all(), "losses finite")
    require(loss_after < loss_before, f"loss on the fixed batch {loss_before} -> {loss_after}")
    require(abs(loss_reloaded - loss_after) <= 1e-6 * abs(loss_after),
            f"checkpoint reloads to the same loss: {loss_reloaded} vs {loss_after}")
    deploy = os.path.join(train_dir, "model_deploy.npz")
    cli.main(["export", ckpt, "--out", deploy])
    impl_frames, impl_launches, impl_ms = {}, {}, {}
    for impl in ("pallas2", "pallas"):
        reset_counts()
        recs = cli.main(["interactive", SCENE, "--frames", str(MODEL_FRAMES), "--model", deploy,
                         "--out-dir", os.path.join(train_dir, f"frames_{impl}"),
                         "--conv-impl", impl, "--save-arrays"])
        impl_launches[impl] = launch_counts()
        impl_ms[impl] = [round(r_["denoise_ms"], 3) for r_ in recs]
        require(all(r_["finite"] for r_ in recs), f"{impl}: frames finite")
        impl_frames[impl] = [np.load(r_["path"][:-len(".png")] + "_denoised.npy") for r_ in recs]
    used, other = ("conv3x3_act", "conv3x3_rows")
    require(impl_launches["pallas2"][used] == 28 * MODEL_FRAMES
            and impl_launches["pallas2"][other] == 0
            and impl_launches["pallas"][other] == 28 * MODEL_FRAMES
            and impl_launches["pallas"][used] == 0
            and impl_launches["pallas"]["render_megakernel"] == MODEL_FRAMES,
            f"conv impl launches {impl_launches}")
    rows_launches = impl_launches["pallas"][other]
    impl_rel = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                for a, b in zip(impl_frames["pallas"], impl_frames["pallas2"])]
    impl_close = [float((np.abs(a - b) <= 1e-2 + 1.6e-2 * np.abs(b)).mean())
                  for a, b in zip(impl_frames["pallas"], impl_frames["pallas2"])]
    require(max(impl_rel) < 2e-2 and min(impl_close) >= 0.99,
            f"the two conv impls' frames: rel L2 {impl_rel}, close fraction {impl_close}")
    emit({"phase": "train_path", "card": smi, "scene": "cornell_box",
          "corpus": {"res": TRAIN_RES, "frames": TRAIN_FRAMES, "gt_spp": TRAIN_GT_SPP,
                     "seconds": datagen_s, "launches": datagen_launches},
          "train": {"widths": list(mopt.widths), "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
                    "sequence": TRAIN_SEQ, "bf16_compute": True, "steps": steps,
                    "seconds_with_upload_and_checkpoints": train_s,
                    "launches": train_launches, "k2_launches_per_step": k2_per_step,
                    "k2_launches_per_step_formula": "28*7 forward + (28*7 - 7) dgrad, "
                                                    "one launch per batch",
                    "logged_step_losses": logged,
                    "peak_memory_bytes": peak_bytes,
                    "peak_memory_gib": peak_bytes / 2 ** 30},
          "fixed_batch_loss": {"before": loss_before, "after": loss_after,
                               "reloaded_checkpoint": loss_reloaded},
          "interactive_with_trained_model": {
              "frames_per_impl": MODEL_FRAMES, "launches": impl_launches,
              "denoise_ms": impl_ms, "rel_l2_pallas_vs_pallas2": impl_rel,
              "fraction_within_bf16_tolerance": impl_close,
              "tolerance": "rel L2 < 2e-2 and |a-b| <= 1e-2 + 1.6e-2|b| on >= 99% of "
                           "values: each of 28 layers rounds to bfloat16, and the two "
                           "kernels sum in different orders"}})

    # ---- 6d. where a train step's time goes ----
    # The user's entry (trainer.train_step) on the fixed batch; its three parts
    # with events between them; inside one more step the conv kernel's forward
    # and dgrad calls and the weight gradient, each call between two events;
    # and the card's busy time in a step (profiler).
    state = final
    step_ms = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, _ = trainer.train_step(state, fixed_x, fixed_y, topt, mopt)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        leaves = [leaf.detach().requires_grad_(True) for _, leaf in sorted_leaves(state.params)]
        params = trainer.tree_from_leaves(state.params, leaves)
        ev[0].record()
        total, (_, new_bn) = trainer.loss_fn(params, state.bn_state, fixed_x, fixed_y, topt,
                                             True, mopt)
        ev[1].record()
        grads = torch.autograd.grad(total, leaves)
        ev[2].record()
        new_params, opt_state = trainer.adam_update(
            state.params, trainer.tree_from_leaves(state.params, list(grads)),
            state.opt_state, state.lr)
        ev[3].record()
        ev[3].synchronize()
        for key, i in (("forward_ms", 0), ("backward_ms", 1), ("optimizer_ms", 2)):
            parts[key].append(ev[i].elapsed_time(ev[i + 1]))
        state = dataclasses.replace(state, params=new_params, opt_state=opt_state,
                                    step=state.step + 1)
    conv_cm, conv_total = timed_calls(
        conv_kernel, "conv3x3_act_chw",
        lambda args, kwargs: "k2_forward" if (kwargs.get("out_dtype") or
                                              (len(args) > 5 and args[5])) else "k2_dgrad")
    wgrad_cm, wgrad_total = timed_calls(conv_kernel, "conv3x3_wgrad", lambda a, k: "wgrad")
    with conv_cm(), wgrad_cm():
        trainer.train_step(state, fixed_x, fixed_y, topt, mopt)
    torch.cuda.synchronize()
    in_step = {**conv_total(), **wgrad_total()}
    require(in_step["k2_forward"][0] == 28 * TRAIN_SEQ
            and in_step["k2_dgrad"][0] == 28 * TRAIN_SEQ - TRAIN_SEQ
            and in_step["wgrad"][0] == 28 * TRAIN_SEQ, f"calls inside a step {in_step}")
    # how long the host takes to dispatch a step, against the card's time for it
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    trainer.train_step(state, fixed_x, fixed_y, topt, mopt)
    b.record()
    host_dispatch_ms = (time.perf_counter() - t0) * 1e3
    b.synchronize()
    dispatched_step_ms = a.elapsed_time(b)
    step_median = statistics.median(step_ms[1:])
    k2_train = {"train_launches_per_step": k2_per_step,
                "train_forward_ms_per_step": in_step["k2_forward"][1],
                "train_dgrad_ms_per_step": in_step["k2_dgrad"][1],
                "train_alone_device_ms_per_step": grad_sum["fwd_device_ms"]
                + grad_sum["dgrad_device_ms"],
                "train_bound_ms_per_step": grad_sum["fwd_bound_ms"] + grad_sum["dgrad_bound_ms"],
                "train_library_fwd_bwd_ms_per_step": grad_sum["library_fwd_bwd_ms"]}
    emit({"phase": "train_timing", "card": smi, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
          "sequence": TRAIN_SEQ, "step_ms": step_ms, "step_ms_median_after_first": step_median,
          "parts_ms_median_after_first": {k: statistics.median(v[1:]) for k, v in parts.items()},
          "parts_ms": parts,
          "inside_one_step": {k: {"calls": c, "ms": ms} for k, (c, ms) in in_step.items()},
          "conv_kernel_calls_alone_per_step_ms": grad_sum,
          "host_dispatch_ms_of_one_step": host_dispatch_ms, "that_step_ms": dispatched_step_ms,
          "note": "inside_one_step brackets each call with events in the running step "
                  "(wrapper work included); conv_kernel_calls_alone is 7 x the sum of "
                  "the 28 shapes timed back to back in conv_grad_timing; "
                  "host_dispatch_ms is the host clock until train_step returned, "
                  "the card still working"})
    del X, Y, final, state0

    # ---- 6b. the wavefront's geom kernel K10 on a statue frame's queries ----
    geom_row = phase_geom_kernel(smi, dev)

    # ---- 6c. the kernel-predicting denoiser's K11 and K12 on a cornell frame,
    # then `interactive --denoiser kpcn` through the command line ----
    kpcn_rows = phase_kpcn_kernels(smi, dev)
    phase_kpcn_path(cli, kernels, smi, dev)

    # ---- 7. mesh kernels vs their plain versions, on a real frame's rays ----
    # One 800x800 frame of each mesh scene is rendered with each BVH
    # intersection while the kernels' wrappers record their arguments; the
    # first two calls are the primary rays and the first secondary bounce.
    # Each wrapper is then launched once on a recorded call's whole tensors
    # (the shapes the main path gives it) and its whole output is held
    # against the plain version's on the same tensors.
    def frame_zero(path):
        sc = load_scene(path, device=dev)
        ph, th, zm = orbit_params_from_camera(sc.camera)
        return dataclasses.replace(sc, camera=orbit_camera(sc.camera, ph, th, zm))

    def record_frame(sc, impl, **options):
        calls = {"v2p": [], "phase1": [], "pair": [], "binned": [], "paths": []}
        with recording(mesh_kernel_v2p, "mesh_intersect_bvh_v2p", calls["v2p"]), \
                recording(mesh_binned, "_phase1", calls["phase1"]), \
                recording(mesh_binned, "_pair_call", calls["pair"]), \
                recording(mesh_binned, "mesh_intersect_binned", calls["binned"],
                          after=lambda: calls["paths"].append(binned_paths())):
            before = binned_paths()
            render_gbuffer_frame(sc, RenderOptions(mesh_kernel_impl=impl, **options))
        torch.cuda.synchronize()
        # which side each recorded call of the binned pipeline took
        calls["sides"] = []
        for now in calls["paths"]:
            calls["sides"].append("fast" if now["fast"] > before["fast"] else "fallback")
            before = now
        return calls

    def plain_v2p(bvh, o, d, tc, step=64000):
        """The traversal's plain version over all the rays given, computed
        in slices of ``step`` rays (the dense scan's tiles are faces x rays)."""
        parts = [flat_hit(mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(
            bvh, *subset((o, d, tc), slice(lo, lo + step)), chunk=256))
            for lo in range(0, tc.shape[0], step)]
        return tuple(torch.cat(col) for col in zip(*parts))

    def wall_ms(fn):
        """(result, milliseconds) of one call of ``fn``, the card drained
        before and after."""
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    mesh_scenes = {name: frame_zero(path) for name, path in MESH_SCENES.items()}
    recorded = {}
    mesh_err = {"mesh_bvh_v2p": 0.0, "mesh_binned_phase1": 0.0, "mesh_binned_pair": 0.0,
                "mesh_bvh_v2": 0.0, "mesh_bvh_v3": 0.0}

    def traversals(bvh, o, d, tc):
        """The tile-gated kernel at both granules and the front-to-back kernel."""
        return {"mesh_bvh_v2": {1024: flat_hit(mesh_kernel.mesh_intersect_bvh(bvh, o, d, tc)),
                                128: flat_hit(mesh_kernel.mesh_intersect_bvh(bvh, o, d, tc, 128))},
                "mesh_bvh_v3": {128: flat_hit(mesh_kernel_v3.mesh_intersect_bvh_v3(bvh, o, d, tc))}}

    def all_equal(got, want):
        return all(torch.equal(a, b) for a, b in zip(got, want))

    def counted(fn):
        """(result, visits) of ``fn(visit_counter)``."""
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        out = fn(counter)
        return out, int(counter.item())

    def check_traversals(where, bvh, o, d, tc, want, k4):
        """K7 and K8 on one whole call against the dense scan ``want`` and the
        per-ray kernel's output ``k4``; on two slices of VISIT_SLICE rays
        that start on a whole 1024-ray tile, the whole call's output against
        the kernel's own plain version (the tile walk) on the slice, and the
        kernel launched on the slice itself against that walk, output and
        visits (the plain walk on the card's tensors); one JSON line each."""
        n = tc.shape[0]
        got = traversals(bvh, o, d, tc)
        slices = [slice(lo, lo + VISIT_SLICE) for lo in (0, n // 2 // 1024 * 1024)]
        own = {"mesh_bvh_v2": lambda sl, lanes, **kw: mesh_kernel.mesh_intersect_bvh_plain(
                   bvh, *subset((o, d, tc), sl), lanes, **kw),
               "mesh_bvh_v3": lambda sl, lanes, **kw: mesh_kernel_v3.mesh_intersect_bvh_v3_plain(
                   bvh, *subset((o, d, tc), sl), **kw)}
        kern = {"mesh_bvh_v2": lambda sl, lanes, **kw: mesh_kernel.mesh_intersect_bvh(
                    bvh, *subset((o, d, tc), sl), lanes, **kw),
                "mesh_bvh_v3": lambda sl, lanes, **kw: mesh_kernel_v3.mesh_intersect_bvh_v3(
                    bvh, *subset((o, d, tc), sl), **kw)}
        for kname, by_lanes in got.items():
            for lanes, res in by_lanes.items():
                err = max_abs_diff(res, want)
                mesh_err[kname] = max(mesh_err[kname], err)
                own_equal, slice_visits = True, []
                for sl in slices:
                    plain, plain_visits = counted(
                        lambda c: flat_hit(own[kname](sl, lanes, visit_counter=c)))
                    alone, visits = counted(
                        lambda c: flat_hit(kern[kname](sl, lanes, visit_counter=c)))
                    own_equal = (own_equal and all_equal(subset(res, sl), plain)
                                 and all_equal(alone, plain))
                    slice_visits.append({"rays": [sl.start, sl.stop], "kernel": visits,
                                         "plain": plain_visits})
                visits_equal = all(v["kernel"] == v["plain"] for v in slice_visits)
                rec_ = {"phase": "mesh_v2_check" if kname == "mesh_bvh_v2" else "mesh_v3_check",
                        **where, "rays": n, "lanes": lanes,
                        "live": int((tc > float("-inf")).sum()),
                        "hits": int(torch.isfinite(want[0]).sum()),
                        "equals_dense_scan": all_equal(res, want),
                        "equals_per_ray_kernel": all_equal(res, k4),
                        "equals_own_plain_on_slices": own_equal,
                        "slice_visits": slice_visits, "visits_equal_plain": visits_equal,
                        "max_abs_err": err,
                        "bar": "t, point, normal, material equal bit for bit (torch.equal) "
                               "to the dense scan and to the per-ray kernel on every ray "
                               "of the call; on each whole-tile slice of "
                               f"{VISIT_SLICE} rays, the call's output and the kernel "
                               "launched on the slice equal to the kernel's own plain "
                               "version, and the launch's visits equal to the plain "
                               "walk's"}
                emit(rec_)
                require(rec_["equals_dense_scan"] and rec_["equals_per_ray_kernel"]
                        and own_equal and visits_equal, f"{kname} at lanes {lanes} on {where}")
                require(any(v["kernel"] > 0 for v in slice_visits),
                        f"{kname} at lanes {lanes} on {where}: no visit on either slice")

    for name, sc in mesh_scenes.items():
        bvh = sc.mesh.bvh
        rec = {impl: record_frame(sc, impl) for impl in ("v2p", "binned")}
        recorded[name] = rec
        require(len(rec["v2p"]["v2p"]) >= 2 and len(rec["binned"]["phase1"]) >= 2
                and len(rec["binned"]["pair"]) >= 1
                and len(rec["binned"]["binned"]) >= 2, f"{name}: recorded calls")
        for bounce, args in enumerate(rec["v2p"]["v2p"][:2]):
            _, o, d, tc = args[:4]
            n = tc.shape[0]
            require(n == w0 * h0, f"{name}: the frame's {w0 * h0} rays, got {n}")
            got = flat_hit(mesh_kernel_v2p.mesh_intersect_bvh_v2p(bvh, o, d, tc))
            want, plain_ms = wall_ms(lambda: plain_v2p(bvh, o, d, tc))
            err = max_abs_diff(got, want)
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            mesh_err["mesh_bvh_v2p"] = max(mesh_err["mesh_bvh_v2p"], err)
            emit({"phase": "mesh_v2p_check", "scene": name, "bounce": bounce,
                  "rays": n, "live": int((tc > float("-inf")).sum()),
                  "hits": int(torch.isfinite(want[0]).sum()), "bitwise_equal": equal,
                  "max_abs_err": err, "plain_ms": plain_ms,
                  "bar": "t, point, normal, material equal bit for bit "
                         "(torch.equal) on every ray of the call"})
            require(equal and int(torch.isfinite(want[0]).sum()) > 0,
                    f"BVH kernel vs plain on {name}, bounce {bounce}")
            check_traversals({"scene": name, "bounce": bounce}, bvh, o, d, tc, want, got)
            # The binned pipeline as a whole against the dense scan, on the
            # same bounce of the frame rendered through it.  That frame skips
            # the carry sort, so after the primary rays its lanes are the
            # traversal frame's in another order and get a dense scan of
            # their own.  With the frame's own packing prefixes the call
            # must take the side it took in the frame, with tiny ones the
            # fallback.
            b_args = rec["binned"]["binned"][bounce][:4]
            require(b_args[3].shape[0] == n, f"{name}: the binned frame's rays")
            same_rays = all(torch.equal(a, b) for a, b in
                            zip((*b_args[1], *b_args[2], b_args[3]), (*o, *d, tc)))
            if not same_rays:
                want = plain_v2p(*b_args)
            frame_side = rec["binned"]["sides"][bounce]
            for caps, side in (({}, frame_side), ({"lcap": 64, "lcapb": 64}, "fallback")):
                paths = binned_paths()
                whole = flat_hit(mesh_binned.mesh_intersect_binned(*b_args, **caps))
                took = {k: v - paths[k] for k, v in binned_paths().items()}
                same = all(torch.equal(a, b) for a, b in zip(whole, want))
                emit({"phase": "mesh_binned_check", "scene": name, "bounce": bounce,
                      "rays": n, "caps": caps or "default", **took,
                      "side_in_frame": frame_side,
                      "lanes_ordered_as_traversal_frame": same_rays,
                      "bitwise_equal": same,
                      "max_abs_err": max_abs_diff(whole, want),
                      "bar": "equal to the dense scan bit for bit (torch.equal) "
                             "on every ray of the call"})
                require(same, f"binned pipeline vs dense scan on {name}, bounce {bounce}")
                require(took[side] == 1 and sum(took.values()) == 1,
                        f"binned pipeline on {name}, bounce {bounce}: expected "
                        f"the {side} side, took {took}")
        # K5 and K6 on every call of the frame rendered through the binned
        # pipeline.  Each call of bounces 0 and 1 (K5: tiers A and B, K6: one
        # each) must have a ray live in a bin and a pair that hits; of the
        # later calls, one.
        most = {"phase1": 0, "pair": 0}         # largest count, most hits in a later call
        for call, args in enumerate(rec["binned"]["phase1"]):
            o, d, tc, bounds, kb_, skip, c_out = args
            got = mesh_binned._phase1(*args)
            want, plain_ms = wall_ms(lambda: mesh_binned._phase1_plain(*args))
            equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            err = max_abs_diff(got, want)
            mesh_err["mesh_binned_phase1"] = max(mesh_err["mesh_binned_phase1"], err)
            emit({"phase": "mesh_phase1_check", "scene": name, "call": call,
                  "rays": tc.shape[0], "live_rays": int((tc > float("-inf")).sum()),
                  "bins": kb_, "skip": skip, "c_out": c_out,
                  "max_count": int(want[1].max()), "bitwise_equal": equal,
                  "max_abs_err": err, "plain_ms": plain_ms,
                  "bar": "slots and counts equal as integers on every ray of the call"})
            require(equal, f"phase-1 kernel vs plain on {name}, call {call}")
            require(call >= 4 or int(want[1].max()) > 0,
                    f"phase-1 call {call} on {name}: no ray live in a bin")
            most["phase1"] = max(most["phase1"], int(want[1].max()) if call >= 4 else 0)
        for call, args in enumerate(rec["binned"]["pair"]):
            o, d, key, faces, kb_ = args
            got = mesh_binned._pair_call(*args)
            want, plain_ms = wall_ms(lambda: mesh_binned._pair_plain(*args))
            equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            err = max_abs_diff(got, want)
            mesh_err["mesh_binned_pair"] = max(mesh_err["mesh_binned_pair"], err)
            emit({"phase": "mesh_pair_check", "scene": name, "call": call,
                  "pairs": key.shape[0], "live_pairs": int((key < kb_).sum()),
                  "hits": int((want[1] >= 0).sum()), "bitwise_equal": equal,
                  "max_abs_err": err, "plain_ms": plain_ms,
                  "bar": "t equal bit for bit, face ids equal, on every pair of the call"})
            require(equal, f"pair kernel vs plain on {name}, call {call}")
            hits = int((want[1] >= 0).sum())
            require(call >= 2 or hits > 0, f"pair call {call} on {name}: no pair hits")
            most["pair"] = max(most["pair"], hits if call >= 2 else 0)
        require(most["phase1"] > 0 and most["pair"] > 0,
                f"{name}: past bounce 1, rays live in bins and pairs that hit ({most})")
    # the pair kernel's fast reciprocal against IEEE division on every float
    # in [2^-23, 2^126), the range in which the kernel uses it
    rcp_bad = mesh_binned.rcp_fast_mismatches(dev)
    emit({"phase": "mesh_pair_rcp_check", "floats_tried": 0x7e800000 - 0x34000000,
          "mismatches": rcp_bad, "bar": "0: bit for bit the IEEE quotient"})
    require(rcp_bad == 0, "pair kernel's fast reciprocal vs IEEE division")

    # ---- 8. the mesh paths: interactive 800x800, depth 8, shipped model ----
    box_depth = render_gbuffer_frame(frame0, opts)[1][6].cpu().numpy()
    mesh_launches = {}
    for name, path in MESH_SCENES.items():
        for k in kernels:
            k.launches = 0
        paths0 = binned_paths()
        out_dir = os.path.join(OUT_DIR, f"frames_{name}")
        records = cli.main(["interactive", path, "--frames", str(MESH_FRAMES),
                            "--model", MODEL, "--out-dir", out_dir, "--save-arrays"])
        counts = {k.name: k.launches for k in kernels}
        paths = {k: v - paths0[k] for k, v in binned_paths().items()}
        mesh_launches[name] = counts
        require(counts["render_megakernel"] == 0, f"{name}: K1 launches {counts}")
        require(counts["conv3x3_act"] == 28 * MESH_FRAMES, f"{name}: K2 launches {counts}")
        if name == "blob":
            require(counts["mesh_bvh_v2p"] >= MESH_FRAMES, f"blob: K4 launches {counts}")
        else:
            require(counts["mesh_binned_phase1"] >= MESH_FRAMES
                    and counts["mesh_binned_pair"] >= MESH_FRAMES,
                    f"statue: K5/K6 launches {counts}")
        for rec_ in records:
            require(rec_["finite"], f"{name} frame {rec_['frame']} finite")
            img = read_png(rec_["path"])
            require(img.shape == (h0, w0, 3) and img.std() > 0, f"{name} PNG decodes")
        g0 = np.load(records[0]["path"][:-len(".png")] + "_gbuffer.npy")
        require(g0.shape == (10, h0, w0) and np.isfinite(g0).all(), f"{name} G-buffer")
        mesh_pixels = float((np.abs(g0[6] - box_depth) > 1e-3).mean())
        require(mesh_pixels > 0.01, f"{name}: mesh visible in the depth channel")
        emit({"phase": "mesh_path", "scene": name,
              "faces": mesh_scenes[name].mesh.num_faces,
              "bins": mesh_scenes[name].mesh.bvh.n_supers_real, "res": [w0, h0],
              "depth": mesh_scenes[name].trace_depth, "frames": MESH_FRAMES,
              "launches": counts, "binned_calls": paths, "card": smi,
              "depth_pixels_differing_from_cornell_box": mesh_pixels,
              "per_frame_ms": [{k: round(v, 3) for k, v in rec_.items()
                                if k.endswith("_ms")} for rec_ in records],
              "median_after_warmup_ms": {
                  k: statistics.median(r[k] for r in records[1:])
                  for k in ("render_ms", "denoise_ms", "total_ms")}})

    # ---- 9. mesh kernel timing at the frame's shapes ----
    # Every call of one frame (all bounces) is timed alone; "frame_ms" sums
    # them.  K4 at the blob's frame (its main path), K5 and K6 at the
    # statue's: CUDA events around 5 calls back to back ("ms").  K5 and K6
    # also as device time ("device_ms": 5 calls captured in a CUDA graph and
    # replayed), since a call of K5 can take less time on the card than the
    # wrapper takes on the host.  The plain version is timed on the same
    # calls, once each, whole.
    def time_calls(fn, calls, reps=5):
        return [time_ms(lambda a=a: fn(*a), reps, warmup=1) for a in calls]

    def device_calls(fn, calls, reps=5):
        return [graph_ms(lambda a=a: fn(*a), reps) for a in calls]

    def plain_calls(fn, calls):
        return [wall_ms(lambda a=a: fn(*a))[1] for a in calls]

    mesh_rows = {}
    blob_calls = recorded["blob"]["v2p"]["v2p"]
    ms4 = time_calls(mesh_kernel_v2p.mesh_intersect_bvh_v2p, blob_calls)
    bound4 = []
    for args in blob_calls:
        bvh_, o, d, tc = args[:4]
        nb, face_tests, node_tests = mesh_kernel_v2p.traversal_work(bvh_, o, d, tc)
        bound4.append((nb, face_tests * OPS_TRIANGLE + node_tests * OPS_AABB))
    plain4 = plain_calls(plain_v2p, [a[:4] for a in blob_calls])
    mesh_rows["mesh_bvh_v2p"] = (ms4, bound4, plain4, {})
    st = recorded["statue"]["binned"]
    bound5 = []
    for o, d, tc, bounds, kb_, skip, c_out in st["phase1"]:
        nb, slab_tests = mesh_binned.phase1_work(tc, kb_, c_out)
        bound5.append((nb, slab_tests * OPS_AABB))
    mesh_rows["mesh_binned_phase1"] = (
        time_calls(mesh_binned._phase1, st["phase1"]), bound5,
        plain_calls(mesh_binned._phase1_plain, st["phase1"]),
        {"per_launch_device_ms": device_calls(mesh_binned._phase1, st["phase1"]),
         "per_launch_rays": [a[2].shape[0] for a in st["phase1"]],
         "per_launch_live_rays": [int((a[2] > float("-inf")).sum()) for a in st["phase1"]]})
    bound6 = []
    for o, d, key, faces, kb_ in st["pair"]:
        nb, face_tests = mesh_binned.pair_work(key, kb_, faces.shape[0])
        bound6.append((nb, face_tests * OPS_TRIANGLE))
    mesh_rows["mesh_binned_pair"] = (
        time_calls(mesh_binned._pair_call, st["pair"]), bound6,
        plain_calls(mesh_binned._pair_plain, st["pair"]),
        {"per_launch_device_ms": device_calls(mesh_binned._pair_call, st["pair"]),
         "per_launch_pairs": [a[2].shape[0] for a in st["pair"]],
         "per_launch_live_pairs": [int(((a[2] >= 0) & (a[2] < a[4])).sum())
                                   for a in st["pair"]]})
    mesh_summary = {}
    for kname, (ms_list, work, plain_list, extra) in mesh_rows.items():
        bounds_ms = [bound_ms(nb, ops, FP32_FLOPS) for nb, ops in work]
        t_bytes = sum(nb for nb, _ in work) / HBM_BPS
        t_ops = sum(ops for _, ops in work) / FP32_FLOPS
        mesh_summary[kname] = {
            "ms": sum(ms_list), "bound_ms": sum(b for b, _ in bounds_ms),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "plain_ms": sum(plain_list)}
        if extra:
            mesh_summary[kname]["device_ms"] = sum(extra["per_launch_device_ms"])
        emit({"phase": "mesh_timing", "kernel": kname, "card": smi,
              "scene": "blob" if kname == "mesh_bvh_v2p" else "statue",
              "timed_as": "CUDA events around 5 calls" + (
                  "; device_ms: 5 calls in a CUDA graph" if extra else ""),
              "launches_per_frame": len(ms_list), "per_launch_ms": ms_list,
              "frame_ms": sum(ms_list), **extra,
              **({"frame_device_ms": sum(extra["per_launch_device_ms"])} if extra else {}),
              "per_launch_bound_ms": [b for b, _ in bounds_ms],
              "per_launch_bound_by": [by for _, by in bounds_ms],
              "frame_bound_ms": sum(b for b, _ in bounds_ms),
              "frame_bytes": sum(nb for nb, _ in work),
              "frame_ops": sum(ops for _, ops in work),
              "per_launch_plain_ms": plain_list, "frame_plain_ms": sum(plain_list),
              "plain_at": "the same calls as the kernel, whole, once each",
              "library_ms": None})

    # ---- 10. where a mesh frame's time goes, and the routing rule ----
    # Per scene: the whole intersection call of every bounce (kernels, sorts,
    # gathers and, on the binned side, the host's read of `fits`) and the
    # whole frame, each as elapsed time between CUDA events and as the
    # card's busy time in it (the profiler's sum of kernel times); and the
    # frame under the other BVH intersection than the router's choice.
    for name, sc in mesh_scenes.items():
        routed = "v2p" if name == "blob" else "binned"
        whole = recorded[name][routed][routed]
        fn = (mesh_kernel_v2p.mesh_intersect_bvh_v2p if routed == "v2p"
              else mesh_binned.mesh_intersect_binned)

        def all_bounces():
            for a in whole:
                fn(*a[:4])

        frame = {impl: time_ms(lambda o_=RenderOptions(mesh_kernel_impl=impl):
                               render_gbuffer_frame(sc, o_), 3, warmup=1)
                 for impl in ("auto", "v2p", "binned")}
        auto_opts = RenderOptions()
        emit({"phase": "mesh_frame_breakdown", "scene": name, "routed_to": routed,
              "card": smi, "frame_render_ms": frame,
              "frame_device_busy_ms": busy_ms(lambda: render_gbuffer_frame(sc, auto_opts)),
              "mesh_intersection_calls_ms": time_ms(all_bounces, 3, warmup=1),
              "mesh_intersection_device_busy_ms": busy_ms(all_bounces),
              "mesh_kernels_ms": (mesh_summary["mesh_bvh_v2p"]["ms"] if name == "blob"
                                  else mesh_summary["mesh_binned_phase1"]["ms"]
                                  + mesh_summary["mesh_binned_pair"]["ms"]),
              "host_reads_of_fits_per_frame": len(whole) if routed == "binned" else 0})

    # ---- 10b. coincident faces in different clusters: exact ties in t ----
    # 128 faces kept in file order, four clusters of small faces near the
    # origin.  Cluster 2 repeats faces 0..30 of cluster 0 with other
    # materials, so every hit of one ties with the other's, and its last face
    # is a sliver across the whole scene, so its box holds every ray origin:
    # the front-to-back walk enters it at distance 0 and visits it BEFORE
    # cluster 0, and only the cluster-index tie-break keeps the dense scan's
    # first minimal face.  Rays start on a sphere around the soup, aimed at
    # the repeated faces.
    rng = np.random.default_rng(7)

    def blob(center):
        c = np.asarray(center) + rng.uniform(-0.3, 0.3, (32, 1, 3))
        return (c + rng.uniform(-0.15, 0.15, (32, 3, 3))).astype(np.float32)

    tri = [blob((0, 0, 0)), blob((0.3, 0, 0)), None, blob((0, 0.4, 0))]
    tri[2] = tri[0].copy()
    tri[2][31] = np.array([[-5, -5, -5], [5, 5, 5], [5, 5, 5.001]], np.float32)
    tri = np.concatenate(tri)
    nrm = rng.normal(size=(128, 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[64:95] = nrm[0:31]
    mats = rng.integers(0, 5, 128).astype(np.int32)
    mats[64:95] = (mats[0:31] + 1) % 5
    tie_bvh = mesh_bvh.build_mesh_bvh(tri, nrm, mats, reorder=False)[0].to(dev)
    rest_bvh = mesh_bvh.build_mesh_bvh(tri[32:], nrm[32:], mats[32:], reorder=False)[0].to(dev)
    n_tie = 200_037                                  # a ragged tail for every tile size
    to = rng.normal(size=(3, n_tie))
    to = (3.5 * to / np.linalg.norm(to, axis=0, keepdims=True)).astype(np.float32)
    bary = rng.dirichlet(np.ones(3), n_tie).astype(np.float32)
    td = np.einsum("nc,ncx->nx", bary, tri[rng.integers(0, 31, n_tie)]).T - to
    td = (td / np.linalg.norm(td, axis=0, keepdims=True)).astype(np.float32)
    to, td = torch.from_numpy(to).to(dev), torch.from_numpy(td).to(dev)
    ttc = torch.full((n_tie,), float("inf"), device=dev)
    ttc[::5] = float("-inf")
    ttc[1::7] = torch.from_numpy(rng.uniform(0.5, 8.0, n_tie).astype(np.float32)).to(dev)[1::7]
    to, td = Vec3(*to), Vec3(*td)
    want = plain_v2p(tie_bvh, to, td, ttc)
    k4 = flat_hit(mesh_kernel_v2p.mesh_intersect_bvh_v2p(tie_bvh, to, td, ttc))
    # without cluster 0 the same t but the copy's material: a tie that the
    # smaller cluster index won
    rest = plain_v2p(rest_bvh, to, td, ttc)
    tied = int((torch.isfinite(want[0]) & (rest[0] == want[0]) & (rest[7] != want[7])).sum())
    face_rows = tie_bvh.faces_packed[:, :9]
    require(torch.equal(face_rows[:31], face_rows[64:95]) and all_equal(k4, want)
            and tied > n_tie // 10, f"the tie call: {tied} rays tie between clusters 0 and 2")
    check_traversals({"scene": "coincident clusters 0 and 2", "bounce": None,
                      "tied_rays": tied}, tie_bvh, to, td, ttc, want, k4)

    # ---- 10c. the traversal experiment path: interactive with v2 and v3 ----
    # `interactive` on the blob with each traversal, carry-sorted and not;
    # counts set to 0 just before each run and read just after.  Every frame
    # takes 8 intersection calls (depth 8), all through the chosen kernel, and
    # queries its geoms through K10 at each.
    impl_kernel = {"v2p": "mesh_bvh_v2p", "v2": "mesh_bvh_v2", "v3": "mesh_bvh_v3"}
    impl_frames = {}
    impl_counts = {}
    for sort_flag in ("--mesh-octant-sort", "--no-mesh-octant-sort"):
        for impl in ("v2p", "v2", "v3"):
            reset_counts()
            out_dir = os.path.join(OUT_DIR, f"frames_blob_{impl}_{sort_flag.strip('-')}")
            recs = cli.main(["interactive", MESH_SCENES["blob"], "--frames", str(IMPL_FRAMES),
                             "--model", MODEL, "--out-dir", out_dir, "--save-arrays",
                             "--mesh-kernel-impl", impl, sort_flag])
            counts = launch_counts()
            stems = [r_["path"][:-len(".png")] for r_ in recs]
            frames = [(np.load(st_ + "_gbuffer.npy"), np.load(st_ + "_denoised.npy"))
                      for st_ in stems]
            impl_frames[impl, sort_flag] = frames
            impl_counts[impl, sort_flag] = counts
            expect = {impl_kernel[impl]: 8 * IMPL_FRAMES, "conv3x3_act": 28 * IMPL_FRAMES,
                      "geom_intersect": 8 * IMPL_FRAMES}
            require({k: v for k, v in counts.items() if v} == expect,
                    f"{impl} {sort_flag}: launches {counts}, expected only {expect}")
            require(all(r_["finite"] for r_ in recs), f"{impl} {sort_flag}: frames finite")
            equal = all(np.array_equal(a, b) for fa, fb in
                        zip(frames, impl_frames["v2p", sort_flag]) for a, b in zip(fa, fb))
            require(equal, f"{impl} {sort_flag}: frames differ from the per-ray traversal's")
            emit({"phase": "mesh_impl_path", "scene": "blob", "impl": impl,
                  "flag": sort_flag, "res": [w0, h0], "frames": IMPL_FRAMES, "card": smi,
                  "launches": {k: v for k, v in counts.items() if v},
                  "gbuffer_and_denoised_equal_to_v2p_bitwise": equal,
                  "per_frame_ms": [{k: round(v, 3) for k, v in r_.items() if k.endswith("_ms")}
                                   for r_ in recs]})
    sorted_equal = all(np.array_equal(a, b) for fa, fb in
                       zip(impl_frames["v2p", "--mesh-octant-sort"],
                           impl_frames["v2p", "--no-mesh-octant-sort"]) for a, b in zip(fa, fb))
    require(sorted_equal, "the carry sort changed the frames")

    # ---- 10d. the bench command, and render with the three wavefront options ----
    bench_ms = {}
    for scene_name, path, impls in (("cornell_box", SCENE, (None,)),
                                    ("blob", MESH_SCENES["blob"], ("auto", "v2p", "v2", "v3", "binned")),
                                    ("statue", MESH_SCENES["statue"], ("auto", "v2p", "v2", "v3", "binned"))):
        for impl in impls:
            reset_counts()
            argv = ["bench", path, "--iters", str(BENCH_ITERS[scene_name])]
            out = cli.main(argv + (["--mesh-kernel-impl", impl] if impl else []))
            counts = {k: v for k, v in launch_counts().items() if v}
            bench_ms[f"{scene_name}:{impl or 'megakernel'}"] = out[os.path.basename(path)]
            if impl is None:     # warm-up (2 iterations) + the timed 64: one launch each
                require(counts == {"render_megakernel": 2}, f"bench cornell launches {counts}")
            else:
                routed = impl if impl != "auto" else ("v2p" if scene_name == "blob" else "binned")
                expect = ({"mesh_binned_phase1", "mesh_binned_pair"} if routed == "binned"
                          else {impl_kernel[routed]}) | {"geom_intersect"}
                # the binned pipeline's fallback, if a bounce takes it, is the per-ray kernel
                allowed = expect | ({"mesh_bvh_v2p"} if routed == "binned" else set())
                require(expect <= set(counts) <= allowed,
                        f"bench {scene_name} {impl}: launches {counts}")
    emit({"phase": "bench_path", "card": smi, "res": [w0, h0], "iters": BENCH_ITERS,
          "ms_for_all_iterations": bench_ms,
          "note": "host clock around render(), the device drained before and after"})

    plain_opts = RenderOptions(backend="xla", antialias=False)
    reset_counts()
    img_plain, g_plain, _ = render(base, plain_opts, num_iterations=3)
    img_opt, g_opt, st_opt = render(base, RenderOptions(antialias=False, sort_material=True,
                                                        cache_first_bounce=True),
                                    num_iterations=3)
    img_mb, g_mb, st_mb = render(base, RenderOptions(motion_blur=True, sort_material=True),
                                 num_iterations=8)
    require({k for k, v in launch_counts().items() if v} == {"geom_intersect"},
            "the three options render through the plain wavefront (its geoms through K10)")
    require(torch.equal(g_opt, g_plain) and st_opt.cache is not None,
            "sort_material + cache_first_bounce changed the render")
    require(bool(torch.isfinite(g_mb).all()) and st_mb.geoms is not None
            and not torch.equal(st_mb.geoms.transform, base.geoms.transform),
            "motion blur: finite, geoms moved")
    opt_png = os.path.join(OUT_DIR, "render_options.png")
    cli.main(["render", SCENE, "--spp", "3", "--no-antialias", "--sort-material",
              "--cache-first-bounce", "--out", opt_png])
    want_png = save_png_scaled(os.path.join(OUT_DIR, "render_plain.png"),
                               img_plain.flip(1).cpu().numpy())
    mb_png = os.path.join(OUT_DIR, "render_motion_blur.png")
    cli.main(["render", SCENE, "--spp", "8", "--motion-blur", "--sort-material", "--out", mb_png])
    mb_img = read_png(mb_png)
    require(np.array_equal(read_png(opt_png), read_png(want_png)),
            "render --sort-material --cache-first-bounce: PNG differs from the plain render's")
    require(mb_img.shape == (h0, w0, 3) and mb_img.std() > 0, "render --motion-blur PNG")
    emit({"phase": "render_options", "card": smi, "res": [w0, h0],
          "sort_material_and_cache_equal_plain_bitwise": True,
          "motion_blur_finite": True,
          "motion_blur_vs_static_mean_abs_diff": float((img_mb - render(
              base, RenderOptions(backend="xla"), num_iterations=8)[0]).abs().mean())})

    # ---- 10e. the three traversals side by side ----
    # Every call of one frame (all bounces), recorded from a carry-sorted
    # frame (the default) and from an unsorted one, timed alone through each
    # kernel: events around 3 calls back to back ("per_launch_ms") and device
    # time, 3 calls in a CUDA graph ("per_launch_device_ms"); ms per frame
    # beside the bound of the work the rays need (`traversal_work`: the same
    # for every traversal) and what a thread-per-ray warp would issue for it
    # (`traversal_warp_work`), and the tile kernels' visits per frame.  K4
    # is held to its plain version on every call, and its witness builds
    # (K4_WITNESSES: each cluster worked one way only) to K4; K7 and K8 to
    # K4 on every call.
    traversal_fns = {
        "mesh_bvh_v2p": lambda b, o, d, tc: mesh_kernel_v2p.mesh_intersect_bvh_v2p(b, o, d, tc),
        "mesh_bvh_v2@128": lambda b, o, d, tc, **kw: mesh_kernel.mesh_intersect_bvh(
            b, o, d, tc, 128, **kw),
        "mesh_bvh_v2@1024": lambda b, o, d, tc, **kw: mesh_kernel.mesh_intersect_bvh(
            b, o, d, tc, 1024, **kw),
        "mesh_bvh_v3": lambda b, o, d, tc, **kw: mesh_kernel_v3.mesh_intersect_bvh_v3(
            b, o, d, tc, **kw)}
    tile_fns = {k: fn for k, fn in traversal_fns.items() if k != "mesh_bvh_v2p"}

    def frame_visits(fn, calls):
        """(outputs, visits summed over the calls) of one frame through ``fn``."""
        outs, total = [], 0
        for a in calls:
            out, visits = counted(lambda c: flat_hit(fn(*a, visit_counter=c)))
            outs.append(out)
            total += visits
        return outs, total

    impl_timing, impl_device, impl_visits, per_launch_by_frame = {}, {}, {}, {}
    for name, sc in mesh_scenes.items():
        for order in ("sorted", "unsorted"):
            calls = [a[:4] for a in (recorded[name]["v2p"]["v2p"] if order == "sorted" else
                                     record_frame(sc, "v2p", mesh_octant_sort=False)["v2p"])]
            # K4 against its plain version on every call of the frame: whole,
            # except the statue's calls past bounce 1 (their first
            # STATUE_SLICE rays; the dense scan takes 17 s per whole call)
            # and its sorted bounces 0-1, held whole in phase 7
            k4_out = [flat_hit(mesh_kernel_v2p.mesh_intersect_bvh_v2p(*a)) for a in calls]
            equal = []
            for b, (a, got) in enumerate(zip(calls, k4_out)):
                if name == "statue" and order == "sorted" and b < 2:
                    continue
                sl = slice(0, None if name == "blob" or b < 2 else STATUE_SLICE)
                want = plain_v2p(a[0], *subset(a[1:], sl))
                equal.append(all_equal(subset(got, sl), want))
                mesh_err["mesh_bvh_v2p"] = max(mesh_err["mesh_bvh_v2p"],
                                               max_abs_diff(subset(got, sl), want))
            witnesses_equal = {}
            for k_thr, kern in k4_witnesses.items():
                with k4_sweep.launching(kern):
                    witnesses_equal[k_thr] = all(all_equal(flat_hit(
                        mesh_kernel_v2p.mesh_intersect_bvh_v2p(*a)), got)
                        for a, got in zip(calls, k4_out))
            emit({"phase": "mesh_v2p_frame_check", "scene": name,
                  "rays_carry_sorted": order == "sorted", "card": smi,
                  "calls_equal_to_plain": equal, "witnesses_equal_to_k4": witnesses_equal,
                  "k_thr": mesh_kernel_v2p.K_THR,
                  "bar": "t, point, normal, material equal bit for bit (torch.equal) to "
                         "the dense scan on every call (the statue's past bounce 1 on "
                         f"rays [0, {STATUE_SLICE})); K4 at each K_THR of K4_WITNESSES "
                         "equal to K4"})
            require(all(equal) and all(witnesses_equal.values()),
                    f"K4 on the {order} {name} frame")
            # K7 and K8 against K4 (which equals the dense scan) on every call
            tile_equal, visits = {}, {}
            for tname, fn in tile_fns.items():
                outs, visits[tname] = frame_visits(fn, calls)
                tile_equal[tname] = all(all_equal(g, w) for g, w in zip(outs, k4_out))
            impl_visits[name, order] = visits
            emit({"phase": "mesh_tile_frame_check", "scene": name,
                  "rays_carry_sorted": order == "sorted", "card": smi,
                  "visits_per_frame": visits, "equal_to_k4": tile_equal,
                  "bar": "K7 at 128 and 1024 lanes and K8 equal to K4 bit for bit "
                         "(torch.equal) on every call of the frame"})
            require(all(tile_equal.values()), f"K7 / K8 on the {order} {name} frame: {tile_equal}")
            work = [mesh_kernel_v2p.traversal_work(*a) for a in calls]
            warp = [mesh_kernel_v2p.traversal_warp_work(*a) for a in calls]
            per_warp = [mesh_kernel_v2p.warp_live_clusters(*a) for a in calls]
            bounds = [bound_ms(nb, ft * OPS_TRIANGLE + nt * OPS_AABB, FP32_FLOPS)
                      for nb, ft, nt in work]
            sums = [sum(w_[k] for w_ in work) for k in (1, 2)]
            unions = [sum(w_[k] for w_ in warp) for k in (1, 2)]
            per_kernel = {k: time_calls(fn, calls, reps=3) for k, fn in traversal_fns.items()}
            per_device = {k: device_calls(fn, calls, reps=3) for k, fn in traversal_fns.items()}
            per_launch_by_frame[name, order] = per_kernel
            impl_timing[name, order] = {k: sum(v) for k, v in per_kernel.items()}
            impl_device[name, order] = {k: sum(v) for k, v in per_device.items()}
            emit({"phase": "mesh_impl_timing", "scene": name, "rays_carry_sorted": order == "sorted",
                  "card": smi, "launches_per_frame": len(calls),
                  "frame_ms": impl_timing[name, order], "per_launch_ms": per_kernel,
                  "frame_device_ms": impl_device[name, order],
                  "per_launch_device_ms": per_device,
                  "visits_per_frame": impl_visits[name, order],
                  "frame_bound_ms": sum(b for b, _ in bounds),
                  "bound_by": sorted({by for _, by in bounds}),
                  "frame_face_tests": sums[0], "frame_node_tests": sums[1],
                  # what a thread-per-ray warp issues: the union over each
                  # 32 consecutive rays (traversal_warp_work); sum / union
                  # is that kernel's SIMT efficiency
                  "frame_face_tests_warp_union": unions[0],
                  "frame_node_tests_warp_union": unions[1],
                  "simt_efficiency_faces": sums[0] / max(unions[0], 1),
                  "simt_efficiency_nodes": sums[1] / max(unions[1], 1),
                  "simt_efficiency_ops": (sums[0] * OPS_TRIANGLE + sums[1] * OPS_AABB)
                  / max(unions[0] * OPS_TRIANGLE + unions[1] * OPS_AABB, 1),
                  "live_rays_per_launch": [int((a[3] > float("-inf")).sum()) for a in calls],
                  # the warps' spread: clusters that one of a warp's rays is
                  # live in, heaviest warp and mean warp of each launch
                  "warp_live_clusters_max": [int(w_.max()) for w_ in per_warp],
                  "warp_live_clusters_mean": [float(w_.double().mean()) for w_ in per_warp]})

    # ---- 10f. the visit-cost probe: K9a and K9b ----
    # Each launch splits the visits over the card (S blocks, merged in range
    # order); every launch here also counts the visits its kernel ran.
    probe_t0 = time.time()
    p_rays, p_faces, p_coeffs = mm_feasibility.probe_inputs(0, dev)
    visits_run = torch.zeros(1, dtype=torch.int32, device=dev)
    probe_modes = {"scalar": None, "tf32": False, "3xtf32": True}

    def probe_run(mode, n_visits, **shape):
        """One launch of ``mode``'s kernel through its wrapper."""
        highest = probe_modes[mode]
        if highest is None:
            return mm_feasibility.visit_vpu(p_rays, p_faces, n_visits, **shape)
        return mm_feasibility.visit_mma(p_rays, p_coeffs, n_visits, highest, **shape)

    def probe_launch(mode, n_visits, **shape):
        """``probe_run``, failing unless the kernel ran every visit."""
        out = probe_run(mode, n_visits, visit_counter=visits_run, **shape)
        require(int(visits_run.item()) == n_visits,
                f"{mode} kernel ran {int(visits_run.item())} of {n_visits} visits")
        return out

    probe_splits = {m: mm_feasibility.default_splits(dev, h) for m, h in probe_modes.items()}
    vpu_got = probe_launch("scalar", PROBE_VISITS)
    vpu_want, vpu_plain_ms = wall_ms(lambda: mm_feasibility.visit_vpu_plain(p_rays, p_faces))
    vpu_err = max_abs_diff([vpu_got], [vpu_want])
    require(torch.equal(vpu_got, vpu_want) and int((vpu_want[0] < 1e38).sum()) > 500,
            f"scalar visit kernel vs plain: max abs err {vpu_err}")

    def visit_mismatches(got, want):
        """Rays whose t misses |k - p| <= 1e-5 |p| + 1e-5, and rays whose face differs."""
        bad = (got[0] - want[0]).abs() > 1e-5 * want[0].abs() + 1e-5
        return int(bad.sum()), int((got[1] != want[1]).sum())

    mma = {}
    for mode, precision in (("tf32", "tf32"), ("3xtf32", "float32")):
        got = probe_launch(mode, PROBE_VISITS)
        want, plain_ms = wall_ms(lambda: mm_feasibility.visit_mma_plain(
            p_rays, p_coeffs, precision=precision))
        bad_t, bad_face = visit_mismatches(got, want)
        mma[mode] = {"t_mismatches": bad_t, "face_mismatches": bad_face, "plain_ms": plain_ms,
                     "max_abs_err": max_abs_diff([got[0]], [want[0]]),
                     "hits": int((want[0] < 1e38).sum())}
        require(bad_t + bad_face <= 10 and bool((got[2:] == 0).all()) and mma[mode]["hits"] > 500,
                f"tensor-core visit kernel ({mode}) vs plain: {mma[mode]}")
    # one block on one SM against the shipped split, bit for bit
    for mode in probe_modes:
        for n_visits in (200, PROBE_VISITS):
            require(torch.equal(probe_launch(mode, n_visits, splits=1),
                                probe_launch(mode, n_visits)),
                    f"{mode} kernel: one block and {probe_splits[mode]} blocks differ at "
                    f"{n_visits} visits")
    # what one TF32 product loses against float32: a finding, not a check
    tf32_vs_f32 = visit_mismatches(probe_launch("tf32", 64),
                                   mm_feasibility.visit_mma_plain(p_rays, p_coeffs))
    emit({"phase": "mm_feasibility_check", "rays": 1024, "visits": PROBE_VISITS,
          "scalar_kernel_bitwise_equal": True, "scalar_hits": int((vpu_want[0] < 1e38).sum()),
          "tensor_core_kernel": mma, "splits": probe_splits,
          "one_block_equals_split_bitwise_at_visits": [200, PROBE_VISITS],
          "every_launch_ran_every_visit": True,
          "tf32_kernel_vs_float32_plain": {"t_mismatches": tf32_vs_f32[0],
                                           "face_mismatches": tf32_vs_f32[1]},
          "tolerance": "scalar kernel: the (8, 1024) state equal bit for bit.  Tensor-core "
                       "kernel: |t_k - t_p| <= 1e-5 |t_p| + 1e-5 and equal face ids on all "
                       "but at most 10 of 1024 rays (a comparison next to its threshold may "
                       "fall the other way); the TF32 mode against the plain version with "
                       "both operands rounded to TF32, the 3xTF32 mode against the float32 "
                       "plain version.  Each kernel at one block and at the shipped split: "
                       "equal bit for bit.  The winning t = tn / den has tn close to 0 by "
                       "cancellation, so one TF32 product against float32 is reported, "
                       "not held to a bar"})
    reset_counts()
    probe = mm_feasibility.main(["--visits", str(PROBE_VISITS)])
    probe_counts = {k: v for k, v in launch_counts().items() if v}
    # timed(): one warm-up call + 5; the tensor-core kernel in both modes
    require(probe_counts == {"mm_visit_vpu": 6, "mm_visit_mma": 12}, f"probe launches {probe_counts}")
    probe_ms, probe_device_ms, one_sm = {}, {}, {}
    for mode in probe_modes:
        run = (lambda m=mode: probe_run(m, PROBE_VISITS))
        probe_ms[mode] = time_ms(run, 3, warmup=1)
        probe_device_ms[mode] = graph_ms(run, 3)
        one_sm[mode] = graph_ms(lambda m=mode: probe_run(m, PROBE_ONE_SM_VISITS, splits=1), 1)
    io_bytes = 4 * (2 * 8 * 1024)
    # the face tests without their edges, which are formed once per staged face
    vpu_bound = bound_ms(io_bytes + 4 * p_faces.numel(),
                         PROBE_VISITS * 32 * (1024 * (OPS_TRIANGLE - OPS_EDGES) + OPS_EDGES),
                         FP32_FLOPS)
    mm_flops = PROBE_VISITS * 2 * 128 * 16 * 1024
    test_ops = PROBE_VISITS * 32 * 1024 * OPS_VISIT_TEST
    # 3xTF32 is three TF32 products; the tensor cores and the float32 pipes
    # run at once, so the least time is the larger of the two, not their sum
    mma_bound = {mode: max((io_bytes + 4 * p_coeffs.numel()) / HBM_BPS,
                           products * mm_flops / TF32_FLOPS, test_ops / FP32_FLOPS) * 1e3
                 for mode, products in (("tf32", 1), ("3xtf32", 3))}
    emit({"phase": "mm_feasibility", "card": smi, "visits": PROBE_VISITS,
          "launches_by_the_tool": probe_counts, "tool_results": probe,
          "splits": probe_splits,
          "us_per_visit": {m: v / PROBE_VISITS * 1e3 for m, v in probe_device_ms.items()},
          "device_ms": probe_device_ms, "events_ms": probe_ms,
          "one_sm": {"visits": PROBE_ONE_SM_VISITS, "device_ms": one_sm,
                     "us_per_visit": {m: v / PROBE_ONE_SM_VISITS * 1e3
                                      for m, v in one_sm.items()}},
          "bound_ms": {"scalar": vpu_bound[0], **mma_bound},
          "bound_by": "operations", "phase_seconds": time.time() - probe_t0,
          "timing": "device_ms: launches captured in a CUDA graph and replayed; events_ms: "
                    "CUDA events around launches through the wrapper back to back; "
                    "us_per_visit from device_ms"})

    # ---- 10g. the command-line slice: serving, render outputs, variants,
    # streamed training, padded channels ----
    phase_serve_path(cli, kernels, smi, dev)
    phase_render_outputs(cli, kernels, smi, dev)
    phase_variants_stream_path(cli, kernels, smi, dev)
    phase_pad_channels(kernels, smi, dev)
    phase_edge_grad_path(kernels, smi, dev)
    par_launches = phase_parallel_path(cli, kernels, smi, dev, {
        "train_dir": train_dir, "data_dir": data_dir, "fixed_x": fixed_x, "fixed_y": fixed_y,
        "state": state, "topt": topt, "mopt": mopt})
    campaign_launches = phase_campaign_path(kernels, smi, dev)

    # ---- 11. the card's busy time in one train step (profiler), last ----
    step_busy = busy_ms(lambda: trainer.train_step(state, fixed_x, fixed_y, topt, mopt))
    emit({"phase": "train_step_busy", "card": smi, "device_busy_ms_in_one_step": step_busy,
          "step_ms_median_after_first": step_median,
          "device_idle_share": max(0.0, 1.0 - step_busy / step_median),
          "note": "busy = the profiler's sum of kernel times over one step; the "
                  "profiler slows the host, so busy can exceed the unprofiled step"})
    del fixed_x, fixed_y, state

    # ---- 12. summary ----
    summary = {"kernels": [
        {"name": "render_megakernel", "route": "cuda",
         "source": "ai_path_tracer_denoiser_tpu_torch/csrc/render_megakernel.cu",
         "replaces": "ai_path_tracer_denoiser_tpu/render/pallas_backend.py:588",
         "launches": launches["render_megakernel"], "max_abs_err": k1_err,
         "ms": k1_ms, "device_ms": k1_device_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "lane_efficiency": k1_shapes["cornell_800_niter1"]["kernel"]["lane_efficiency"],
         "datagen_launch": {"res": 512, "niter": dg["niter"], "ms": dg["events_ms"],
                            "device_ms": dg["device_ms"], "bound_ms": dg_bound[0],
                            "lane_efficiency": dg["kernel"]["lane_efficiency"]}},
        {"name": "conv3x3_act", "route": "cuda",
         "source": "ai_path_tracer_denoiser_tpu_torch/csrc/conv3x3_act.cu",
         "replaces": "ai_path_tracer_denoiser_tpu/models/conv_kernel.py:287",
         "launches": launches["conv3x3_act"], "max_abs_err": k2_err,
         "ms": conv_sum["ms"], "call_ms": conv_sum["call_ms"], "plain_ms": conv_sum["plain_ms"],
         "bound_ms": conv_sum["bound_ms"], "bound_by": conv_bound_by,
         "library_ms": conv_sum["library_ms"], **k2_train},
        {"name": "conv3x3_rows", "route": "cuda",
         "source": "ai_path_tracer_denoiser_tpu_torch/csrc/conv3x3_rows.cu",
         "replaces": "ai_path_tracer_denoiser_tpu/models/conv_kernel.py:120",
         "launches": rows_launches, "max_abs_err": k3_err,
         "ms": conv_sum["rows_ms"], "call_ms": conv_sum["rows_call_ms"],
         "plain_ms": conv_sum["rows_plain_ms"],
         "bound_ms": conv_sum["bound_ms"], "bound_by": conv_bound_by,
         "library_ms": conv_sum["library_ms"]},
    ] + [
        {"name": kname, "route": "cuda",
         "source": f"ai_path_tracer_denoiser_tpu_torch/csrc/{kname}.cu",
         "replaces": replaces, "launches": mesh_launches[scene_][kname],
         "max_abs_err": mesh_err[kname], **mesh_summary[kname], "library_ms": None,
         **({"frame_ms_by_scene_and_order": {f"{sc_}:{order}": t["mesh_bvh_v2p"]
                                             for (sc_, order), t in impl_timing.items()}}
            if kname == "mesh_bvh_v2p" else {})}
        for kname, replaces, scene_ in (
            ("mesh_bvh_v2p",
             "ai_path_tracer_denoiser_tpu/render/mesh_kernel_v2p.py:228", "blob"),
            ("mesh_binned_phase1",
             "ai_path_tracer_denoiser_tpu/render/mesh_binned.py:222", "statue"),
            ("mesh_binned_pair",
             "ai_path_tracer_denoiser_tpu/render/mesh_binned.py:356", "statue"))
    ] + [
        # the traversal experiment path: interactive on the blob, carry-sorted;
        # ms and bound per frame on its recorded calls, plain_ms the dense scan
        # on those calls
        {"name": kname, "route": "cuda",
         "source": f"ai_path_tracer_denoiser_tpu_torch/csrc/{kname}.cu",
         "replaces": replaces, "launches": impl_counts[impl, "--mesh-octant-sort"][kname],
         "max_abs_err": mesh_err[kname], "ms": impl_timing["blob", "sorted"][timed_as],
         "device_ms": impl_device["blob", "sorted"][timed_as],
         "per_launch_ms": per_launch_by_frame["blob", "sorted"][timed_as],
         "visits_per_frame": impl_visits["blob", "sorted"][timed_as],
         "plain_ms": mesh_summary["mesh_bvh_v2p"]["plain_ms"],
         "bound_ms": mesh_summary["mesh_bvh_v2p"]["bound_ms"],
         "bound_by": mesh_summary["mesh_bvh_v2p"]["bound_by"], "library_ms": None,
         "frame_ms_by_scene_and_order": {
             f"{sc_}:{order}": {k: v for k, v in t.items() if k.startswith(kname)}
             for (sc_, order), t in impl_timing.items()},
         "frame_device_ms_by_scene_and_order": {
             f"{sc_}:{order}": {k: v for k, v in t.items() if k.startswith(kname)}
             for (sc_, order), t in impl_device.items()},
         "visits_per_frame_by_scene_and_order": {
             f"{sc_}:{order}": {k: v for k, v in t.items() if k.startswith(kname)}
             for (sc_, order), t in impl_visits.items()}}
        for kname, replaces, impl, timed_as in (
            ("mesh_bvh_v2", "ai_path_tracer_denoiser_tpu/render/mesh_kernel.py:199", "v2",
             "mesh_bvh_v2@1024"),
            ("mesh_bvh_v3", "ai_path_tracer_denoiser_tpu/render/mesh_kernel_v3.py:356", "v3",
             "mesh_bvh_v3"))
    ] + [
        {"name": "mm_visit_vpu", "route": "cuda",
         "source": "ai_path_tracer_denoiser_tpu_torch/csrc/mm_visit_vpu.cu",
         "replaces": "tools/exp_mm_feasibility.py:180", "launches": probe_counts["mm_visit_vpu"],
         "max_abs_err": vpu_err, "ms": probe_ms["scalar"],
         "device_ms": probe_device_ms["scalar"], "plain_ms": vpu_plain_ms,
         "bound_ms": vpu_bound[0], "bound_by": vpu_bound[1], "library_ms": None,
         "visits_per_launch": PROBE_VISITS, "plain_visits": 64,
         "splits": probe_splits["scalar"]},
        {"name": "mm_visit_mma", "route": "cuda",
         "source": "ai_path_tracer_denoiser_tpu_torch/csrc/mm_visit_mma.cu",
         "replaces": "tools/exp_mm_feasibility.py:194", "launches": probe_counts["mm_visit_mma"],
         "max_abs_err": mma["tf32"]["max_abs_err"], "ms": probe_ms["tf32"],
         "device_ms": probe_device_ms["tf32"],
         "plain_ms": mma["tf32"]["plain_ms"], "bound_ms": mma_bound["tf32"],
         "bound_by": "operations", "library_ms": None,
         "visits_per_launch": PROBE_VISITS, "plain_visits": 64,
         "splits": probe_splits["tf32"],
         "ms_3xtf32": probe_ms["3xtf32"], "device_ms_3xtf32": probe_device_ms["3xtf32"],
         "bound_ms_3xtf32": mma_bound["3xtf32"],
         "max_abs_err_3xtf32": mma["3xtf32"]["max_abs_err"],
         "splits_3xtf32": probe_splits["3xtf32"]},
    ]}
    summary["kernels"] += [geom_row, *kpcn_rows]
    require(len(summary["kernels"]) == 13, "thirteen kernels in the summary")
    for row in summary["kernels"]:
        row["parallel_path_launches"] = par_launches.get(row["name"], 0)
        row["campaign_path_launches"] = campaign_launches.get(row["name"], 0)
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump({"card": smi, **summary, "conv_per_shape": per_shape}, f, indent=1)
    emit(summary)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
