"""The interactive frame loop with the kernel-predicting denoiser, driven by
a traffic file of kind "interactive_kpcn": one viewer, closed loop.

Each frame orbits the camera by ``dphi``, traces 1 spp into the G-buffer
(``render_gbuffer_frame``), denoises it with KPCN through the port's entry
point (``apply_kpcn_frame``: nine 5x5 convs, then the per-pixel softmax
and 21x21 weighted sum; no hidden state), and copies the frame back into
page-locked host memory one frame behind, as ``app/cli.py:cmd_interactive``
does with ``--denoiser kpcn``; no image is encoded or written.

``frame_ms`` and ``frame_ms_p95`` are those of loops/interactive.py.
After the window the program's outputs at the first frames and a few
drawn from the seed are held to the plain reference
(perfbench/reference/kpcn.py, and reference/render.py for the G-buffer):
the G-buffer, the denoised frame and the softmax weights of its logits.
The traced run's record carries the nine convs' and the apply's bounds,
which metrics/kpcn_conv_roofline.py and metrics/kpcn_apply_roofline.py
read against the device time in their spans; BENCHMARK.json lists neither
metric yet, so the traced run prints both on standard error.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from perfbench import common, counts_kpcn, weights_kpcn
from perfbench.loops.interactive import Program as RdaeProgram
from perfbench.loops.interactive import _landed, _mean_ms, _span, _sync
from perfbench.reference import kpcn as ref_kpcn
from perfbench.reference import render as ref_render

# Program spans whose kernels the traced run counts (utils/timers.py)
CONV_SPAN, APPLY_SPAN = "denoise.kpcn.convs", "denoise.kpcn.apply"
REF_ROWS = 100          # the reference's window in blocks of rows at 800x800


class Program:
    """The system under test: the port's entry points on this cell's scene
    and network.  ``render`` and ``denoise`` are the two calls of a frame;
    ``denoise`` returns the frame and the logits it was made from."""

    render = RdaeProgram.render

    def __init__(self, cfg, seed: int, device):
        from ai_path_tracer_denoiser_tpu_torch.config import KPCNOptions, RenderOptions
        from ai_path_tracer_denoiser_tpu_torch.models import kpcn
        from ai_path_tracer_denoiser_tpu_torch.scene import (derive_camera, load_scene,
                                                             orbit_params_from_camera)
        sc, m = cfg["scene"], cfg["model"]
        scene = load_scene(os.path.join(common.ROOT, sc["file"]), device=device)
        w, h = sc["resolution"]
        if tuple(scene.camera.resolution) != (w, h):
            c = scene.camera
            scene = dataclasses.replace(scene, camera=derive_camera(
                (w, h), float(c.fov[1]), c.position.numpy(), c.look_at.numpy(), c.up.numpy()))
        if scene.trace_depth != sc["depth"]:
            raise SystemExit(f"scene depth {scene.trace_depth}, config says {sc['depth']}")
        self.scene, self.seed, self.device = scene, seed, device
        self.options = RenderOptions(rng=sc["rng"], backend=sc["backend"])
        if (m["conv"], m["in_channels"]) != (kpcn.TAPS, kpcn.IN_CHANNELS):
            raise SystemExit(f"the port's KPCN is {kpcn.TAPS}x{kpcn.TAPS} on "
                             f"{kpcn.IN_CHANNELS} inputs, config says {m['conv']}, "
                             f"{m['in_channels']}")
        self.kopts = KPCNOptions(layers=m["layers"], width=m["width"], kernel=m["kernel"])
        self.model = m
        self.params = weights_kpcn.make_params(seed, m, device)
        self.orbit = orbit_params_from_camera(scene.camera)

    def denoise(self, gbuffer):
        from ai_path_tracer_denoiser_tpu_torch.models import apply_kpcn_frame
        return apply_kpcn_frame(self.params, gbuffer, self.kopts, return_logits=True)


class LowPrecisionDenoiser:
    """The control's denoiser: the plain reference in the program's place,
    its convs in float8 e4m3 with per-tensor scales (``quant="bf16"``: in
    bfloat16, a witness); the frame and the logits in the program's
    layouts."""

    def __init__(self, program: Program, quant="fp8"):
        self.params = weights_kpcn.make_params(program.seed, program.model, program.device)
        self.k, self.quant = program.model["kernel"], quant

    def __call__(self, gbuffer):
        with torch.no_grad(), ref_kpcn.no_tf32():
            lg = ref_kpcn.logits(self.params, ref_kpcn.features(gbuffer), self.quant)
            y = ref_kpcn.apply(ref_kpcn.weights(lg), gbuffer[None, 0:3], self.k, REF_ROWS)
        return y.permute(0, 2, 3, 1).contiguous(), lg.permute(0, 2, 3, 1).contiguous()


def run(cell, args, t_proc0, device, program_hook=None):
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    common.check_inputs(cfg["scene"]["inputs"])
    prog = Program(cfg, args.seed, device)
    render, denoise = prog.render, prog.denoise
    if args.control:
        denoise = LowPrecisionDenoiser(prog)
    if program_hook is not None:
        render, denoise = program_hook(prog, render, denoise)
    on_card = device.type == "cuda"
    dphi = traffic["dphi"]
    rng = np.random.default_rng([args.seed & 0xFFFFFFFFFFFFFFFF, 1])
    check_at = sorted(rng.random(traffic["check_frames"]) * args.seconds)
    pinned = None
    snaps = {}
    state = {"phi": prog.orbit[0], "k": 0}

    def frame(keep=False, marks=None, annotate=False, timed=False):
        """One frame: orbit, render, denoise, queue the copy back.
        Returns (frame index, host buffer, ready event, start event)."""
        nonlocal pinned
        k = state["k"]
        t_start = time.perf_counter()
        start = None
        if timed and on_card:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        if k:
            state["phi"] += dphi
        if marks is not None:
            marks[0].record()
        with _span(annotate, "render"):
            gbuffer = render(state["phi"])
        if marks is not None:
            marks[1].record()
        with _span(annotate, "denoise"):
            denoised, logits = denoise(gbuffer)
        if marks is not None:
            marks[2].record()
        state["k"] = k + 1
        if keep:
            snaps[k] = {"gbuffer": gbuffer, "denoised": denoised, "logits": logits}
        with _span(annotate, "copy_back"):
            out = denoised[0].clamp(0, 1)
            if not on_card:
                return k, out.clone(), None, time.perf_counter() - t_start
            if pinned is None:
                pinned = [torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                          for _ in range(2)]
            pinned[k % 2].copy_(out, non_blocking=True)
            ready = torch.cuda.Event(enable_timing=timed)
            ready.record()
            return k, pinned[k % 2], ready, start

    # set-up: every shape this cell uses, through the window's own calls;
    # the first frames are kept for the check
    _sync(device)
    common.mark("program")
    for _ in range(traffic["warmup_frames"]):
        frame(keep=True, timed=True)
    _sync(device)
    common.mark("warm")
    setup_s = time.time() - t_proc0

    trace = bool(args.trace)
    marks_all, dispatch, latency_ms = [], [], []
    n, pending, t_next = 0, None, 0
    t0 = time.perf_counter()
    t_end = t0 + args.seconds
    while True:
        t_f = time.perf_counter()
        if t_f >= t_end:
            break
        keep = False
        while t_next < len(check_at) and t_f - t0 >= check_at[t_next]:
            keep, t_next = True, t_next + 1
        marks = None
        if trace and on_card:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks_all.append(marks)
        fetched = frame(keep=keep, marks=marks, timed=True)
        if trace:
            dispatch.append(time.perf_counter() - t_f)
        if pending is not None:
            latency_ms.append(_landed(pending))
        pending = fetched
        n += 1
    if pending is not None:
        latency_ms.append(_landed(pending))
    window_s = time.perf_counter() - t0
    _sync(device)

    rec = None
    if trace:
        prof = common.profile_units(lambda: frame(annotate=True),
                                    common.units_for(traffic, window_s, n),
                                    "frame", ("render", "denoise", CONV_SPAN, APPLY_SPAN))
        _sync(device)
        rec = {"frames": n, "window_s": window_s,
               "dispatch_ms": 1e3 * sum(dispatch) / max(len(dispatch), 1),
               "render_ms": _mean_ms(marks_all, 0, 1), "denoise_ms": _mean_ms(marks_all, 1, 2),
               "profile": prof, **cell_counts(cfg)}
        for name in ("kpcn_conv_roofline", "kpcn_apply_roofline"):
            print(f"[perfbench] {name} {common.metric_reader(name)(rec)!r}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the program's state goes before the reference runs
    del prog, render, denoise, state, pinned
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    with ref_kpcn.no_tf32():
        checks, failed = judge(cfg, traffic, limits, snaps, args.seed, device)
    print(f"[perfbench] set-up {setup_s:.1f} s, window {window_s:.1f} s, {n} frames, "
          f"check {time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    print(f"[perfbench] set-up parts: {common.setup_parts(t_proc0)}", file=sys.stderr)
    return {"attempted": n, "failed": failed, "checks": checks,
            "end_to_end": {"setup_s": setup_s, "frame_ms": 1e3 * window_s / max(n, 1),
                           "frame_ms_p95": float(np.percentile(latency_ms, 95))},
            "trace": rec, "memory_peak_bytes": peak}


def cell_counts(cfg):
    """The denoiser's work per frame at the cell's size, from the published
    shapes (counts_kpcn.py)."""
    w, h = cfg["scene"]["resolution"]
    m = cfg["model"]
    convs = counts_kpcn.kpcn_convs(h, w, m)
    conv_s = counts_kpcn.conv_bound_s(convs)
    apply_s = counts_kpcn.apply_bound_s(h, w, m["kernel"])
    return {"denoise_flops": counts_kpcn.conv_flops(convs), "conv_bound_s": conv_s,
            "apply_bound_s": apply_s, "denoise_bound_s": conv_s + apply_s,
            "peak_flops": counts_kpcn.PEAKS["bf16_flops"]}


def _gbuffer_off(scene, tables, cam, gbuffer, tol, device) -> float:
    """Share of pixels with a G-buffer channel off the reference render's
    by more than the tolerance (as loops/interactive.py checks it)."""
    w, h = scene["camera"]["resolution"]
    pix = torch.arange(w * h, device=device)
    with torch.no_grad():
        want = ref_render.gbuffer_pixels(scene, tables, cam, pix)
    got = gbuffer.flip(2).reshape(10, -1)[:, pix].float()
    ok = (got - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()
    return float((~ok.all(0)).float().mean())


def judge(cfg, traffic, limits, snaps, seed, device):
    """Hold the kept frames to the reference.  The program's G-buffer is
    what both denoisers read.  Numbers: the worst frame's share of pixels
    whose 10 G-buffer channels are not all within tolerance; the denoised
    frames' distance from the float32 reference, all checked frames
    together, over the distance of the reference with its convs and logits
    rounded to bfloat16 as the program rounds (a witness on the same
    inputs); the denoised frames' gain against the reference, per colour
    channel, as its gap from 1 (<got - want, want> / <want, want>); the
    relative L2 of the softmax weights of the program's logits against the
    reference's, per tap over the frame's pixels, the worst tap of the
    worst frame (a tap that the program weights wrongly reads near 1
    however small its share of the window's weight; rounding reads about
    the logits' error, alike for every tap)."""
    sc = cfg["scene"]
    scene = ref_render.parse_scene(os.path.join(common.ROOT, sc["file"]))
    w, h = sc["resolution"]
    if scene["camera"]["resolution"] != (w, h):
        c = scene["camera"]
        scene["camera"] = ref_render.derive_camera((w, h), c["fovy"], c["position"],
                                                   c["look_at"], c["up"])
    tables = ref_render.to_device(scene, device)
    phi0, theta, zoom = ref_render.orbit_start(scene["camera"])
    frames = sorted(snaps)
    phis = ref_render.frame_phis(phi0, traffic["dphi"], frames)
    params = weights_kpcn.make_params(seed, cfg["model"], device)
    k = cfg["model"]["kernel"]
    per_frame = []
    err2 = wit2 = 0.0
    gain_gap = wit_gap = ref2 = 0.0
    for f in frames:
        t_f = time.perf_counter()
        s = snaps.pop(f)
        cam = ref_render.orbit(scene["camera"], phis[f], theta, zoom)
        off = _gbuffer_off(scene, tables, cam, s["gbuffer"], limits["gbuffer_tolerance"], device)
        t_g = time.perf_counter()
        g = s["gbuffer"].float()
        with torch.no_grad():
            y, wgt = ref_kpcn.frame(params, g, k, rows=REF_ROWS)
            y_wit, _ = ref_kpcn.frame(params, g, k, quant="bf16", rows=REF_ROWS)
            w_prog = ref_kpcn.weights(s["logits"][..., :k * k].permute(0, 3, 1, 2))
            k_err = float(((w_prog - wgt).double().square().sum((0, 2, 3))
                           / wgt.double().square().sum((0, 2, 3)).clamp_min(1e-300))
                          .sqrt().max())
            del w_prog, wgt
        got_y = s["denoised"].permute(0, 3, 1, 2).double()
        want_y, wit_y = y.double(), y_wit.double()
        e2 = float((got_y - want_y).square().sum())
        w2 = float((wit_y - want_y).square().sum())
        err2, wit2 = err2 + e2, wit2 + w2
        gain_gap = gain_gap + ((got_y - want_y) * want_y).sum(dim=(0, 2, 3))
        wit_gap = wit_gap + ((wit_y - want_y) * want_y).sum(dim=(0, 2, 3))
        ref2 = ref2 + want_y.square().sum(dim=(0, 2, 3))
        norm = max(float(want_y.square().sum()), 1e-300)
        per_frame.append((f, off, k_err))
        print(f"[perfbench] frame {f}: pixels off {off!r}, denoised rel L2 {(e2 / norm) ** 0.5!r} "
              f"(bfloat16 witness {(w2 / norm) ** 0.5!r}), worst tap's kernel rel L2 {k_err!r}; reference "
              f"{t_g - t_f:.2f} s render, {time.perf_counter() - t_g:.2f} s denoise",
              file=sys.stderr)
    print(f"[perfbench] gain gaps by channel: program {(gain_gap / ref2).tolist()!r}, "
          f"bfloat16 witness {(wit_gap / ref2).tolist()!r}", file=sys.stderr)
    values = {"gbuffer_off_share": max(f[1] for f in per_frame),
              "denoise_err_ratio": (err2 / max(wit2, 1e-300)) ** 0.5,
              "denoise_gain_gap": float((gain_gap / ref2.clamp_min(1e-300)).abs().max()),
              "kernel_rel_l2": max(f[2] for f in per_frame)}
    values = {n: v if v == v else float("inf") for n, v in values.items()}
    checks = {n: {"value": v, "limit": limits["limits"][n]} for n, v in values.items()}
    lim = limits["limits"]
    failed = sum(not (f[1] <= lim["gbuffer_off_share"] and f[2] <= lim["kernel_rel_l2"])
                 for f in per_frame)
    return checks, failed
