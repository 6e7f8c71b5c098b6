"""The interactive frame loop, driven by a traffic file of kind
"interactive": one viewer, closed loop.

Each frame orbits the camera by ``dphi``, traces 1 spp into the G-buffer
(``render_gbuffer_frame``), denoises it with the BatchNorm-folded bfloat16
network carrying the hidden state (``apply_frame_fast_padded``), and
copies the frame back into page-locked host memory one frame behind, as
``app/cli.py:cmd_interactive`` does; no image is encoded or written.

``frame_ms`` is the window's seconds over the frames whose pixels reached
the host inside it.  ``frame_ms_p95`` is the 95th percentile, over every
frame of the window, of its latency on the card's clock: from an event
recorded as the host starts the frame's dispatch to the event recorded
after its copy into host memory.  After the window the program's own
outputs at a few frames drawn from the seed are held to the plain
reference (perfbench/reference): the G-buffer, the denoised frame and the
new hidden state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from perfbench import common, weights
from perfbench.reference import rdae as ref_rdae
from perfbench.reference import render as ref_render


class Program:
    """The system under test: the port's entry points on this cell's scene
    and network.  ``render`` and ``denoise`` are the two calls of a frame."""

    def __init__(self, cfg, seed: int, device, lowp: bool = False):
        from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, RenderOptions
        from ai_path_tracer_denoiser_tpu_torch.models import (init_hidden, padded_resolution,
                                                              prepare_inference)
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
        self.scene, self.hw = scene, (h, w)
        self.seed, self.widths, self.device = seed, m["widths"], device
        self.options = RenderOptions(rng=sc["rng"], backend=sc["backend"],
                                     accum_dtype="bfloat16" if lowp else "float32")
        self.mopts = ModelOptions(widths=tuple(m["widths"]))
        params, bn = weights.make_params(seed, m["widths"], device)
        self.folded = prepare_inference(params, bn, self.mopts)
        self.padded = padded_resolution(h, w)
        self.hidden0 = init_hidden(1, *self.padded, self.mopts, dtype=torch.bfloat16,
                                   device=device)
        self.orbit = orbit_params_from_camera(scene.camera)

    def render(self, phi):
        from ai_path_tracer_denoiser_tpu_torch.render import render_gbuffer_frame
        from ai_path_tracer_denoiser_tpu_torch.scene import orbit_camera
        _, theta, zoom = self.orbit
        cam = orbit_camera(self.scene.camera, phi, theta, zoom)
        return render_gbuffer_frame(dataclasses.replace(self.scene, camera=cam),
                                    self.options)[1]

    def denoise(self, gbuffer, hidden):
        from ai_path_tracer_denoiser_tpu_torch.models import apply_frame_fast_padded
        return apply_frame_fast_padded(self.folded, gbuffer.permute(1, 2, 0)[None],
                                       hidden, self.mopts)


class LowPrecisionDenoiser:
    """The control's denoiser: the plain reference in the program's place,
    its convs in float8 e4m3 with per-tensor scales (``quant="bf16"``: in
    bfloat16, a witness), NHWC bfloat16 hidden state in and out as the
    program keeps it."""

    def __init__(self, program: Program, quant="fp8"):
        self.params, self.bn = weights.make_params(program.seed, program.widths,
                                                   program.device)
        self.padded, self.quant = program.padded, quant

    def __call__(self, gbuffer, hidden):
        h, w = gbuffer.shape[1:]
        x = ref_rdae.edge_pad(gbuffer[None].float(), *self.padded)
        hid = {k: v.permute(0, 3, 1, 2).float() for k, v in hidden.items()}
        with torch.no_grad():
            y, hid, _ = ref_rdae.frame(self.params, self.bn, x, hid, quant=self.quant)
        return (y[:, :, :h, :w].permute(0, 2, 3, 1).contiguous(),
                {k: v.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
                 for k, v in hid.items()})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, args, t_proc0, device, program_hook=None):
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    common.check_inputs(cfg["scene"]["inputs"])
    prog = Program(cfg, args.seed, device, lowp=args.control)
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
    state = {"phi": prog.orbit[0], "hidden": prog.hidden0, "k": 0}

    def frame(keep=False, marks=None, annotate=False, timed=False):
        """One frame: orbit, render, denoise, queue the copy back.
        Returns (frame index, host buffers, ready event, start event);
        the two events time the frame's latency where ``timed``."""
        nonlocal pinned
        k = state["k"]
        t_start = time.perf_counter()
        start = None
        if timed and on_card:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        if k:
            state["phi"] += dphi
        hidden_in = state["hidden"]
        if marks is not None:
            marks[0].record()
        with _span(annotate, "render"):
            gbuffer = render(state["phi"])
        if marks is not None:
            marks[1].record()
        with _span(annotate, "denoise"):
            denoised, hidden = denoise(gbuffer, hidden_in)
        if marks is not None:
            marks[2].record()
        state["hidden"], state["k"] = hidden, k + 1
        if keep:
            snaps[k] = {"gbuffer": gbuffer, "denoised": denoised, "hidden_in": hidden_in,
                        "hidden_out": hidden}
        with _span(annotate, "copy_back"):
            out = denoised[0].clamp(0, 1)
            if not on_card:
                # the CPU has no events: the host clock, for the tests alone
                return k, out.clone(), None, time.perf_counter() - t_start
            if pinned is None:
                pinned = [torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                          for _ in range(2)]
            pinned[k % 2].copy_(out, non_blocking=True)
            ready = torch.cuda.Event(enable_timing=timed)
            ready.record()
            return k, pinned[k % 2], ready, start

    # set-up: every shape this cell uses, through the window's own calls;
    # the first frames (hidden state from zero) are kept for the check
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
                                    "frame", ("render", "denoise"))
        _sync(device)
        conv = cell_counts(cfg, prog.padded)
        rec = {"frames": n, "window_s": window_s,
               "dispatch_ms": 1e3 * sum(dispatch) / max(len(dispatch), 1),
               "render_ms": _mean_ms(marks_all, 0, 1), "denoise_ms": _mean_ms(marks_all, 1, 2),
               "profile": prof, **conv}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the program's state goes before the reference runs
    del prog, render, denoise, state, pinned
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    with common.no_tf32():
        checks, failed = judge(cfg, traffic, limits, snaps, args.seed, device)
    print(f"[perfbench] set-up {setup_s:.1f} s, window {window_s:.1f} s, {n} frames, "
          f"check {time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    print(f"[perfbench] set-up parts: {common.setup_parts(t_proc0)}", file=sys.stderr)
    return {"attempted": n, "failed": failed, "checks": checks,
            "end_to_end": {"setup_s": setup_s, "frame_ms": 1e3 * window_s / max(n, 1),
                           "frame_ms_p95": float(np.percentile(latency_ms, 95))},
            "trace": rec, "memory_peak_bytes": peak}


def _landed(fetched) -> float:
    """Wait for a frame's pixels to reach the host; its latency in ms."""
    _, _, ready, start = fetched
    if ready is None:
        return 1e3 * start
    ready.synchronize()
    return start.elapsed_time(ready)


def _span(on: bool, name: str):
    """A profiler span around a layer's call in the traced sub-window."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _mean_ms(marks_all, a, b):
    if not marks_all:
        return None
    return sum(m[a].elapsed_time(m[b]) for m in marks_all) / len(marks_all)


def cell_counts(cfg, padded):
    from perfbench import counts
    convs = counts.rdae_convs(*padded, cfg["model"]["widths"])
    return {"denoise_flops": counts.conv_flops(convs), "denoise_bound_s": counts.bound_s(convs),
            "peak_flops": counts.PEAKS["bf16_flops"]}


def judge(cfg, traffic, limits, snaps, seed, device):
    """Hold the kept frames to the reference.  The first frames chain the
    reference's own hidden state from zero; a later frame starts from the
    program's hidden state of the frame before it (the only way to reach
    frame k without re-running the window), and the program's G-buffer is
    what both denoisers read, each judged on its own.  Numbers: the worst
    frame's share of checked pixels whose 10 G-buffer channels are not all
    within tolerance; the denoised frames' distance from the reference, all
    checked frames together, over the distance of the reference computed
    with its convs rounded to bfloat16 as the program rounds (a witness on
    the same inputs: how far bfloat16 alone carries this seed's network,
    which swings several fold from seed to seed); the denoised frames'
    gain against the reference, per colour channel over all checked
    frames, as its gap from 1 (<got - want, want> / <want, want>: the part
    of the error that scales the frame, which a frame made brighter, darker
    or tinted moves in full and rounding noise only in part); the worst
    frame's relative L2 of the new hidden state (its worst level)."""
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
    params, bn = weights.make_params(seed, cfg["model"]["widths"], device)
    widths = cfg["model"]["widths"]
    tol = limits["gbuffer_tolerance"]
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 2])
    per_frame = []
    err2 = wit2 = 0.0
    gain_gap = wit_gap = ref2 = 0.0
    hidden_ref = hidden_wit = None
    for k in frames:
        t_f = time.perf_counter()
        s = snaps[k]
        cam = ref_render.orbit(scene["camera"], phis[k], theta, zoom)
        n_pix = w * h
        pick = limits.get("check_pixels") or n_pix
        if pick >= n_pix:
            pix = torch.arange(n_pix, device=device)
        else:
            pix = torch.from_numpy(np.sort(rng.choice(n_pix, pick, replace=False))).to(device)
        with torch.no_grad():
            want = ref_render.gbuffer_pixels(scene, tables, cam, pix)
        got = s["gbuffer"].flip(2).reshape(10, -1)[:, pix].float()
        ok = (got - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()
        off = float((~ok.all(0)).float().mean())
        t_g = time.perf_counter()
        x = s["gbuffer"][None].float()
        hp, wp = s["hidden_in"]["enc1"].shape[1:3]
        if k < traffic["warmup_frames"]:
            if hidden_ref is None:
                hidden_ref = hidden_wit = ref_rdae.zero_hidden(1, hp, wp, widths, device)
            h_in, h_wit = hidden_ref, hidden_wit
        else:
            h_in = h_wit = {kk: v.permute(0, 3, 1, 2).float()
                            for kk, v in s["hidden_in"].items()}
        xp = ref_rdae.edge_pad(x, hp, wp)
        with torch.no_grad():
            y, h_out, _ = ref_rdae.frame(params, bn, xp, h_in)
            y_wit, h_wit, _ = ref_rdae.frame(params, bn, xp, h_wit, quant="bf16")
        if k < traffic["warmup_frames"]:
            hidden_ref, hidden_wit = h_out, h_wit
        got_y = s["denoised"].permute(0, 3, 1, 2).double()
        want_y = y[:, :, :h, :w].double()
        e2 = float((got_y - want_y).square().sum())
        w2 = float((y_wit[:, :, :h, :w].double() - want_y).square().sum())
        err2, wit2 = err2 + e2, wit2 + w2
        gain_gap = gain_gap + ((got_y - want_y) * want_y).sum(dim=(0, 2, 3))
        wit_gap = wit_gap + ((y_wit[:, :, :h, :w].double() - want_y) * want_y).sum(dim=(0, 2, 3))
        ref2 = ref2 + want_y.square().sum(dim=(0, 2, 3))
        rel = (e2 / max(float(want_y.square().sum()), 1e-300)) ** 0.5
        h_err = max(common.rel_l2(s["hidden_out"][kk].permute(0, 3, 1, 2).float(), h_out[kk])
                    for kk in h_out)
        per_frame.append((k, off, rel, h_err))
        print(f"[perfbench] frame {k}: pixels off {off!r}, denoised rel L2 {rel!r} "
              f"(bfloat16 witness {(w2 / max(float(want_y.square().sum()), 1e-300)) ** 0.5!r}), "
              f"hidden rel L2 {h_err!r}; reference "
              f"{t_g - t_f:.2f} s render, {time.perf_counter() - t_g:.2f} s denoise",
              file=sys.stderr)
    print(f"[perfbench] gain gaps by channel: program {(gain_gap / ref2).tolist()!r}, "
          f"bfloat16 witness {(wit_gap / ref2).tolist()!r}", file=sys.stderr)
    values = {"gbuffer_off_share": max(f[1] for f in per_frame),
              "denoise_err_ratio": (err2 / max(wit2, 1e-300)) ** 0.5,
              "denoise_gain_gap": float((gain_gap / ref2.clamp_min(1e-300)).abs().max()),
              "hidden_rel_l2": max(f[3] for f in per_frame)}
    values = {k: v if v == v else float("inf") for k, v in values.items()}
    checks = {k: {"value": v, "limit": limits["limits"][k]} for k, v in values.items()}
    failed = sum(f[1] > limits["limits"]["gbuffer_off_share"] or f[1] != f[1]
                 or f[3] > limits["limits"]["hidden_rel_l2"] or f[3] != f[3]
                 for f in per_frame)
    return checks, failed
