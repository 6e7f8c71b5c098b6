"""The denoiser's training loop, driven by a traffic file of kind "train":
closed loop of optimiser steps.

The corpus (G-buffer frames with 10 channels and 3-channel targets) is
made on the card from the seed and stays there; each step crops its
windows on the device through the program's feed
(``train/device_data.py:_crop_batch``) and runs ``train/trainer.py:
train_step`` (bfloat16 convs forward and backward, the loss, Adam).  The
first steps run in set-up on windows that all differ and are held to the
plain reference after the window; ``train_step_ms`` is the window's
seconds over the steps completed, the card drained once at its end.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import common, weights
from perfbench.reference import rdae as ref_rdae


def make_corpus(seed: int, traffic, device):
    """(X (F, H, W, 10), Y (F, H, W, 3)) bfloat16 in the ranges the
    datagen writes: noisy 1-spp radiance around a smooth image, unit
    normals, distances up to 15, albedo and targets in [0, 1]."""
    f, (h, w) = traffic["corpus_frames"], traffic["frame_hw"]
    g = weights.generator(seed ^ 0x5EED, device)
    lo = torch.rand(f, 10, h // 16, w // 16, generator=g, device=device)
    smooth = torch.nn.functional.interpolate(lo, size=(h, w), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
    noise = torch.rand(f, h, w, 3, generator=g, device=device)
    target = smooth[..., 7:10] * smooth[..., 0:1]
    rgb = target * (2.0 * noise)
    nrm = smooth[..., 3:6] * 2.0 - 1.0
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True).clamp_min(1e-6)
    depth = smooth[..., 6:7] * 15.0
    x = torch.cat([rgb, nrm, depth, smooth[..., 7:10]], dim=-1)
    return x.to(torch.bfloat16), target.to(torch.bfloat16)


def plan(seed: int, traffic, cfg, n_steps: int):
    """Window starts and crop offsets of ``n_steps`` batches.  The first
    ``warmup_steps`` batches take distinct windows (no row repeats)."""
    t, crop, batch = cfg["train"]["sequence"], cfg["train"]["crop"], cfg["train"]["batch"]
    f, (h, w) = traffic["corpus_frames"], traffic["frame_hw"]
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 3])
    ny, nx = h // crop, w // crop
    combos = (f - t + 1) * ny * nx
    first = rng.choice(combos, traffic["warmup_steps"] * batch, replace=False)
    rest = rng.integers(0, combos, (n_steps - traffic["warmup_steps"]) * batch)
    items = np.concatenate([first, rest]).reshape(n_steps, batch)
    start = items // (ny * nx)
    cy = (items // nx) % ny * crop
    cx = items % nx * crop
    return start, cy, cx


class Program:
    """The system under test: the port's train step and device feed."""

    def __init__(self, cfg, seed, device):
        from ai_path_tracer_denoiser_tpu_torch.config import ModelOptions, TrainOptions
        from ai_path_tracer_denoiser_tpu_torch.train.trainer import TrainState, init_opt_state
        tr = cfg["train"]
        self.cfg = cfg
        ws, wg, wt = tr["loss_weights"]
        self.topt = TrainOptions(lr=tr["lr"], sequence_length=tr["sequence"],
                                 crop_size=tr["crop"], batch_size=tr["batch"],
                                 w_spatial=ws, w_gradient=wg, w_temporal=wt,
                                 bf16_compute=True)
        self.mopts = ModelOptions(widths=tuple(cfg["model"]["widths"]))
        params, bn = weights.make_params(seed, cfg["model"]["widths"], device)
        self.state = TrainState(params=params, bn_state=bn, opt_state=init_opt_state(params),
                                step=0, lr=float(tr["lr"]))

    def feed(self, X, Y, start, cy, cx):
        from ai_path_tracer_denoiser_tpu_torch.train.device_data import _crop_batch
        c = self.topt.crop_size
        return _crop_batch(X, Y, start.tolist(), cy.tolist(), cx.tolist(),
                           self.topt.sequence_length, c, c)

    def step(self, state, x, y):
        from ai_path_tracer_denoiser_tpu_torch.train.trainer import train_step
        return train_step(state, x, y, self.topt, self.mopts)


class LowPrecisionStep:
    """The control: the plain reference's step in the program's place, its
    convs in float8 e4m3 (``quant="bf16"``: in bfloat16, a witness); state
    kept as the program keeps it."""

    def __init__(self, cfg, quant="fp8"):
        self.cfg, self.quant = cfg, quant

    def __call__(self, state, x, y):
        import dataclasses
        p, bn = state.params, state.bn_state
        opt = state.opt_state
        ropt = {"count": opt["count"], "mu": [v for _, v in ref_rdae.leaves(opt["mu"])],
                "nu": [v for _, v in ref_rdae.leaves(opt["nu"])]}
        loss, _, new_p, new_bn, new_opt = ref_rdae.train_step(
            p, bn, ropt, _nchw(x), _nchw(y), state.lr, self.cfg["model"]["widths"],
            quant=self.quant)
        opt_state = {"count": new_opt["count"],
                     "mu": ref_rdae.rebuild(p, new_opt["mu"]),
                     "nu": ref_rdae.rebuild(p, new_opt["nu"])}
        return (dataclasses.replace(state, params=new_p, bn_state=new_bn,
                                    opt_state=opt_state, step=state.step + 1), loss)


def _nchw(t):
    return t.float().permute(0, 1, 4, 2, 3).contiguous()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, args, t_proc0, device, program_hook=None):
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    prog = Program(cfg, args.seed, device)
    step = LowPrecisionStep(cfg) if args.control else prog.step
    feed = prog.feed
    if program_hook is not None:
        feed, step = program_hook(prog, feed, step)
    X, Y = make_corpus(args.seed, traffic, device)
    starts, cys, cxs = plan(args.seed, traffic, cfg, traffic["max_steps"])
    _sync(device)
    common.mark("program")
    state = prog.state
    warm = traffic["warmup_steps"]
    kept = {"losses": []}
    for i in range(warm):
        x, y = feed(X, Y, starts[i], cys[i], cxs[i])
        state, metrics = step(state, x, y)
        kept["losses"].append({k: metrics[k] for k in ("total", "hfen")})
        if i == 0:
            kept["mu1"], kept["bn1"] = state.opt_state["mu"], state.bn_state
    kept["params"], kept["bn"] = state.params, state.bn_state
    _sync(device)
    common.mark("warm")
    setup_s = time.time() - t_proc0

    n = 0
    t0 = time.perf_counter()
    t_end = t0 + args.seconds
    while time.perf_counter() < t_end and warm + n < len(starts):
        x, y = feed(X, Y, starts[warm + n], cys[warm + n], cxs[warm + n])
        state, metrics = step(state, x, y)
        n += 1
    _sync(device)
    window_s = time.perf_counter() - t0

    rec = None
    if args.trace:
        cursor = {"i": warm + n, "state": state}

        def one():
            i = cursor["i"] % len(starts)
            with torch.profiler.record_function("crop"):
                x, y = feed(X, Y, starts[i], cys[i], cxs[i])
            with torch.profiler.record_function("train_step"):
                cursor["state"], _ = step(cursor["state"], x, y)
            cursor["i"] += 1

        prof = common.profile_units(one, common.units_for(traffic, window_s, n), "step",
                                    ("step",))
        _sync(device)
        from perfbench import counts
        tr = cfg["train"]
        convs = counts.rdae_convs(tr["crop"], tr["crop"], cfg["model"]["widths"])
        rec = {"steps": n, "window_s": window_s, "profile": prof,
               "step_flops": 3 * tr["batch"] * tr["sequence"] * counts.conv_flops(convs),
               "peak_flops": counts.PEAKS["bf16_flops"]}
        del cursor
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    losses = [{k: float(v) for k, v in m.items()} for m in kept["losses"]]
    mu1 = {k: float(torch.linalg.vector_norm(v.float())) / (1 - 0.9)
           for k, v in _named(kept["mu1"])}
    p3 = dict(_named(kept["params"]))
    bn3 = dict(_named(kept["bn"]))
    bn1 = dict(_named(kept["bn1"]))
    del prog, state, X, Y, step, feed, kept
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    with common.no_tf32():
        checks = judge(cfg, traffic, limits, args.seed, device, losses, mu1, p3, bn1, bn3,
                       (starts[:warm], cys[:warm], cxs[:warm]))
    print(f"[perfbench] set-up {setup_s:.1f} s, window {window_s:.1f} s, {n} steps, "
          f"check {time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    print(f"[perfbench] set-up parts: {common.setup_parts(t_proc0)}", file=sys.stderr)
    failed = int(any(c["value"] > c["limit"] or c["value"] != c["value"]
                     for c in checks.values()))
    return {"attempted": n, "failed": failed, "checks": checks,
            "end_to_end": {"setup_s": setup_s, "train_step_ms": 1e3 * window_s / max(n, 1)},
            "trace": rec, "memory_peak_bytes": peak}


def _named(tree):
    return [(".".join(k), v) for k, v in ref_rdae.leaves(tree)]


def judge(cfg, traffic, limits, seed, device, losses, mu1, p3, bn1, bn3, batches):
    """The reference follows the first steps from the same seed.  Compared:
    the BatchNorm statistics after the first step, by the worst leaf of the
    distance from the reference's over the reference's change (forward
    only: rounding errors of the weights shift a channel's statistics
    together, where the loss averages them away), and the change of the
    parameters and of the BatchNorm statistics after the last kept step,
    each by the worst leaf of the gap between norms.  Leaves whose
    reference gradient is under a thousandth of the median leaf's (conv
    biases ahead of a BatchNorm) move under Adam by round-off alone and are
    left out of the change.  Each step's loss, the first step's HFEN term
    and the first gradient (from Adam's first moment after one step) are
    printed, not compared: the random recurrent BatchNorm network carries
    bfloat16 rounding in them as far as float8's (PERF.md)."""
    params, bn = weights.make_params(seed, cfg["model"]["widths"], device)
    p0, bn0 = dict(_named(params)), dict(_named(bn))
    X, Y = make_corpus(seed, traffic, device)
    tr = cfg["train"]
    t, c = tr["sequence"], tr["crop"]
    opt = {"count": 0, "mu": [torch.zeros_like(v) for _, v in ref_rdae.leaves(params)],
           "nu": [torch.zeros_like(v) for _, v in ref_rdae.leaves(params)]}
    ref_losses, g1, b1 = [], None, None
    p, b = params, bn
    for i in range(len(losses)):
        st, cy, cx = (a[i] for a in batches)
        x = torch.stack([X[s:s + t, yy:yy + c, xx:xx + c] for s, yy, xx in zip(st, cy, cx)], 1)
        y = torch.stack([Y[s:s + t, yy:yy + c, xx:xx + c] for s, yy, xx in zip(st, cy, cx)], 1)
        loss, grads, p, b, opt = ref_rdae.train_step(p, b, opt, _nchw(x), _nchw(y), tr["lr"],
                                                     cfg["model"]["widths"])
        ref_losses.append({k: float(loss[k]) for k in ("total", "hfen")})
        if g1 is None:
            g1 = {k: float(torch.linalg.vector_norm(v)) for k, v in _named(grads)}
            b1 = dict(_named(b))
        del x, y, grads
    del X, Y
    import statistics
    med = statistics.median(g1.values())
    moving = [k for k, v in g1.items() if v >= 1e-3 * med]
    d_ref = {k: float(torch.linalg.vector_norm(v - p0[k])) for k, v in _named(p)}
    d_prog = {k: float(torch.linalg.vector_norm(p3[k].float() - p0[k])) for k in d_ref}
    b_ref = {k: float(torch.linalg.vector_norm(v - bn0[k])) for k, v in _named(b)}
    b_prog = {k: float(torch.linalg.vector_norm(bn3[k].float() - bn0[k])) for k in b_ref}
    loss_gaps = [abs(a["total"] - r["total"]) / abs(r["total"])
                 for a, r in zip(losses, ref_losses)]
    gaps = {"grad_norm_gap": common.norm_gaps(mu1, g1),
            "change_norm_gap": common.norm_gaps({k: d_prog[k] for k in moving},
                                                {k: d_ref[k] for k in moving}),
            "bn_change_gap": common.norm_gaps(b_prog, b_ref)}
    print(f"[perfbench] loss gap by step {loss_gaps}; leaves left out of the change: "
          f"{sorted(set(g1) - set(moving))}", file=sys.stderr)
    for name, per in gaps.items():
        order = sorted(per, key=per.get)
        print(f"[perfbench] {name}: median leaf {per[order[len(order) // 2]]!r}, worst "
              f"{[(k, per[k]) for k in order[-4:]]}", file=sys.stderr)
    # the first step's BatchNorm statistics: forward only, so no gradient
    # chaos; a leaf's error over its change, or the median leaf's change
    step1 = {k: float(torch.linalg.vector_norm(b1[k] - bn0[k])) for k in b1}
    med1 = statistics.median(step1.values())
    bn_step1 = {k: float(torch.linalg.vector_norm(bn1[k].float() - b1[k])) / max(step1[k], med1)
                for k in b1}
    order = sorted(bn_step1, key=bn_step1.get)
    hfen = abs(losses[0]["hfen"] - ref_losses[0]["hfen"]) / ref_losses[0]["hfen"]
    print(f"[perfbench] first step's HFEN gap {hfen!r}; bn_step1_err median leaf "
          f"{bn_step1[order[len(order) // 2]]!r}, worst {[(k, bn_step1[k]) for k in order[-4:]]}",
          file=sys.stderr)
    values = {"bn_step1_err": max(bn_step1.values()),
              "change_norm_gap": max(gaps["change_norm_gap"].values()),
              "bn_change_gap": max(gaps["bn_change_gap"].values())}
    return {k: {"value": v, "limit": limits["limits"][k]} for k, v in values.items()}
