#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, drives the main path -- the interactive
1-spp render + denoise loop on scenes/cornell_box.txt at 800x800, depth 8,
with the shipped denoiser -- through the CLI's entry point, checks that it
went through the kernels (1 render-megakernel launch and 28 conv-kernel
launches per frame) and that its frames are finite and decode, and times
each kernel beside its plain version, the least time the card could take
(its bound) and, where one exists, a PyTorch library call for the same
function.  Each phase prints one JSON line; the last lines are the
`kernels` summary, the card's name and power limit as nvidia-smi reports
them, and `{"ok": true, "device": {...}}`.  Any failed check raises and
the script exits non-zero.  Without a CUDA device it exits 2 at once.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "runs", "chip_smoke")
SCENE = os.path.join(ROOT, "scenes", "cornell_box.txt")
MODEL = os.path.join(ROOT, "artifacts", "denoiser_multiscene.npz")
FRAMES = 8
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


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


def bound_ms(n_bytes, ops, peak):
    t_bytes, t_ops = n_bytes / HBM_BPS, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    from ai_path_tracer_denoiser_tpu_torch.app import cli
    from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
    from ai_path_tracer_denoiser_tpu_torch.models import (
        conv_kernel, load_model, model_options_from_meta, prepare_inference)
    from ai_path_tracer_denoiser_tpu_torch.render import (
        assemble_gbuffer, cuda_backend, init_render_state)
    from ai_path_tracer_denoiser_tpu_torch.scene import (
        derive_camera, load_scene, orbit_camera, orbit_params_from_camera)
    from ai_path_tracer_denoiser_tpu_torch.utils.cuda_build import build_all
    from ai_path_tracer_denoiser_tpu_torch.utils.imageio import read_png

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

    # ---- 2. build both kernels (one nvcc per source, in parallel) ----
    kernels = (cuda_backend.KERNEL, conv_kernel.KERNEL)
    t0 = time.time()
    build_all(kernels)
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln or "spill" in ln] for k in kernels}
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
    conv_rows, k2_err = [], 0.0
    for name, r, conv, aff in shapes:
        cin, co = conv["w"].shape[2], conv["w"].shape[3]
        x = torch.randn((r, r * w0 // h0, cin), generator=gen, device=dev).to(torch.bfloat16)
        got = conv_kernel.conv3x3_act_chw(x, conv["w"], conv["b"], 0.1, aff)
        want = conv_kernel.conv3x3_act_plain(x, conv["w"], conv["b"], 0.1, aff)
        got32 = conv_kernel.conv3x3_act_chw(x, conv["w"], conv["b"], 0.1, aff, "float32")
        want32 = conv_kernel.conv3x3_act_plain(x, conv["w"], conv["b"], 0.1, aff, "float32")
        err = float((got.float() - want.float()).abs().max())
        err32 = float((got32 - want32).abs().max())
        ok16 = bool(((got.float() - want.float()).abs()
                     <= 1e-2 + 1.6e-2 * want.float().abs()).all())
        ok32 = bool(((got32 - want32).abs() <= 1e-3 + 1e-3 * want32.abs()).all())
        k2_err = max(k2_err, err)
        conv_rows.append({"layer": name, "shape": [r, x.shape[1], cin, co],
                          "affine": aff is not None, "x": x, "conv": conv, "aff": aff,
                          "max_abs_err_bf16": err, "max_abs_err_f32": err32})
        require(torch.isfinite(got.float()).all().item(), f"{name} finite")
        require(ok16 and ok32, f"conv kernel vs plain at {name}")
    emit({"phase": "conv_check", "shapes": len(shapes),
          "max_abs_err_bf16": k2_err,
          "max_abs_err_f32": max(r["max_abs_err_f32"] for r in conv_rows),
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
    emit({"phase": "render_timing", "card": smi, "kernel_ms": k1_ms,
          "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
          "segments": plain_state["s"].segments, "bytes": n_bytes, "ops": ops})

    k2 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "bytes_s": 0.0, "ops_s": 0.0}
    per_shape = []
    for row in conv_rows:
        x, conv, aff = row["x"], row["conv"], row["aff"]
        r, wd, cin, co = row["shape"]
        ms = time_ms(lambda: conv_kernel.conv3x3_act_chw(x, conv["w"], conv["b"], 0.1, aff), 20)
        pms = time_ms(lambda: conv_kernel.conv3x3_act_plain(x, conv["w"], conv["b"], 0.1, aff), 5)
        xn = x.permute(2, 0, 1)[None]                       # NCHW view, channels-last
        wn = conv["w"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bn = conv["b"].to(torch.bfloat16)
        lms = time_ms(lambda: F.conv2d(xn, wn, bn, padding=1), 20)
        nb, macs = conv_kernel.conv_work(r, wd, cin, co)
        bms, _ = bound_ms(nb, 2 * macs, BF16_FLOPS)
        k2["ms"] += ms
        k2["plain_ms"] += pms
        k2["library_ms"] += lms
        k2["bound_ms"] += bms
        k2["bytes_s"] += nb / HBM_BPS
        k2["ops_s"] += 2 * macs / BF16_FLOPS
        per_shape.append({"layer": row["layer"], "shape": row["shape"],
                          "affine": row["affine"], "ms": ms, "plain_ms": pms,
                          "library_ms": lms, "bound_ms": bms})
    emit({"phase": "conv_timing", "card": smi, "per_shape": per_shape,
          "frame_ms": k2["ms"], "frame_plain_ms": k2["plain_ms"],
          "frame_library_ms": k2["library_ms"], "frame_bound_ms": k2["bound_ms"],
          "library_call": "F.conv2d(bf16, channels_last, bias) -- conv + bias only"})

    # ---- 7. summary ----
    summary = {"kernels": [
        {"name": "render_megakernel", "route": "cuda",
         "source": "ai_path_tracer_denoiser_tpu_torch/csrc/render_megakernel.cu",
         "replaces": "ai_path_tracer_denoiser_tpu/render/pallas_backend.py:588",
         "launches": launches["render_megakernel"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "conv3x3_act", "route": "cuda",
         "source": "ai_path_tracer_denoiser_tpu_torch/csrc/conv3x3_act.cu",
         "replaces": "ai_path_tracer_denoiser_tpu/models/conv_kernel.py:287",
         "launches": launches["conv3x3_act"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "bytes" if k2["bytes_s"] >= k2["ops_s"] else "operations",
         "library_ms": k2["library_ms"]},
    ]}
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump({"card": smi, **summary, "conv_per_shape": per_shape}, f, indent=1)
    emit(summary)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
