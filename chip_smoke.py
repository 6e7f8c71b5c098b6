#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's five CUDA kernels from csrc/, holds each against its
plain PyTorch version on the card, and drives the main paths through the
CLI's entry point: the interactive 1-spp render + denoise loop at 800x800,
depth 8, with the shipped denoiser, on scenes/cornell_box.txt (render
megakernel + conv kernel: 1 and 28 launches per frame) and on the mesh
scenes cornell_mesh_blob.txt (5,120 faces, per-ray BVH traversal kernel)
and cornell_mesh_statue.txt (81,920 faces, bin subscription + pair kernels;
plain wavefront, so no megakernel launch).  The mesh kernels are checked on
the calls recorded from an actual 800x800 frame of each scene (primary rays
and the first secondary bounce, with their real cull distances and dead
lanes), whole and bit for bit.  It checks that every path went through its kernels
and that the frames are finite and decode, and times each kernel beside
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
        assemble_gbuffer, cuda_backend, init_render_state, mesh_binned,
        mesh_kernel_v2p, render_gbuffer_frame)
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

    # ---- 2. build all five kernels (one nvcc per source, in parallel) ----
    kernels = (cuda_backend.KERNEL, conv_kernel.KERNEL, mesh_kernel_v2p.KERNEL,
               mesh_binned.PHASE1_KERNEL, mesh_binned.PAIR_KERNEL)
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
    require(launches["mesh_bvh_v2p"] == launches["mesh_binned_phase1"]
            == launches["mesh_binned_pair"] == 0, f"mesh launches {launches}")
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

    def record_frame(sc, impl):
        calls = {"v2p": [], "phase1": [], "pair": [], "binned": [], "paths": []}
        with recording(mesh_kernel_v2p, "mesh_intersect_bvh_v2p", calls["v2p"]), \
                recording(mesh_binned, "_phase1", calls["phase1"]), \
                recording(mesh_binned, "_pair_call", calls["pair"]), \
                recording(mesh_binned, "mesh_intersect_binned", calls["binned"],
                          after=lambda: calls["paths"].append(dict(mesh_binned.PATHS))):
            before = dict(mesh_binned.PATHS)
            render_gbuffer_frame(sc, RenderOptions(mesh_kernel_impl=impl))
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
    mesh_err = {"mesh_bvh_v2p": 0.0, "mesh_binned_phase1": 0.0, "mesh_binned_pair": 0.0}
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
                paths = dict(mesh_binned.PATHS)
                whole = flat_hit(mesh_binned.mesh_intersect_binned(*b_args, **caps))
                took = {k: mesh_binned.PATHS[k] - paths[k] for k in paths}
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
        for call, args in enumerate(rec["binned"]["phase1"][:4]):
            o, d, tc, bounds, kb_, skip, c_out = args
            got = mesh_binned._phase1(*args)
            want, plain_ms = wall_ms(lambda: mesh_binned._phase1_plain(*args))
            equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            err = max_abs_diff(got, want)
            mesh_err["mesh_binned_phase1"] = max(mesh_err["mesh_binned_phase1"], err)
            emit({"phase": "mesh_phase1_check", "scene": name, "call": call,
                  "rays": tc.shape[0], "bins": kb_, "skip": skip, "c_out": c_out,
                  "max_count": int(want[1].max()), "bitwise_equal": equal,
                  "max_abs_err": err, "plain_ms": plain_ms,
                  "bar": "slots and counts equal as integers on every ray of the call"})
            require(equal and int(want[1].max()) > 0, f"phase-1 kernel vs plain on {name}")
        for call, args in enumerate(rec["binned"]["pair"][:2]):
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
            require(equal and int((want[1] >= 0).sum()) > 0,
                    f"pair kernel vs plain on {name}, call {call}")

    # ---- 8. the mesh paths: interactive 800x800, depth 8, shipped model ----
    box_depth = render_gbuffer_frame(frame0, opts)[1][6].cpu().numpy()
    mesh_launches = {}
    for name, path in MESH_SCENES.items():
        for k in kernels:
            k.launches = 0
        mesh_binned.PATHS.update(fast=0, fallback=0)
        out_dir = os.path.join(OUT_DIR, f"frames_{name}")
        records = cli.main(["interactive", path, "--frames", str(MESH_FRAMES),
                            "--model", MODEL, "--out-dir", out_dir, "--save-arrays"])
        counts = {k.name: k.launches for k in kernels}
        paths = dict(mesh_binned.PATHS)
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
    # them.  K4 at the blob's frame (its main path), K5 and K6 at the statue's.
    # The plain version is timed on the same calls, once each, whole.
    def time_calls(fn, calls, reps=5):
        return [time_ms(lambda a=a: fn(*a), reps, warmup=1) for a in calls]

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
    mesh_rows["mesh_bvh_v2p"] = (ms4, bound4, plain4)
    st = recorded["statue"]["binned"]
    ms5 = time_calls(mesh_binned._phase1, st["phase1"])
    bound5 = []
    for o, d, tc, bounds, kb_, skip, c_out in st["phase1"]:
        nb, slab_tests = mesh_binned.phase1_work(tc.shape[0], kb_, c_out)
        bound5.append((nb, slab_tests * OPS_AABB))
    mesh_rows["mesh_binned_phase1"] = (ms5, bound5,
                                       plain_calls(mesh_binned._phase1_plain, st["phase1"]))
    ms6 = time_calls(mesh_binned._pair_call, st["pair"])
    bound6 = []
    for o, d, key, faces, kb_ in st["pair"]:
        nb, face_tests = mesh_binned.pair_work(key, kb_, faces.shape[0])
        bound6.append((nb, face_tests * OPS_TRIANGLE))
    mesh_rows["mesh_binned_pair"] = (ms6, bound6,
                                     plain_calls(mesh_binned._pair_plain, st["pair"]))
    mesh_summary = {}
    for kname, (ms_list, work, plain_list) in mesh_rows.items():
        bounds_ms = [bound_ms(nb, ops, FP32_FLOPS) for nb, ops in work]
        t_bytes = sum(nb for nb, _ in work) / HBM_BPS
        t_ops = sum(ops for _, ops in work) / FP32_FLOPS
        mesh_summary[kname] = {
            "ms": sum(ms_list), "bound_ms": sum(b for b, _ in bounds_ms),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "plain_ms": sum(plain_list)}
        emit({"phase": "mesh_timing", "kernel": kname, "card": smi,
              "scene": "blob" if kname == "mesh_bvh_v2p" else "statue",
              "launches_per_frame": len(ms_list), "per_launch_ms": ms_list,
              "frame_ms": sum(ms_list),
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
    def busy_ms(fn):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
                       for e in prof.key_averages())
        require(total_us > 0, "the profiler reported device time")
        return total_us / 1e3

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

    # ---- 11. summary ----
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
    ] + [
        {"name": kname, "route": "cuda",
         "source": f"ai_path_tracer_denoiser_tpu_torch/csrc/{kname}.cu",
         "replaces": replaces, "launches": mesh_launches[scene_][kname],
         "max_abs_err": mesh_err[kname], **mesh_summary[kname], "library_ms": None}
        for kname, replaces, scene_ in (
            ("mesh_bvh_v2p",
             "ai_path_tracer_denoiser_tpu/render/mesh_kernel_v2p.py:228", "blob"),
            ("mesh_binned_phase1",
             "ai_path_tracer_denoiser_tpu/render/mesh_binned.py:222", "statue"),
            ("mesh_binned_pair",
             "ai_path_tracer_denoiser_tpu/render/mesh_binned.py:356", "statue"))
    ]}
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump({"card": smi, **summary, "conv_per_shape": per_shape}, f, indent=1)
    emit(summary)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
