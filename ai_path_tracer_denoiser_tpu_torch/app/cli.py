"""Command-line application (counterpart of app/cli.py).

  render       accumulate N spp and save a PNG
  interactive  headless frame loop: per frame orbit the camera, trace 1 spp
               into the G-buffer, denoise with the recurrent network
               (hidden state carried), write the frame

Both run on ``--device cuda`` (the default) or ``--device cpu``; on the
card the render goes through the megakernel (scenes with a mesh over 64
faces: through the plain wavefront with the mesh BVH kernels) and the
denoiser's convs through the fused conv kernel.  The JAX package's other commands, and
``interactive --serve`` / ``--parity-denoise``, are not ported yet
(ROADMAP queue A).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..config import ModelOptions, RenderOptions
from ..utils.device import resolve_device


def _default_model_path():
    """The shipped artifact used when --model is absent (the reference's
    compile-time MODEL_PATH, main.cpp:39)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in ("denoiser_multiscene.npz", "demo_denoiser_cornell.npz"):
        path = os.path.join(root, "artifacts", name)
        if os.path.exists(path):
            return path
    return None


def _load_scene_scaled(path, device, res=None, res_wh=None):
    """Load a scene, re-deriving the camera at --res (square) or --res-wh."""
    from ..scene import load_scene
    from ..scene.camera import derive_camera
    scene = load_scene(path, device=device)
    target = tuple(res_wh) if res_wh else ((res, res) if res else None)
    if target is not None and tuple(scene.camera.resolution) != target:
        cam = scene.camera
        scene = dataclasses.replace(scene, camera=derive_camera(
            target, float(cam.fov[1]), cam.position.numpy(),
            cam.look_at.numpy(), cam.up.numpy()))
    return scene


_FLAGS = ("stream_compaction", "ray_culling", "antialias", "denoise",
          "mesh_normal_view", "fresnels", "dielectric")


def _render_options(args) -> RenderOptions:
    kwargs = {f: getattr(args, f) for f in _FLAGS
              if getattr(args, f, None) is not None}
    for name in ("rng", "mesh_octant_sort", "mesh_sort_cells",
                 "mesh_kernel_lanes", "mesh_kernel_impl"):
        if getattr(args, name, None) is not None:
            kwargs[name] = getattr(args, name)
    return RenderOptions(**kwargs)


class _Clock:
    """Per-phase times: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            return a.elapsed_time(b)
        return (b - a) * 1e3


def cmd_render(args):
    from ..render import render
    from ..utils.imageio import save_png_scaled
    device = resolve_device(args.device)
    scene = _load_scene_scaled(args.scene, device, args.res, args.res_wh)
    spp = args.spp or scene.iterations
    t0 = time.time()
    image, _, _ = render(scene, _render_options(args), num_iterations=spp)
    image = image.flip(1).cpu().numpy()      # un-mirror to display orientation
    out = args.out or scene.image_name
    path = save_png_scaled(out if out.endswith(".png") else out + ".png", image)
    print(f"rendered {spp} spp in {time.time() - t0:.2f}s -> {path}")


def cmd_interactive(args):
    """Headless interactive loop (runCuda, main.cpp:120-168).

    Returns one record per frame: its index, PNG path, whether the
    denoised frame is finite, and the render, denoise and total
    milliseconds (CUDA events on the card).
    """
    if args.serve:
        raise NotImplementedError("interactive --serve (utils/preview.py) is "
                                  "not ported yet (ROADMAP queue A)")
    if args.parity_denoise:
        raise NotImplementedError("interactive --parity-denoise (the train "
                                  "graph, models/autoencoder.py:apply_frame) "
                                  "is not ported yet (ROADMAP queue A)")
    from ..models import (apply_frame_fast_padded, init_autoencoder,
                          init_hidden, load_model, model_options_from_meta,
                          padded_resolution, prepare_inference)
    from ..render import render, render_gbuffer_frame
    from ..scene.camera import orbit_camera, orbit_params_from_camera
    from ..utils.imageio import save_png_scaled

    device = resolve_device(args.device)
    scene = _load_scene_scaled(args.scene, device, args.res, args.res_wh)
    options = _render_options(args)
    w, h = scene.camera.resolution
    model_path = args.model or _default_model_path()
    if model_path and os.path.exists(model_path):
        if not args.model:
            print(f"using default model {model_path}")
        params, bn_state, meta = load_model(model_path, device=device)
        mopts = model_options_from_meta(meta)
    else:
        print("no trained model given; using randomly initialized denoiser")
        mopts = ModelOptions()
        params, bn_state = init_autoencoder(torch.Generator().manual_seed(0),
                                            mopts)
        params = _tree_to(params, device)
        bn_state = _tree_to(bn_state, device)
    if mopts.norm != "batch":
        raise NotImplementedError("group-norm models need the train graph, "
                                  "which is not ported yet (ROADMAP queue A)")
    folded = prepare_inference(params, bn_state, mopts)
    hp, wp = padded_resolution(h, w)
    hidden = init_hidden(1, hp, wp, mopts, dtype=torch.bfloat16, device=device)
    phi, theta, zoom = orbit_params_from_camera(scene.camera)
    os.makedirs(args.out_dir, exist_ok=True)
    gt_spp = (args.spp or scene.iterations) if args.ground_truth else 1
    if args.ground_truth:
        print(f"ground-truth mode: {gt_spp} spp per frame")
    clock = _Clock(device)
    records = []
    t_loop = time.time()
    for frame in range(args.frames):
        if frame:
            phi += args.dphi
        cam = orbit_camera(scene.camera, phi, theta, zoom)
        fscene = dataclasses.replace(scene, camera=cam)
        t0 = clock.mark()
        if args.ground_truth:
            _, gbuffer, _ = render(fscene, options, num_iterations=gt_spp)
        else:
            _, gbuffer, _ = render_gbuffer_frame(fscene, options)
        t1 = clock.mark()
        denoised, hidden = apply_frame_fast_padded(
            folded, gbuffer.permute(1, 2, 0)[None], hidden, mopts)
        t2 = clock.mark()
        out = denoised[0].clamp(0, 1).cpu().numpy()
        base = os.path.join(args.out_dir, f"frame_{frame:04d}")
        path = save_png_scaled(base, out)
        if args.save_arrays:
            np.save(base + "_gbuffer.npy", gbuffer.cpu().numpy())
            np.save(base + "_denoised.npy", denoised[0].cpu().numpy())
        rec = {"frame": frame, "path": path, "finite": bool(np.isfinite(out).all()),
               "render_ms": clock.ms(t0, t1), "denoise_ms": clock.ms(t1, t2),
               "total_ms": clock.ms(t0, t2)}
        records.append(rec)
        print(f"frame {frame}: render {rec['render_ms']:.2f} ms, denoise "
              f"{rec['denoise_ms']:.2f} ms -> {path}")
    if args.frames > 1:
        avg = (time.time() - t_loop) / args.frames
        print(f"{args.frames} frames, {avg * 1e3:.1f} ms/frame sustained "
              f"({1.0 / avg:.1f} fps)")
    return records


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ai_path_tracer_denoiser_tpu_torch.app",
        description="path tracer + recurrent denoiser on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("scene", help="scene .txt file")
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        sp.add_argument("--res", type=int, default=None)
        sp.add_argument("--res-wh", type=int, nargs=2, default=None,
                        metavar=("W", "H"),
                        help="non-square resolution, e.g. --res-wh 1920 1080")
        for flag in _FLAGS:
            name = flag.replace("_", "-")
            sp.add_argument(f"--{name}", dest=flag, action="store_true",
                            default=None)
            sp.add_argument(f"--no-{name}", dest=flag, action="store_false",
                            default=None)
        sp.add_argument("--rng", choices=("parity", "fast"), default=None)
        sp.add_argument("--mesh-octant-sort", dest="mesh_octant_sort",
                        action="store_true", default=None)
        sp.add_argument("--no-mesh-octant-sort", dest="mesh_octant_sort",
                        action="store_false", default=None)
        sp.add_argument("--mesh-sort-cells", dest="mesh_sort_cells",
                        type=int, default=None,
                        help="with octant sort, origin-cell Morton major "
                             "key over N^3 cells (0 = octant only)")
        sp.add_argument("--mesh-kernel-lanes", type=int, default=None,
                        help="the TPU kernels' rays per tile; accepted, no "
                             "effect on the CUDA kernels")
        sp.add_argument("--mesh-kernel-impl",
                        choices=("auto", "v2", "v2p", "v2s", "v3", "binned"),
                        default=None,
                        help="BVH intersection for meshes over 65 faces "
                             "(same image; auto routes by bin count)")

    sp = sub.add_parser("render", help="accumulate N spp and save an image")
    add_common(sp)
    sp.add_argument("--spp", type=int, default=None)
    sp.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("interactive",
                        help="headless 1spp+denoise frame loop (orbit camera)")
    add_common(sp)
    sp.add_argument("--frames", type=int, default=30)
    sp.add_argument("--dphi", type=float, default=0.01)
    sp.add_argument("--model", default=None)
    sp.add_argument("--out-dir", default="frames")
    sp.add_argument("--save-arrays", action="store_true",
                    help="also write each frame's G-buffer (10,H,W) and "
                         "denoised image (H,W,3) as .npy")
    sp.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="live preview (not ported yet)")
    sp.add_argument("--parity-denoise", action="store_true",
                    help="train-graph eval path (not ported yet)")
    sp.add_argument("--ground-truth", action="store_true",
                    help="accumulate the scene's full spp budget (or --spp) "
                         "per frame before denoising")
    sp.add_argument("--spp", type=int, default=None)
    sp.set_defaults(fn=cmd_interactive)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)
