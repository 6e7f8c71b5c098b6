"""Command-line application (counterpart of app/cli.py).

  render       accumulate N spp and save a PNG (and an HDR, the G-buffer)
  interactive  headless frame loop: per frame orbit the camera, trace 1 spp
               into the G-buffer, denoise with the recurrent network
               (hidden state carried; --denoiser kpcn: the kernel-predicting
               network), write the frame (and stream it live with --serve)
  datagen      render (1-spp G-buffer, high-spp ground truth) training pairs,
               of the scene and of randomized variants of it
  randomize    write randomized scene variants
  preprocess   PNG directories -> npy training pairs (host only)
  train        train the denoiser on such a corpus
  eval         [input | prediction | ground truth] strips
  export       checkpoint -> deployable model artifact
  bench        per-scene timing harness: N iterations of each scene given

All run on ``--device cuda`` (the default; ``--platform`` is the same
flag under the JAX CLI's name) or ``--device cpu``; on the card the render
goes through the megakernel (scenes with a mesh over 64 faces: through the
plain wavefront with the mesh BVH kernels), the denoiser's convs through
the fused conv kernels, and training's convs through the tile kernel
forward and backward.  ``train --data-parallel`` splits each batch over
the ranks of a ``torch.distributed`` world (parallel/): run it under
``torchrun --nproc-per-node N`` (one card per rank, NCCL), or alone as a
world of one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from ..config import KPCNOptions, ModelOptions, RenderOptions
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


_FLAGS = ("stream_compaction", "sort_material", "cache_first_bounce",
          "ray_culling", "antialias", "motion_blur", "denoise",
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
    """Accumulate N spp; write the PNG and, with ``--hdr`` /
    ``--save-gbuffer``, the Radiance HDR and the (10, H, W) G-buffer.
    Returns {"png", "hdr", "gbuffer"}: the paths written (None where not)."""
    from ..render import render
    from ..utils.imageio import save_hdr, save_png_scaled
    device = resolve_device(args.device)
    scene = _load_scene_scaled(args.scene, device, args.res, args.res_wh)
    spp = args.spp or scene.iterations
    t0 = time.time()
    image, gbuffer, _ = render(scene, _render_options(args), num_iterations=spp)
    image = image.flip(1).cpu().numpy()      # un-mirror to display orientation
    out = args.out or scene.image_name
    written = {"png": save_png_scaled(out if out.endswith(".png") else out + ".png",
                                      image),
               "hdr": None, "gbuffer": None}
    if args.hdr:
        written["hdr"] = save_hdr(out.replace(".png", ""), image)
    if args.save_gbuffer:
        written["gbuffer"] = out.replace(".png", "") + "_gbuffer.npy"
        np.save(written["gbuffer"], gbuffer.cpu().numpy())
    print(f"rendered {spp} spp in {time.time() - t0:.2f}s -> {written['png']}")
    return written


def _rdae_denoiser(args, device, h, w):
    """``interactive``'s recurrent denoiser: (denoise(gbuffer, hidden) ->
    (frame, hidden), the hidden state at zero)."""
    from ..models import (apply_frame, apply_frame_fast_padded,
                          init_autoencoder, init_hidden, load_model,
                          model_options_from_meta, padded_resolution,
                          prepare_inference)
    from ..models.inference import edge_pad
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
    hp, wp = padded_resolution(h, w)
    if args.parity_denoise or mopts.norm != "batch":
        # train-graph eval mode: the norms applied as they are each frame
        # (group-norm models have no running statistics to fold)
        hidden = init_hidden(1, hp, wp, mopts, device=device)

        def denoise(gbuffer, hd):
            x = edge_pad(gbuffer.permute(1, 2, 0)[None], hp, wp)
            with torch.no_grad():
                y, hd, _ = apply_frame(params, bn_state, x, hd, train=False,
                                       bf16=True, options=mopts)
            return y[:, :h, :w, :], hd
    else:
        # deployment path: BatchNorm folded into the convs, bfloat16
        folded = prepare_inference(params, bn_state, mopts)
        hidden = init_hidden(1, hp, wp, mopts, dtype=torch.bfloat16,
                             device=device)

        def denoise(gbuffer, hd):
            return apply_frame_fast_padded(
                folded, gbuffer.permute(1, 2, 0)[None], hd, mopts,
                conv_impl=args.conv_impl)
    return denoise, hidden


def _kpcn_denoiser(args, device):
    """``interactive``'s kernel-predicting denoiser (models/kpcn.py): no
    hidden state; weights drawn from seed 0, as no trained KPCN exists."""
    from ..models import apply_kpcn_frame, init_kpcn
    if args.model:
        raise SystemExit("--model loads an RDAE checkpoint; --denoiser kpcn draws its "
                         "weights from seed 0")
    kopts = KPCNOptions()
    params = init_kpcn(0, kopts, device)

    def denoise(gbuffer, hd):
        return apply_kpcn_frame(params, gbuffer, kopts), None
    return denoise, None


def cmd_interactive(args):
    """Headless interactive loop (runCuda, main.cpp:120-168).

    Per frame: the camera orbits (or follows ``--serve``'s viewer input),
    a 1-spp render fills the G-buffer, the denoiser turns it into the
    frame.  Frames are emitted one behind: frame i-1 is fetched, written
    and pushed to the preview only after frame i's render and denoise are
    dispatched, so the copy back and the host's PNG encode run while the
    card works (on the card each frame's copy goes into one of two sets of
    page-locked buffers, ordered by an event).

    Returns one record per frame: its index, PNG path, whether the
    denoised frame is finite, the render, denoise and total milliseconds
    (CUDA events on the card) and ``emitted_s``, the host clock
    (``time.perf_counter``) when it was written.
    """
    from ..render import render, render_gbuffer_frame
    from ..scene.camera import orbit_camera, orbit_params_from_camera
    from ..utils.imageio import save_png_scaled

    device = resolve_device(args.device)
    scene = _load_scene_scaled(args.scene, device, args.res, args.res_wh)
    options = _render_options(args)
    w, h = scene.camera.resolution
    if args.denoiser == "kpcn":
        denoise, hidden = _kpcn_denoiser(args, device)
    else:
        denoise, hidden = _rdae_denoiser(args, device, h, w)
    phi, theta, zoom = orbit_params_from_camera(scene.camera)
    os.makedirs(args.out_dir, exist_ok=True)
    server = None
    if args.serve:
        # live preview stream: the headless stand-in for the reference's
        # GL window and imshow (preview.cpp:174-203, main.cpp:89-100)
        from ..utils.preview import PreviewServer
        server = PreviewServer(port=args.serve, host=args.serve_host)
        print(f"live preview at http://{args.serve_host}:{server.port}/")
    gt_spp = (args.spp or scene.iterations) if args.ground_truth else 1
    if args.ground_truth:
        print(f"ground-truth mode: {gt_spp} spp per frame")
    clock = _Clock(device)
    on_card = device.type == "cuda"
    host = None                    # on the card: two sets of page-locked buffers
    records = []

    def fetch(frame, gbuffer, denoised, marks):
        """Queue the frame's copy back (on the card: into buffer set
        frame % 2, then an event); returns what ``emit`` needs."""
        nonlocal host
        arrays = {"out": denoised[0].clamp(0, 1)}
        if args.save_arrays:
            arrays.update(gbuffer=gbuffer, denoised=denoised[0])
        if not on_card:
            return frame, arrays, marks, None
        if host is None:
            host = [{k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                     for k, v in arrays.items()} for _ in range(2)]
        bufs = host[frame % 2]
        for k, v in arrays.items():
            bufs[k].copy_(v, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return frame, bufs, marks, ready

    def emit(frame, arrays, marks, ready):
        if ready is not None:
            ready.synchronize()
        out = arrays["out"].numpy()
        if server is not None:
            server.push(out)
        base = os.path.join(args.out_dir, f"frame_{frame:04d}")
        path = save_png_scaled(base, out)
        if args.save_arrays:
            np.save(base + "_gbuffer.npy", arrays["gbuffer"].numpy())
            np.save(base + "_denoised.npy", arrays["denoised"].numpy())
        t0, t1, t2 = marks
        rec = {"frame": frame, "path": path, "finite": bool(np.isfinite(out).all()),
               "render_ms": clock.ms(t0, t1), "denoise_ms": clock.ms(t1, t2),
               "total_ms": clock.ms(t0, t2), "emitted_s": time.perf_counter()}
        records.append(rec)
        print(f"frame {frame}: render {rec['render_ms']:.2f} ms, denoise "
              f"{rec['denoise_ms']:.2f} ms -> {path}")

    pending = None
    t_loop = time.time()
    try:
        for frame in range(args.frames):
            if frame:
                phi += args.dphi
            if server is not None:
                # orbit input from the preview page (the mouse and key
                # callbacks' headless analogue, main.cpp:169-223)
                cam_in = server.pop_camera()
                phi = cam_in.get("phi", phi) + cam_in.get("dphi", 0.0)
                theta = cam_in.get("theta", theta) + cam_in.get("dtheta", 0.0)
                zoom = cam_in.get("zoom", zoom) + cam_in.get("dzoom", 0.0)
                theta = min(max(theta, 1e-3), math.pi - 1e-3)
                zoom = max(zoom, 0.1)
            cam = orbit_camera(scene.camera, phi, theta, zoom)
            fscene = dataclasses.replace(scene, camera=cam)
            t0 = clock.mark()
            if args.ground_truth:
                _, gbuffer, _ = render(fscene, options, num_iterations=gt_spp)
            else:
                _, gbuffer, _ = render_gbuffer_frame(fscene, options)
            t1 = clock.mark()
            denoised, hidden = denoise(gbuffer, hidden)
            t2 = clock.mark()
            fetched = fetch(frame, gbuffer, denoised, (t0, t1, t2))
            if pending is not None:
                emit(*pending)
            pending = fetched
        if pending is not None:
            emit(*pending)
    finally:
        if server is not None:
            server.close()
    if args.frames > 1:
        avg = (time.time() - t_loop) / args.frames
        print(f"{args.frames} frames, {avg * 1e3:.1f} ms/frame sustained "
              f"({1.0 / avg:.1f} fps)")
    return records


def _rescale(scene, res):
    from ..scene.camera import derive_camera
    cam = scene.camera
    return dataclasses.replace(scene, camera=derive_camera(
        (res, res), float(cam.fov[1]), cam.position.numpy(),
        cam.look_at.numpy(), cam.up.numpy()))


def cmd_datagen(args):
    """Render a training corpus: the scene, then ``--variants`` randomized
    copies of it (``scene/randomizer.py``, drawn from ``--seed``)."""
    from ..data import generate_training_data
    from ..scene import load_scene, parse_scene_text
    from ..scene.randomizer import generate_variants
    device = resolve_device(args.device)
    scenes = [load_scene(args.scene, device=device)]
    if args.variants:
        with open(args.scene) as f:
            template = f.read()
        base_dir = os.path.dirname(os.path.abspath(args.scene))
        for text in generate_variants(template, args.variants, args.seed):
            scenes.append(parse_scene_text(text, base_dir=base_dir,
                                           device=device))
    if args.res:
        scenes = [_rescale(s, args.res) for s in scenes]
    return generate_training_data(
        scenes, args.out_dir, frames_per_scene=args.frames,
        gt_spp=args.gt_spp, noise_seeds=args.noise_seeds, movs=args.movs,
        quantize=args.quantize or None,
        options=_render_options(args), png_dump=args.png_dump)


def cmd_randomize(args):
    """Write ``--count`` randomized variants of a scene file as
    ``scene_{i}.txt`` (i from 1); returns their paths."""
    from ..scene.randomizer import generate_variants
    with open(args.scene) as f:
        template = f.read()
    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for i, text in enumerate(generate_variants(template, args.count, args.seed)):
        path = os.path.join(args.out_dir, f"scene_{i + 1}.txt")
        with open(path, "w") as f:
            f.write(text)
        print(path)
        paths.append(path)
    return paths


def cmd_preprocess(args):
    """PNG directories -> npy training pairs, on the host (needs cv2 or PIL)."""
    from ..data import preprocess_png_dirs
    return preprocess_png_dirs(args.root, args.rgb, args.depth, args.albedo,
                               args.normal, args.gt, args.size)


def cmd_train(args):
    """Train the denoiser; returns the final train state."""
    from ..config import TrainOptions
    from ..data import SequenceDataset, sequence_batches
    from ..train import (MetricsLogger, checkpoint_epoch, fit, fit_device_data,
                         init_train_state, latest_checkpoint, load_checkpoint,
                         save_checkpoint)
    mesh = None
    if args.data_parallel:
        if args.device_data:
            raise ValueError("--device-data keeps the whole corpus on one "
                             "device; it does not split over --data-parallel")
        from ..parallel.mesh import make_mesh, mesh_device
        mesh = make_mesh(device=args.device)
        device = mesh_device(mesh)
    else:
        device = resolve_device(args.device)
    topt = TrainOptions(lr=args.lr, epochs=args.epochs,
                        crop_size=args.crop_size, batch_size=args.batch_size)
    mopt = ModelOptions.tpu_friendly() if args.tpu_friendly else ModelOptions()
    state = init_train_state(torch.Generator().manual_seed(topt.seed), mopt,
                             topt, device=device)
    resume_epoch = None
    if args.resume:
        ckpt = latest_checkpoint(args.model_dir)
        if ckpt:
            state = load_checkpoint(ckpt, state)
            resume_epoch = checkpoint_epoch(ckpt)
            print(f"resumed from {ckpt} at step {state.step}, "
                  f"epoch {resume_epoch}")
            if resume_epoch is not None and resume_epoch >= 2 ** 30:
                # 'final': the previous run completed its schedule; a larger
                # --epochs extends it from the step-count epoch inference
                print("checkpoint is a completed run's 'final'; extending: "
                      "falling back to step-count epoch inference")
                resume_epoch = None
    # Window boundaries come from the filenames themselves (the dataset
    # builds its per-(scene, mov, noise) table).
    dataset = SequenceDataset(os.path.join(args.data_dir, "input"),
                              os.path.join(args.data_dir, "gt"),
                              crop=args.crop_size > 0, crop_size=args.crop_size)
    # one sequence per rank under --data-parallel: the batch is the data size
    batch_size, group, lead = topt.batch_size, None, True
    if mesh is not None:
        import torch.distributed as dist

        from ..parallel.dp import local_batch
        from ..parallel.mesh import axis_size
        batch_size, group = axis_size(mesh, "data"), mesh.get_group("data")
        lead = dist.get_rank() == 0
        if lead:
            print(f"data-parallel over {batch_size} devices")
    start_ep = resume_epoch
    if start_ep is None:
        steps_per_epoch = max(1, len(dataset) // batch_size)
        start_ep = state.step // steps_per_epoch
        if state.step and lead:
            print(f"warning: checkpoint lacks an epoch record; inferred "
                  f"start epoch {start_ep} from step count (wrong if the "
                  f"corpus or batch size changed)")

    def batches(epoch):
        for x, y in sequence_batches(dataset, batch_size=batch_size, seed=epoch):
            yield (x, y) if group is None else local_batch(x, y, mesh)

    # rank 0 alone logs, prints and writes checkpoints
    logger = MetricsLogger(args.log_dir) if lead else None
    common = dict(epochs=args.epochs, logger=logger, log_every=args.log_every,
                  checkpoint_fn=(lambda s, e: save_checkpoint(args.model_dir, s, e))
                  if lead else None,
                  model_options=mopt, start_epoch=start_ep)
    quiet = contextlib.nullcontext() if lead else contextlib.redirect_stdout(None)
    try:
        with quiet:
            if args.device_data:
                return fit_device_data(state, dataset, topt, **common)
            return fit(state, batches, topt, axis_name=group, **common)
    finally:
        if logger is not None:
            logger.close()


def _load_any_model(path, norm, device):
    """(params, bn_state, ModelOptions) from a train checkpoint
    (``model_<epoch>.npz``) or an exported artifact."""
    from ..models import (load_model, model_options_from_meta,
                          model_options_from_params)
    from ..train import load_checkpoint
    if path.endswith(".npz") and "model_" in os.path.basename(path):
        state = load_checkpoint(path, device=device)
        # widths come from the checkpoint's own shapes; the norm is not
        # recoverable from them -> --norm
        return state.params, state.bn_state, model_options_from_params(
            state.params, norm=norm)
    params, bn_state, meta = load_model(path, device=device)
    return params, bn_state, model_options_from_meta(meta)


def cmd_eval(args):
    """[noisy input | prediction | ground truth] strips -> GIF (test.py:36-55).
    Returns the strips as uint8 arrays."""
    from ..data import SequenceDataset
    from ..models import apply_frame, init_hidden
    from ..utils.imageio import save_png_scaled
    device = resolve_device(args.device)
    params, bn_state, mopts = _load_any_model(args.model, args.norm, device)
    dataset = SequenceDataset(os.path.join(args.data_dir, "input"),
                              os.path.join(args.data_dir, "gt"), None)
    frames = []
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(0, len(dataset), 7):
        x, y = dataset[i]
        t, h, w, _ = x.shape
        hidden = init_hidden(1, h, w, mopts, device=device)
        for j in range(t):
            with torch.no_grad():
                pred, hidden, _ = apply_frame(
                    params, bn_state, torch.from_numpy(x[j:j + 1]).to(device),
                    hidden, train=False, options=mopts)
            strip = np.concatenate([
                np.clip(x[j, :, :, :3], 0, 1),
                np.clip(pred[0].cpu().numpy(), 0, 1),
                np.clip(y[j], 0, 1)], axis=1)
            frames.append((strip * 255).astype(np.uint8))
        if args.max_sequences and len(frames) >= args.max_sequences * 7:
            break
    gif_path = os.path.join(args.out_dir, "network_output.gif")
    try:
        import imageio
    except ImportError:
        for k, fr in enumerate(frames):
            save_png_scaled(os.path.join(args.out_dir, f"strip_{k:04d}"),
                            fr / 255.0)
        print(f"imageio unavailable; wrote {len(frames)} PNG strips")
    else:
        imageio.mimsave(gif_path, frames)
        print(f"wrote {gif_path} ({len(frames)} frames)")
    return frames


def cmd_export(args):
    """Checkpoint -> deployable artifact (convert_to_torchscript.py analogue)."""
    from ..models import model_options_from_params, save_model
    from ..train import load_checkpoint
    # params/bn_state come wholly from the file (host tensors are enough);
    # the exported widths metadata is derived from their shapes.
    state = load_checkpoint(args.checkpoint, device="cpu")
    mopt = model_options_from_params(state.params, norm=args.norm)
    save_model(args.out, state.params, state.bn_state, options=mopt)
    print(f"exported {args.out} (widths {mopt.widths}, norm {mopt.norm})")
    return args.out


def cmd_bench(args):
    """Per-scene timing harness (the reference's cornell_timing scenes and
    TIME flag).  Per scene: a 2-iteration warm-up render, then ``--iters``
    iterations on the host clock, the device drained before and after.
    Returns {scene file: milliseconds}."""
    from ..render import render
    from ..utils.debug import profile_trace
    device = resolve_device(args.device)

    def drain():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = {}
    for scene_path in args.scenes:
        scene = _load_scene_scaled(scene_path, device, args.res, args.res_wh)
        options = _render_options(args)
        render(scene, options, num_iterations=2)
        drain()
        ctx = (profile_trace(args.profile) if args.profile
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            render(scene, options, num_iterations=args.iters)
            drain()
            dt = (time.perf_counter() - t0) * 1e3
        results[os.path.basename(scene_path)] = round(dt, 1)
        print(f"{scene_path}: {args.iters} iterations in {dt:.1f} ms")
    print(json.dumps(results))
    return results


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ai_path_tracer_denoiser_tpu_torch.app",
        description="path tracer + recurrent denoiser on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", "--platform", dest="device",
                        choices=("cuda", "cpu"), default="cuda")

    def add_common(sp, scene=True):
        if scene:
            sp.add_argument("scene", help="scene .txt file")
        add_device(sp)
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
                        help="rays per tile (CUDA block) of --mesh-kernel-impl "
                             "v2 on secondary bounces: a multiple of 128 up "
                             "to 1024")
        sp.add_argument("--mesh-kernel-impl",
                        choices=("auto", "v2", "v2p", "v2s", "v3", "binned"),
                        default=None,
                        help="BVH intersection for meshes over 65 faces "
                             "(same image; auto routes by bin count)")

    sp = sub.add_parser("render", help="accumulate N spp and save an image")
    add_common(sp)
    sp.add_argument("--spp", type=int, default=None)
    sp.add_argument("--out", default=None)
    sp.add_argument("--hdr", action="store_true",
                    help="also write a Radiance .hdr of the image")
    sp.add_argument("--save-gbuffer", action="store_true",
                    help="also write the (10,H,W) G-buffer as <out>_gbuffer.npy")
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
    sp.add_argument("--serve-host", default="127.0.0.1",
                    help="preview bind address (default loopback only)")
    sp.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="stream frames live over HTTP (MJPEG, or PNG "
                         "parts without PIL) on PORT")
    sp.add_argument("--parity-denoise", action="store_true",
                    help="run the train-graph eval path instead of the "
                         "BN-folded bfloat16 deployment path")
    sp.add_argument("--conv-impl", default="auto",
                    choices=("auto", "pallas2", "pallas"),
                    help="conv kernel of the deployment path: the tile "
                         "kernel (auto, pallas2) or the row-band kernel "
                         "(pallas)")
    sp.add_argument("--denoiser", default="rdae", choices=("rdae", "kpcn"),
                    help="the recurrent autoencoder (rdae, hidden state "
                         "carried) or the kernel-predicting network of Bako "
                         "et al. 2017 (kpcn: K11 convs, K12 apply; weights "
                         "from seed 0)")
    sp.add_argument("--ground-truth", action="store_true",
                    help="accumulate the scene's full spp budget (or --spp) "
                         "per frame before denoising")
    sp.add_argument("--spp", type=int, default=None)
    sp.set_defaults(fn=cmd_interactive)

    sp = sub.add_parser("datagen", help="generate training data")
    add_common(sp)
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--frames", type=int, default=60)
    sp.add_argument("--gt-spp", type=int, default=512)
    sp.add_argument("--noise-seeds", type=int, default=1)
    sp.add_argument("--movs", type=int, default=2,
                    help="camera pans per scene (reference 'mov' axis)")
    sp.add_argument("--quantize", default="", choices=("u8", ""),
                    help="store npy as uint8 (reference 8-bit regime)")
    sp.add_argument("--variants", type=int, default=0,
                    help="also render N randomized variants of the scene")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--png-dump", action="store_true")
    sp.set_defaults(fn=cmd_datagen)

    sp = sub.add_parser("randomize", help="write randomized scene variants")
    sp.add_argument("scene")
    sp.add_argument("--count", type=int, default=30)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out-dir", default="scenes_generated")
    sp.set_defaults(fn=cmd_randomize)

    sp = sub.add_parser("preprocess", help="PNG dirs -> npy training pairs")
    sp.add_argument("--root", required=True)
    sp.add_argument("--rgb", required=True)
    sp.add_argument("--depth", required=True)
    sp.add_argument("--albedo", required=True)
    sp.add_argument("--normal", required=True)
    sp.add_argument("--gt", required=True)
    sp.add_argument("--size", type=int, default=512)
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("train", help="train the denoiser")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--model-dir", default="models_out")
    sp.add_argument("--log-dir", default="logs")
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--crop-size", type=int, default=256)
    sp.add_argument("--batch-size", type=int, default=1)
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--data-parallel", action="store_true",
                    help="one sequence per rank of a torch.distributed world "
                         "(torchrun --nproc-per-node N; alone: a world of one)")
    sp.add_argument("--tpu-friendly", action="store_true",
                    help="the JAX package's widths (32, 48, 64, 80, 104)")
    sp.add_argument("--device-data", action="store_true",
                    help="keep the whole corpus on the device and crop "
                         "there (train/device_data.py)")
    sp.add_argument("--log-every", type=int, default=5)
    add_device(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval", help="render comparison strips / GIF")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--model", required=True)
    sp.add_argument("--out-dir", default="eval_out")
    sp.add_argument("--max-sequences", type=int, default=8)
    sp.add_argument("--norm", default="batch", choices=("batch", "group"),
                    help="norm layer of a raw checkpoint (unrecoverable "
                         "from its shapes; .npz artifacts carry it in meta)")
    add_device(sp)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("export", help="checkpoint -> deployable .npz")
    sp.add_argument("checkpoint")
    sp.add_argument("--out", default="model_deploy.npz")
    sp.add_argument("--norm", default="batch", choices=("batch", "group"),
                    help="norm layer the checkpoint was trained with "
                         "(unrecoverable from shapes; written to meta)")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("bench", help="per-scene timing harness")
    add_common(sp, scene=False)
    sp.add_argument("scenes", nargs="+")
    sp.add_argument("--iters", type=int, default=500)
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the timed run")
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)
