"""Training-data generation on the device, no PNG round trip (counterpart
of data/datagen.py).

For each frame along an orbit pan the port's renderer (the render
megakernel on the card) traces the 1-spp G-buffer and the high-spp ground
truth, and float32 npy pairs are written: input (H, W, 10), gt (H, W, 3).

Filenames follow the reference scheme ``{scene}_{mov}_{noise}_{frame}.npy``
so the dataset/loader (dataloader.py semantics) applies unchanged.  An
optional PNG dump reproduces the reference's directory layout
(RGB/Normals/Depth/Albedos/GroundTruth) for interop.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np

from ..config import RenderOptions
from ..render import init_render_state, render
from ..scene.camera import orbit_camera, orbit_params_from_camera
from ..scene.structs import Scene
from ..utils.imageio import save_png_scaled


def encode_u8_input(x: np.ndarray) -> np.ndarray:
    """(H, W, 10) float32 G-buffer -> uint8: an 8-bit storage regime in the
    spirit of the reference's PNG round trip (train.sh writes 8-bit PNGs).
    RGB/albedo [0,1]*255, normals [-1,1] affine to [0,255], depth /10
    clamped; ``dataset.decode_u8_input`` inverts it, so training sees the
    same value ranges as the unquantized float path."""
    u = np.empty(x.shape, np.uint8)
    u[..., 0:3] = np.clip(x[..., 0:3], 0, 1) * 255.0 + 0.5
    u[..., 3:6] = (np.clip(x[..., 3:6], -1, 1) * 0.5 + 0.5) * 255.0 + 0.5
    u[..., 6:7] = np.clip(x[..., 6:7] / 10.0, 0, 1) * 255.0 + 0.5
    u[..., 7:10] = np.clip(x[..., 7:10], 0, 1) * 255.0 + 0.5
    return u


def encode_u8_gt(y: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 [0,1] ground truth -> uint8 (the reference's GT is
    8-bit PNG too, preprocess.py:41)."""
    return (np.clip(y, 0, 1) * 255.0 + 0.5).astype(np.uint8)


def _gbuffer_to_input(gbuf: np.ndarray, clamp_rgb: bool = True) -> np.ndarray:
    """(10, H, W) CHW -> (H, W, 10) HWC float32 training input.

    Native scaling: RGB/albedo clamped to [0,1], normals raw in [-1,1],
    depth raw world units.
    """
    x = np.array(np.moveaxis(np.asarray(gbuf, np.float32), 0, -1))
    if clamp_rgb:
        x[..., 0:3] = np.clip(x[..., 0:3], 0.0, 1.0)
        x[..., 7:10] = np.clip(x[..., 7:10], 0.0, 1.0)
    return x


def _stem(scene_idx, mov, noise, frame) -> str:
    # zero-padded fields: lexicographic order == temporal order
    return f"{scene_idx:03d}_{mov}_{noise}_{frame:04d}"


def generate_training_data(
        scenes: Sequence[Scene], out_dir: str,
        frames_per_scene: int = 60,
        gt_spp: int = 512,
        noise_seeds: int = 1,
        movs: int = 2,
        options: RenderOptions = RenderOptions(),
        dphi: float = 0.01,
        png_dump: bool = False,
        quantize: Optional[str] = None,
        progress: bool = True):
    """Render (input, gt) npy pairs for every scene/pan/noise/frame.

    For each frame along an orbit pan: one 1-spp iteration fills the input
    G-buffer; ``gt_spp`` accumulation renders the converged target.  The
    noise-seed axis offsets the RNG stream of the 1-spp input; the ``movs``
    axis is the reference's camera-pan axis (train.sh:13-30): mov 0 orbits
    forward (phi + dphi*frame), mov 1 orbits in reverse with a slow theta
    drift, further pans get trajectories of their own.  Scenes render on
    the device their tensors live on.
    """
    input_dir = os.path.join(out_dir, "input")
    gt_dir = os.path.join(out_dir, "gt")
    os.makedirs(input_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    if png_dump:
        for sub in ("RGB", "Normals", "Depth", "Albedos", "GroundTruth"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    if quantize not in (None, "u8"):
        raise ValueError(f"quantize={quantize!r}")
    # Refuse to resume into a corpus written under another quantize mode:
    # the resume-skip would leave a mixed f32/u8 directory that corrupts
    # the device-resident loader's single-dtype upload.
    want = np.uint8 if quantize == "u8" else np.float32
    for name in sorted(os.listdir(input_dir)):
        if name.endswith(".npy"):
            have = np.load(os.path.join(input_dir, name), mmap_mode="r").dtype
            if have != want:
                raise ValueError(
                    f"{input_dir} already holds {have} frames but this run "
                    f"would write {np.dtype(want)} (quantize={quantize!r}); "
                    "use a fresh out_dir or matching --quantize")
            break
    for scene_idx, scene in enumerate(scenes):
        phi, theta, zoom = orbit_params_from_camera(scene.camera)
        for mov in range(movs):
            for frame in range(frames_per_scene):
                _gen_frame(scene_idx, scene, mov, frame, phi, theta, zoom,
                           input_dir, gt_dir, out_dir, gt_spp, noise_seeds,
                           options, dphi, png_dump, quantize, progress)
    return input_dir, gt_dir


def _gen_frame(scene_idx, scene, mov, frame, phi, theta, zoom,
               input_dir, gt_dir, out_dir, gt_spp, noise_seeds,
               options, dphi, png_dump, quantize, progress):
    # Resume: skip frames whose (input, gt) pairs all exist already.
    stems = [_stem(scene_idx, mov, noise, frame) for noise in range(noise_seeds)]
    done = all(os.path.exists(os.path.join(input_dir, s + ".npy"))
               and os.path.exists(os.path.join(gt_dir, s + ".npy"))
               for s in stems)
    if done and not png_dump:
        return
    if mov == 0:
        cam = orbit_camera(scene.camera, phi + dphi * frame, theta, zoom)
    elif mov == 1:
        # reverse pan + gentle theta drift: a distinct trajectory over the
        # same scene (the reference's second camera pan)
        th = min(max(theta - 0.3 * dphi * frame, 1e-3), math.pi - 1e-3)
        cam = orbit_camera(scene.camera, phi - dphi * frame, th, zoom)
    else:
        # every extra pan gets its own trajectory: alternating direction, a
        # per-mov phi rate and theta drift.  The mov 0/1 formulas above are
        # frozen so existing corpora resume identically.
        sign = -1.0 if mov % 2 else 1.0
        rate = dphi * (1.0 + 0.4 * (mov // 2))
        drift = 0.15 * dphi * mov * (1.0 if mov % 2 else -1.0)
        th = min(max(theta + drift * frame, 1e-3), math.pi - 1e-3)
        cam = orbit_camera(scene.camera, phi + sign * rate * frame, th, zoom)
    fscene = dataclasses.replace(scene, camera=cam)
    # Ground truth: accumulate gt_spp iterations once per frame; the noise
    # axis varies only the 1-spp input's RNG stream.  If any seed's gt file
    # exists already (a resume that widens the noise-seed axis), reuse it:
    # every seed of a frame shares one converged target.
    gt = None
    for s in stems:
        p = os.path.join(gt_dir, s + ".npy")
        if os.path.exists(p):
            prev = np.load(p)
            gt = (prev.astype(np.float32) / 255.0
                  if prev.dtype == np.uint8 else prev)
            break
    if gt is None:
        gt_img, _, _ = render(fscene, options, num_iterations=gt_spp)
        gt = np.clip(gt_img.cpu().numpy().astype(np.float32), 0.0, 1.0)
        if options.flip_horizontal:
            gt = gt[:, ::-1]   # align GT with the flipped G-buffer
    for noise, stem in enumerate(stems):
        if (not png_dump
                and os.path.exists(os.path.join(input_dir, stem + ".npy"))
                and os.path.exists(os.path.join(gt_dir, stem + ".npy"))):
            continue   # seed already rendered (seed-axis-widening resume)
        # rng_offset (not the iteration) carries the variant axes: the true
        # iteration gates the iteration-1 G-buffer write and divides the
        # accumulated radiance.
        state = dataclasses.replace(init_render_state(fscene, options),
                                    rng_offset=noise * 7919 + mov * 104729)
        _, gbuf, _ = render(fscene, options, num_iterations=1, state=state)
        inp = _gbuffer_to_input(gbuf.cpu().numpy())
        if quantize == "u8":
            np.save(os.path.join(input_dir, stem + ".npy"), encode_u8_input(inp))
            np.save(os.path.join(gt_dir, stem + ".npy"), encode_u8_gt(gt))
        else:
            np.save(os.path.join(input_dir, stem + ".npy"), inp)
            np.save(os.path.join(gt_dir, stem + ".npy"), gt)
        if png_dump:
            save_png_scaled(os.path.join(out_dir, "RGB", stem), inp[..., 0:3])
            save_png_scaled(os.path.join(out_dir, "Normals", stem),
                            inp[..., 3:6] * 0.5 + 0.5)
            depth = inp[..., 6:7]
            save_png_scaled(os.path.join(out_dir, "Depth", stem),
                            np.repeat(depth / max(depth.max(), 1e-6), 3, -1))
            save_png_scaled(os.path.join(out_dir, "Albedos", stem),
                            inp[..., 7:10])
            save_png_scaled(os.path.join(out_dir, "GroundTruth", stem), gt)
    if progress:
        print(f"scene {scene_idx} mov {mov} frame {frame} done "
              f"({noise_seeds} noise seeds)")
