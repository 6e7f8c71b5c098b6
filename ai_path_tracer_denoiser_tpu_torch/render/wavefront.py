"""Wavefront path tracer in plain PyTorch (counterpart of render/wavefront.py).

One 1-spp iteration of pathtrace() (pathtrace.cu:422-528) as tensor code
over all pixels at once: ray generation, a depth-0 intersect + shade that
also fills the G-buffer, then the remaining bounces with an alive mask in
place of stream compaction, stopping once every path has ended.  Lane i is
pixel i throughout (no material sort), so the final gather is a plain add.

This is the plain PyTorch version of the megakernel
(render/cuda_backend.py + csrc/render_megakernel.cu): the kernel is held
against it, and it renders whatever the kernel does not take (CPU
tensors, bfloat16 accumulation, ``backend="xla"``).  Material sorting, the
first-bounce cache and motion blur are not ported yet (ROADMAP queue A) and
raise rather than being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import RenderOptions
from ..ops.bsdf import scatter_ray_v
from ..ops.intersect import intersect_scene_v
from ..ops.rng import draw_uniforms
from ..ops.vec3 import Vec3, where as vwhere
from ..scene.structs import Camera, Scene


@dataclasses.dataclass
class RenderLoopState:
    """Per-pixel buffers carried across 1-spp iterations (pathtrace.cu:96-129).

    ``accum``: running radiance sum, (3, N).  ``gbuf``: the static G-buffer
    channels nx, ny, nz, depth, ax, ay, az, (7, N) float32.  ``iteration``
    counts completed iterations; ``rng_offset`` is added to the iteration
    for RNG seeding only (the accumulation average and the iteration-1
    G-buffer gate use the true iteration).  ``segments`` counts the ray
    segments the plain renderer intersected (live rays summed over
    bounces): the work a bound on the megakernel's time is computed from.
    """

    accum: torch.Tensor
    gbuf: torch.Tensor
    iteration: int = 0
    rng_offset: int = 0
    segments: int = 0


def init_render_state(scene: Scene,
                      options: Optional[RenderOptions] = None) -> RenderLoopState:
    w, h = scene.camera.resolution
    acc_dtype = torch.float32
    if options is not None and options.accum_dtype == "bfloat16":
        acc_dtype = torch.bfloat16
    return RenderLoopState(
        accum=torch.zeros((3, w * h), dtype=acc_dtype, device=scene.device),
        gbuf=torch.zeros((7, w * h), dtype=torch.float32, device=scene.device))


def generate_camera_rays_v(camera: Camera, iteration, options: RenderOptions,
                           pixel_ids: torch.Tensor) -> Tuple[Vec3, Vec3]:
    """Per-pixel primary rays with optional AA jitter (pathtrace.cu:155-182).

    The jitter is seeded with depth 0 (see the JAX package's docstring for
    why that is exact parity with the reference).
    """
    w, h = camera.resolution
    x = (pixel_ids % w).to(torch.float32)
    y = torch.div(pixel_ids, w, rounding_mode="floor").to(torch.float32)
    if options.antialias:
        u = draw_uniforms(iteration, pixel_ids, 0, 2, options.rng)
        jx = u[0] - 0.5
        jy = u[1] - 0.5
    else:
        jx = jy = torch.zeros_like(x)
    plx, ply = camera.pixel_length.tolist()
    px = plx * (x - w * 0.5 + jx)
    py = ply * (y - h * 0.5 + jy)
    vx, vy, vz = camera.view.tolist()
    rx, ry, rz = camera.right.tolist()
    ux, uy, uz = camera.up.tolist()
    direction = Vec3(vx - rx * px - ux * py,
                     vy - ry * px - uy * py,
                     vz - rz * px - uz * py).normalized()
    ones = torch.ones_like(x)
    cx, cy, cz = camera.position.tolist()
    origin = Vec3(ones * cx, ones * cy, ones * cz)
    return origin, direction


def _gather_material(scene: Scene, mat_id: torch.Tensor):
    """Per-ray material planes; mat_id == -1 gathers row 0 harmlessly."""
    safe = torch.clamp_min(mat_id, 0).long()
    m = scene.materials
    color, spec = m.color[safe], m.specular_color[safe]
    return dict(
        color=Vec3(color[:, 0], color[:, 1], color[:, 2]),
        specular_color=Vec3(spec[:, 0], spec[:, 1], spec[:, 2]),
        has_reflective=m.has_reflective[safe],
        has_refractive=m.has_refractive[safe],
        index_of_refraction=m.index_of_refraction[safe],
        emittance=m.emittance[safe],
    )


def _shade(scene: Scene, options: RenderOptions, iteration, isect,
           ray_d: Vec3, color: Vec3, remaining: torch.Tensor,
           pixel_ids: torch.Tensor):
    """Branch-free shadeMaterial (pathtrace.cu:333-390).

    Returns (new_ray_o, new_ray_d, new_color, new_remaining).  The RNG is
    keyed on the global pixel id and the *remaining* bounce count.
    """
    u = draw_uniforms(iteration, pixel_ids, remaining, 2, options.rng)
    alive = remaining != 0
    hit = isect["t"] > 0.0
    mat = _gather_material(scene, isect["material_id"])
    emissive = mat["emittance"] > 0.0

    sc_dir, sc_origin, sc_mult = scatter_ray_v(
        ray_d, isect["point"], isect["normal"], mat, u[0], u[1],
        fresnels=options.fresnels, dielectric=options.dielectric,
        mesh_normal_view=options.mesh_normal_view)

    # light hit: color *= emittance * matColor, terminate (pathtrace.cu:358-361)
    emit_color = color * mat["color"] * mat["emittance"]
    scatter_color = color * sc_mult
    upd = alive & hit
    new_color = vwhere(upd & emissive, emit_color,
                       vwhere(upd, scatter_color, color))
    # miss: black + terminate (pathtrace.cu:375-377)
    new_color = vwhere(alive & ~hit, Vec3.full_like(new_color.x, 0.0), new_color)
    new_remaining = torch.where(alive & hit & ~emissive, remaining - 1,
                                torch.where(alive, torch.zeros_like(remaining),
                                            remaining))
    scatter_lanes = upd & ~emissive
    new_ray_d = vwhere(scatter_lanes, sc_dir, ray_d)
    new_ray_o = vwhere(scatter_lanes, sc_origin, Vec3.full_like(sc_origin.x, 0.0))
    return new_ray_o, new_ray_d, new_color, new_remaining


def _check_ported(options: RenderOptions) -> None:
    for flag in ("sort_material", "cache_first_bounce", "motion_blur"):
        if getattr(options, flag):
            raise NotImplementedError(
                f"RenderOptions.{flag} is not ported yet (ROADMAP queue A)")


def trace_iteration(scene: Scene, options: RenderOptions,
                    state: RenderLoopState, pixel_offset: int = 0
                    ) -> RenderLoopState:
    """One full 1-spp path-trace iteration (pathtrace.cu:422-528).

    ``pixel_offset``: first global pixel id of this state's tile (0 for a
    whole frame); the RNG and the pixel split use global ids.
    """
    _check_ported(options)
    n = state.accum.shape[1]
    depth_max = scene.trace_depth
    iteration = state.iteration + 1
    rng_iter = iteration + state.rng_offset
    dev = state.accum.device
    pixel_ids = torch.arange(n, dtype=torch.int64, device=dev) + pixel_offset

    ray_o, ray_d = generate_camera_rays_v(scene.camera, rng_iter, options,
                                          pixel_ids)
    color = Vec3.full_like(ray_d.x, 1.0)
    remaining = torch.full((n,), depth_max, dtype=torch.int32, device=dev)

    def intersect(o, d):
        return intersect_scene_v(scene.geoms, scene.mesh, o, d,
                                 ray_culling=options.ray_culling)

    # ---- depth 0: G-buffer emission (pathtrace.cu:295-304, 379-387) ----
    isect0 = intersect(ray_o, ray_d)
    segments = n
    gbuf = state.gbuf
    write = None
    if options.denoise:
        write = (isect0["t"] >= 0.0) & (iteration == 1)
        nrm = isect0["normal"]
        gbuf = torch.stack([torch.where(write, nrm.x, gbuf[0]),
                            torch.where(write, nrm.y, gbuf[1]),
                            torch.where(write, nrm.z, gbuf[2]),
                            torch.where(write, isect0["t"], gbuf[3]),
                            gbuf[4], gbuf[5], gbuf[6]])
    ray_o, ray_d, color, remaining = _shade(
        scene, options, rng_iter, isect0, ray_d, color, remaining, pixel_ids)
    if options.denoise:
        # albedo = throughput after the first shade
        gbuf = torch.stack([gbuf[0], gbuf[1], gbuf[2], gbuf[3],
                            torch.where(write, color.x, gbuf[4]),
                            torch.where(write, color.y, gbuf[5]),
                            torch.where(write, color.z, gbuf[6])])

    # ---- remaining bounces; stop once every path has ended ----
    for _ in range(depth_max - 1):
        live = int((remaining > 0).sum())
        if live == 0 and options.stream_compaction:
            break
        segments += live
        isect = intersect(ray_o, ray_d)
        ray_o, ray_d, color, remaining = _shade(
            scene, options, rng_iter, isect, ray_d, color, remaining, pixel_ids)

    # finalGather (pathtrace.cu:393-402): lane i is pixel i
    accum = state.accum + color.stack().T.to(state.accum.dtype)
    return RenderLoopState(accum=accum, gbuf=gbuf, iteration=iteration,
                           rng_offset=state.rng_offset,
                           segments=state.segments + segments)


def assemble_gbuffer(state: RenderLoopState, resolution: Tuple[int, int],
                     options: RenderOptions) -> torch.Tensor:
    """The 10-channel CHW tensor (dev_tensor layout, pathtrace.cu:81-94).

    ch0-2 RGB = accum / iteration, ch3-5 normal, ch6 depth, ch7-9 albedo;
    ``flip_horizontal`` reproduces the reference's mirrored layout.
    """
    w, h = resolution
    it = float(max(state.iteration, 1))
    rgb = state.accum.to(torch.float32) / it
    tensor = torch.cat([rgb, state.gbuf]).reshape(10, h, w)
    if options.flip_horizontal:
        tensor = tensor.flip(2)
    return tensor


def current_image(state: RenderLoopState, resolution: Tuple[int, int]) -> torch.Tensor:
    """(H, W, 3) average radiance so far."""
    w, h = resolution
    it = float(max(state.iteration, 1))
    return (state.accum.to(torch.float32) / it).T.reshape(h, w, 3)


def _resolve_backend(scene: Scene, options: RenderOptions) -> str:
    """Pick "pallas" (the CUDA megakernel) or "xla" (this plain wavefront).

    "auto" takes the megakernel when the scene and options are eligible and
    the scene lives on the card; "pallas" forces it and raises when
    ineligible (on CPU tensors the megakernel's wrapper runs its plain
    version).
    """
    from .cuda_backend import pallas_eligible
    if options.backend == "xla":
        return "xla"
    eligible = pallas_eligible(scene, options)
    if options.backend == "pallas":
        if not eligible:
            raise ValueError("backend='pallas' but scene/options ineligible "
                             "(mesh over 64 faces, sort_material, "
                             "cache_first_bounce, motion_blur or bfloat16 "
                             "accumulation)")
        return "pallas"
    return "pallas" if eligible and scene.device.type == "cuda" else "xla"


def render(scene: Scene, options: RenderOptions = RenderOptions(),
           num_iterations: Optional[int] = None,
           state: Optional[RenderLoopState] = None):
    """Render ``num_iterations`` spp (default: the scene's ITERATIONS).

    Returns (image (H,W,3), gbuffer (10,H,W), final state).  Iterations run
    in launches of at most ``options.iters_per_dispatch`` (default 64).
    """
    if num_iterations is None:
        num_iterations = scene.iterations
    if state is None:
        state = init_render_state(scene, options)
    backend = _resolve_backend(scene, options)
    per_dispatch = options.iters_per_dispatch or 64
    remaining = int(num_iterations)
    while remaining > 0:
        k = min(per_dispatch, remaining)
        if backend == "pallas":
            from .cuda_backend import render_cuda
            state = render_cuda(scene, options, k, state)
        else:
            for _ in range(k):
                state = trace_iteration(scene, options, state)
        remaining -= k
    image = current_image(state, scene.camera.resolution)
    gbuffer = assemble_gbuffer(state, scene.camera.resolution, options)
    return image, gbuffer, state


def render_gbuffer_frame(scene: Scene, options: RenderOptions = RenderOptions(),
                         state: Optional[RenderLoopState] = None):
    """One 1-spp frame + fresh G-buffer — the denoiser's input producer.

    Every frame restarts accumulation at iteration 0 (the interactive
    loop's camchanged path, main.cpp:122-165).
    """
    state = init_render_state(scene, options)
    return render(scene, options, num_iterations=1, state=state)
