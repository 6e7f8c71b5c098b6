"""Wavefront path tracer in plain PyTorch (counterpart of render/wavefront.py).

One 1-spp iteration of pathtrace() (pathtrace.cu:422-528) as tensor code
over all pixels at once: ray generation, a depth-0 intersect + shade that
also fills the G-buffer, then the remaining bounces with an alive mask in
place of stream compaction, stopping once every path has ended.

This is the plain PyTorch version of the megakernel
(render/cuda_backend.py + csrc/render_megakernel.cu): the kernel is held
against it, and it renders whatever the kernel does not take (CPU
tensors, bfloat16 accumulation, ``backend="xla"``, a mesh over 64 faces).
A mesh that carries a cluster hierarchy is intersected through it
(ops/intersect.py:intersect_scene_v, ``RenderOptions.mesh_bvh``), and with
``mesh_octant_sort`` the secondary bounces of the per-ray traversal carry
their rays in a coherence-sorted order: lane i is then no longer pixel i,
the pixel rides along as ``pixel_index``, the RNG draws by it and the final
gather scatter-adds by it.  ``sort_material`` permutes the path state the
same way after each shade (pathtrace.cu:508-510), ``cache_first_bounce``
reuses iteration 1's depth-0 intersection (pathtrace.cu:466-476), and
``motion_blur`` moves the geoms every 4th iteration and carries them in the
state; the megakernel takes none of the three.

``differentiable`` renders keep to operations autograd can go through: the
mesh takes the dense scan (the BVH kernels have no backward pass) and no
tensor that autograd saved is written in place, so a gradient reaches the
materials, the geoms' matrices, the mesh vertices and the camera
(render/edge_grad.py builds its interior terms on this).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import RenderOptions
from ..ops.bsdf import scatter_ray_v
from ..ops.intersect import (intersect_scene_v, mesh_box, octant_cell_key,
                             ray_aabb_intersect_v, resolve_mesh_impl)
from ..ops.rng import draw_uniforms
from ..ops.vec3 import Vec3, where as vwhere
from ..scene.structs import Camera, Geoms, Scene
from ..utils.timers import host_read, span
from .motion_blur import advance_geoms


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
    ``geoms``: the geometry as motion blur has moved it so far (None: the
    scene's own).  ``cache``: iteration 1's depth-0 intersection (t, point,
    normal, material id), kept when ``cache_first_bounce`` is on
    (dev_intersections_cache).
    """

    accum: torch.Tensor
    gbuf: torch.Tensor
    iteration: int = 0
    rng_offset: int = 0
    segments: int = 0
    geoms: Optional[Geoms] = None
    cache: Optional[Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]] = None


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
    why that is exact parity with the reference).  The camera's entries
    enter as 0-dim tensors, so a gradient reaches them; the planes are the
    same float32 operations as with python floats, bit for bit.
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
    plx, ply = camera.pixel_length.unbind()
    px = plx * (x - w * 0.5 + jx)
    py = ply * (y - h * 0.5 + jy)
    vx, vy, vz = camera.view.unbind()
    rx, ry, rz = camera.right.unbind()
    ux, uy, uz = camera.up.unbind()
    direction = Vec3(vx - rx * px - ux * py,
                     vy - ry * px - uy * py,
                     vz - rz * px - uz * py).normalized()
    ones = torch.ones_like(x)
    cx, cy, cz = camera.position.unbind()
    origin = Vec3(ones * cx, ones * cy, ones * cz)
    return origin, direction


def generate_camera_rays(camera: Camera, iteration, options: RenderOptions,
                         pixel_ids: Optional[torch.Tensor] = None):
    """(N, 3) wrapper over :func:`generate_camera_rays_v`; every pixel of
    the camera, in order, when ``pixel_ids`` is absent."""
    if pixel_ids is None:
        w, h = camera.resolution
        pixel_ids = torch.arange(w * h, dtype=torch.int64, device=camera.position.device)
    o, d = generate_camera_rays_v(camera, iteration, options, pixel_ids)
    return o.stack(), d.stack()


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
    keyed on the global pixel id of each lane (``pixel_ids``, not the lane's
    position, so a carry sort draws the unsorted render's noise) and the
    *remaining* bounce count.
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


def _maybe_sort_by_material(options: RenderOptions, isect_mat, alive, carry):
    """Material-coherence sort (pathtrace.cu:508-510): stable argsort keyed
    by material id, dead lanes pushed to the back.  Off by default; permutes
    every plane of the carry (ray_o, ray_d, color, remaining, pixel_index)
    when enabled."""
    if not options.sort_material:
        return carry
    with span("render.sort"):
        key = torch.where(alive, isect_mat, 1 << 30)
        perm = torch.sort(key, stable=True).indices
        ray_o, ray_d, color, remaining, pixel_index = carry
        return (*(Vec3(*(c[perm] for c in v)) for v in (ray_o, ray_d, color)),
                remaining[perm], pixel_index[perm])


def trace_iteration(scene: Scene, options: RenderOptions,
                    state: RenderLoopState, differentiable: bool = False,
                    pixel_offset: int = 0) -> RenderLoopState:
    """One full 1-spp path-trace iteration (pathtrace.cu:422-528).

    ``differentiable``: keep the mesh on the dense scan, which autograd can
    go through (no BVH kernel, no carry sort); the image is the same.
    ``pixel_offset``: first global pixel id of this state's tile (0 for a
    whole frame); the RNG and the pixel split use global ids.
    """
    n = state.accum.shape[1]
    depth_max = scene.trace_depth
    iteration = state.iteration + 1
    rng_iter = iteration + state.rng_offset
    dev = state.accum.device
    pixel_ids = torch.arange(n, dtype=torch.int64, device=dev) + pixel_offset

    geoms = state.geoms if state.geoms is not None else scene.geoms
    if options.motion_blur and iteration % 4 == 0 and iteration < 3000:
        # moveGeom every 4th iteration while iter < 3000 (pathtrace.cu:441)
        geoms = advance_geoms(geoms)

    ray_o, ray_d = generate_camera_rays_v(scene.camera, rng_iter, options,
                                          pixel_ids)
    color = Vec3.full_like(ray_d.x, 1.0)
    remaining = torch.full((n,), depth_max, dtype=torch.int32, device=dev)

    # the BVH kernels have no backward pass: differentiable renders scan
    use_bvh = options.mesh_bvh and not differentiable
    mesh_kwargs = dict(ray_culling=options.ray_culling, use_bvh=use_bvh,
                       kernel_impl=options.mesh_kernel_impl)

    # ---- depth 0: G-buffer emission (pathtrace.cu:295-304, 379-387) ----
    with span("render.bounce"):
        cache = state.cache
        if cache is not None and options.cache_first_bounce and iteration > 1:
            # without jitter or motion the primary rays repeat: iteration 1's hit
            isect0 = dict(t=cache[0], point=cache[1], normal=cache[2],
                          material_id=cache[3])
        else:
            with span("render.intersect"):
                isect0 = intersect_scene_v(geoms, scene.mesh, ray_o, ray_d,
                                           **mesh_kwargs)
            if options.cache_first_bounce:
                cache = (isect0["t"], isect0["point"], isect0["normal"],
                         isect0["material_id"])
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
        with span("render.shade"):
            ray_o, ray_d, color, remaining = _shade(
                scene, options, rng_iter, isect0, ray_d, color, remaining, pixel_ids)
        if options.denoise:
            # albedo = throughput after the first shade
            gbuf = torch.stack([gbuf[0], gbuf[1], gbuf[2], gbuf[3],
                                torch.where(write, color.x, gbuf[4]),
                                torch.where(write, color.y, gbuf[5]),
                                torch.where(write, color.z, gbuf[6])])

        # Carry-level coherence sort, secondary bounces only (primaries are
        # pixel-coherent already): one stable sort moves the whole path state,
        # rays stay in sorted order through shading, and ``pixel_index`` carries
        # each lane's pixel.  The binned pipeline packs rays itself, so the
        # permutation would be pure overhead there.
        carry_sort = (options.mesh_octant_sort and use_bvh
                      and scene.mesh.num_faces > 0 and scene.mesh.bvh is not None
                      and resolve_mesh_impl(scene.mesh, options.mesh_kernel_impl)
                      != "binned")
        pixel_index = torch.arange(n, dtype=torch.int64, device=dev)   # local
        ray_o, ray_d, color, remaining, pixel_index = _maybe_sort_by_material(
            options, isect0["material_id"], remaining > 0,
            (ray_o, ray_d, color, remaining, pixel_index))

    # ---- remaining bounces; stop once every path has ended ----
    for _ in range(depth_max - 1):
        with span("render.bounce"):
            with host_read("live_count"):
                live = int((remaining > 0).sum())
            if live == 0 and options.stream_compaction:
                break
            segments += live
            if carry_sort:
                with span("render.sort"):
                    dead = remaining == 0
                    if options.ray_culling:
                        dead = dead | ~ray_aabb_intersect_v(
                            ray_o, ray_d, *mesh_box(scene.mesh))
                    key = octant_cell_key(ray_o, ray_d, dead, options.mesh_sort_cells)
                    perm = torch.sort(key, stable=True).indices
                    ray_o, ray_d, color = (Vec3(*(c[perm] for c in v))
                                           for v in (ray_o, ray_d, color))
                    remaining, pixel_index = remaining[perm], pixel_index[perm]
            with span("render.intersect"):
                isect = intersect_scene_v(geoms, scene.mesh, ray_o, ray_d,
                                          active=remaining != 0,
                                          kernel_lanes=options.mesh_kernel_lanes,
                                          **mesh_kwargs)
            with span("render.shade"):
                ray_o, ray_d, color, remaining = _shade(
                    scene, options, rng_iter, isect, ray_d, color, remaining,
                    pixel_index + pixel_offset)
            ray_o, ray_d, color, remaining, pixel_index = _maybe_sort_by_material(
                options, isect["material_id"], remaining > 0,
                (ray_o, ray_d, color, remaining, pixel_index))

    # finalGather (pathtrace.cu:393-402).  Without a sort of the carry lane i
    # is pixel i: a plain add.  With one, scatter-add by the permuted index;
    # each pixel receives exactly one path per iteration, so the indices
    # are unique and the result is the plain add's, in any order.
    color_acc = color.stack().T.to(state.accum.dtype)
    if options.sort_material or (carry_sort and depth_max > 1):
        accum = state.accum.index_add(1, pixel_index, color_acc)
    else:
        accum = state.accum + color_acc
    return RenderLoopState(accum=accum, gbuf=gbuf, iteration=iteration,
                           rng_offset=state.rng_offset,
                           segments=state.segments + segments,
                           geoms=geoms if options.motion_blur else state.geoms,
                           cache=cache)


def assemble_gbuffer(state: RenderLoopState, resolution: Tuple[int, int],
                     options: RenderOptions) -> torch.Tensor:
    """The 10-channel CHW tensor (dev_tensor layout, pathtrace.cu:81-94).

    ch0-2 RGB = accum / iteration, ch3-5 normal, ch6 depth, ch7-9 albedo;
    ``flip_horizontal`` reproduces the reference's mirrored layout.
    """
    with span("render.gbuffer"):
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


def _resolve_backend(scene: Scene, options: RenderOptions,
                     differentiable: bool = False) -> str:
    """Pick "pallas" (the CUDA megakernel) or "xla" (this plain wavefront).

    "auto" takes the megakernel when the scene and options are eligible and
    the scene lives on the card; "pallas" forces it and raises when
    ineligible (on CPU tensors the megakernel's wrapper runs its plain
    version).  A differentiable render is never eligible.
    """
    from .cuda_backend import pallas_eligible
    if options.backend == "xla":
        return "xla"
    eligible = pallas_eligible(scene, options, differentiable)
    if options.backend == "pallas":
        if not eligible:
            raise ValueError("backend='pallas' but scene/options ineligible "
                             "(mesh over 64 faces, the packed scene exceeds the "
                             "megakernel's shared memory, sort_material, "
                             "cache_first_bounce, motion_blur, bfloat16 "
                             "accumulation or differentiable render)")
        return "pallas"
    return "pallas" if eligible and scene.device.type == "cuda" else "xla"


def render_iterations(scene: Scene, options: RenderOptions, num_iterations: int,
                      state: RenderLoopState, backend: str,
                      differentiable: bool = False,
                      pixel_offset: int = 0) -> RenderLoopState:
    """Advance ``state`` by ``num_iterations`` iterations on ``backend``
    ("pallas": the megakernel, "xla": this plain wavefront), in launches of
    at most ``options.iters_per_dispatch`` (default 64).  ``pixel_offset``:
    the first global pixel id of the state's tile (parallel/render_shard.py)."""
    per_dispatch = options.iters_per_dispatch or 64
    remaining = int(num_iterations)
    while remaining > 0:
        k = min(per_dispatch, remaining)
        if backend == "pallas":
            from .cuda_backend import render_cuda
            with span("render.k1"):
                state = render_cuda(scene, options, k, state, pixel_offset)
        else:
            for _ in range(k):
                state = trace_iteration(scene, options, state, differentiable,
                                        pixel_offset)
        remaining -= k
    return state


def render(scene: Scene, options: RenderOptions = RenderOptions(),
           num_iterations: Optional[int] = None,
           state: Optional[RenderLoopState] = None,
           differentiable: bool = False):
    """Render ``num_iterations`` spp (default: the scene's ITERATIONS).

    Returns (image (H,W,3), gbuffer (10,H,W), final state).  Iterations run
    in launches of at most ``options.iters_per_dispatch`` (default 64).
    ``differentiable``: the plain wavefront on its differentiable path.
    """
    if num_iterations is None:
        num_iterations = scene.iterations
    if state is None:
        state = init_render_state(scene, options)
    backend = _resolve_backend(scene, options, differentiable)
    state = render_iterations(scene, options, num_iterations, state, backend,
                              differentiable)
    image = current_image(state, scene.camera.resolution)
    gbuffer = assemble_gbuffer(state, scene.camera.resolution, options)
    return image, gbuffer, state


def render_gbuffer_frame(scene: Scene, options: RenderOptions = RenderOptions(),
                         state: Optional[RenderLoopState] = None):
    """One 1-spp frame + fresh G-buffer — the denoiser's input producer.

    Every frame restarts accumulation at iteration 0 (the interactive
    loop's camchanged path, main.cpp:122-165).
    """
    with span("render.frame"):
        state = init_render_state(scene, options)
        return render(scene, options, num_iterations=1, state=state)
