"""Whole-render CUDA megakernel K1 (counterpart of render/pallas_backend.py).

``render_cuda`` has ``render_pallas``'s contract: run ``num_iterations``
1-spp iterations into a ``RenderLoopState`` and return the advanced state,
with ``pixel_offset`` globalising pixel ids when the state holds a tile of
the frame.  On the card it packs the scene and launches
csrc/render_megakernel.cu once through ``launch_megakernel``; on CPU
tensors it runs the kernel's plain version, the wavefront iteration loop
(render/wavefront.py), which computes the same function.  The kernel's
design and what bounds it are described at the top of its source.

The kernel is built with ``-fmad=false``: multiply-adds are not contracted,
so its arithmetic rounds like the plain version's separate PyTorch kernels.
``WITNESS`` is the same source built with one pixel per thread and the
first version's arithmetic (``-DK1_ONE_PIXEL_PER_THREAD``), which the
shipped kernel equals bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import RenderOptions
from ..ops.intersect import intersect_scene_v
from ..ops.vec3 import Vec3
from ..scene.structs import CUBE, Scene
from ..utils.cuda_build import CudaKernel, check
from .wavefront import (RenderLoopState, _shade, generate_camera_rays_v, init_render_state,
                        trace_iteration)

# Meshes up to this many faces go through the kernel's per-face loop (the
# reference's mesh scenes are 12-60 triangles).
MESH_BAKE_MAX_FACES = 64
# Scene buffer rows: geom transform/inverse/inverse-transpose (4x4 each),
# material color3/specular3/refl/refr/ior/emittance, face v0-v2 + n0-n2.
_GEOM_ROW = 48
_MAT_ROW = 10
_FACE_ROW = 18
# The scene's home is each block's shared memory: at most what one H100
# block may use (227 KB).  A larger scene raises; it is not put elsewhere.
SCENE_HOME_BYTES = 232448

_ANTIALIAS, _RNG_FAST, _DENOISE, _FRESNELS = 1, 2, 4, 8
_DIELECTRIC, _NORMAL_VIEW, _RAY_CULLING = 16, 32, 64

# Launch shape of the persistent kernel, chosen on the card by
# tools/k1_sweep.py: threads per block, blocks per SM (0: as many as fit),
# pixel ids a warp claims from the counter at a time.
K1_THREADS = 128
K1_BLOCKS_PER_SM = 0
K1_CHUNK = 16
_MAX_THREADS = 256      # the kernel's __launch_bounds__


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_render_megakernel.restype = i
    lib.aptd_render_megakernel.argtypes = [p, p, i, i, i, p, i, i, i, i, i, i,
                                           i, i, i, p, p, p, i, i, i, p, p]
    lib.aptd_render_blocks_per_sm.restype = i
    lib.aptd_render_blocks_per_sm.argtypes = [i, i, p]


def kernel_build(witness: bool = False) -> CudaKernel:
    """K1's source as shipped, or built as its one-pixel-per-thread witness."""
    if witness:
        return CudaKernel("render_megakernel_witness", "render_megakernel.cu",
                          extra_flags=("-fmad=false", "-DK1_ONE_PIXEL_PER_THREAD"),
                          declare=_declare, headers=("geom_common.cuh",))
    return CudaKernel("render_megakernel", "render_megakernel.cu",
                      extra_flags=("-fmad=false",), declare=_declare,
                      headers=("geom_common.cuh",))


KERNEL = kernel_build()
WITNESS = kernel_build(witness=True)


def scene_home_bytes(n_geoms: int, n_mats: int, n_faces: int) -> int:
    """Bytes of the packed scene, which each block holds in shared memory."""
    return (4 * (n_geoms * _GEOM_ROW + n_mats * _MAT_ROW + n_faces * _FACE_ROW + 6)
            + 4 * (2 * n_geoms + n_faces))


def check_scene_home(n_geoms: int, n_mats: int, n_faces: int) -> int:
    """``scene_home_bytes``, or ValueError where the scene does not fit."""
    need = scene_home_bytes(n_geoms, n_mats, n_faces)
    if need > SCENE_HOME_BYTES:
        raise ValueError(f"the packed scene takes {need} bytes; the megakernel holds at most "
                         f"{SCENE_HOME_BYTES} in a block's shared memory")
    return need


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """The persistent launch over ``n`` pixels: ``blocks`` of ``threads``;
    each warp claims ``chunk`` consecutive pixel ids at a time from a
    one-int counter that starts at 0, until the counter passes ``n``."""

    n: int
    blocks: int
    threads: int
    chunk: int

    @property
    def chunks(self) -> int:
        return -(-self.n // self.chunk)

    def chunk_ranges(self, pixel_offset: int = 0):
        """The global pixel ids of each claim, in counter order."""
        return [range(pixel_offset + c * self.chunk,
                      pixel_offset + min((c + 1) * self.chunk, self.n))
                for c in range(self.chunks)]

    def counter(self, device) -> torch.Tensor:
        """The zeroed scratch counter the kernel claims from."""
        return torch.zeros(1, dtype=torch.int32, device=device)


def k1_plan(n: int, sm_count: int, fit_per_sm: int, threads: int = K1_THREADS,
            blocks_per_sm: int = K1_BLOCKS_PER_SM, chunk: int = K1_CHUNK) -> K1Plan:
    """Grid and chunk of a launch: ``blocks_per_sm`` (0: ``fit_per_sm``, as
    many as fit) blocks on each of ``sm_count`` SMs, no more than the
    pixels need."""
    if threads % 32 or not 32 <= threads <= _MAX_THREADS:
        raise ValueError(f"threads per block {threads}: a multiple of 32 up to {_MAX_THREADS}")
    if chunk < 1 or blocks_per_sm < 0 or n < 0:
        raise ValueError(f"chunk {chunk}, blocks per SM {blocks_per_sm}, n {n}")
    if fit_per_sm < 1:
        raise ValueError("no block of the megakernel fits on an SM")
    per_sm = fit_per_sm if blocks_per_sm == 0 else min(blocks_per_sm, fit_per_sm)
    blocks = max(1, min(sm_count * per_sm, -(-n // threads)))
    if n + blocks * (threads // 32) * chunk >= 2 ** 31:
        raise ValueError(f"{n} pixels overflow the int32 claim counter")
    return K1Plan(n=n, blocks=blocks, threads=threads, chunk=chunk)


def pallas_eligible(scene: Scene, options: RenderOptions,
                    differentiable: bool = False) -> bool:
    """Whether the megakernel takes this scene and these options: a packed
    scene larger than a block's shared memory is not taken, nor a
    differentiable render (the kernel has no backward pass)."""
    return (not differentiable
            and scene.mesh.num_faces <= MESH_BAKE_MAX_FACES
            and scene_home_bytes(scene.geoms.count, scene.materials.count,
                                 scene.mesh.num_faces) <= SCENE_HOME_BYTES
            and not options.sort_material
            and not options.cache_first_bounce
            and not options.motion_blur
            and options.accum_dtype == "float32")


def pack_scene(scene: Scene):
    """(float buffer, int buffer) the kernel copies into shared memory."""
    check_scene_home(scene.geoms.count, scene.materials.count, scene.mesh.num_faces)
    g, m, mesh = scene.geoms, scene.materials, scene.mesh
    dev = scene.device
    nf = mesh.num_faces
    floats = torch.cat([
        torch.cat([g.transform.reshape(-1, 16), g.inverse_transform.reshape(-1, 16),
                   g.inv_transpose.reshape(-1, 16)], dim=1).reshape(-1),
        torch.cat([m.color, m.specular_color, m.has_reflective[:, None],
                   m.has_refractive[:, None], m.index_of_refraction[:, None],
                   m.emittance[:, None]], dim=1).reshape(-1),
        torch.cat([mesh.vertices[:nf].reshape(nf, 9),
                   mesh.normals[:nf].reshape(nf, 9)], dim=1).reshape(-1),
        mesh.aabb_lb, mesh.aabb_ub]).to(device=dev, dtype=torch.float32).contiguous()
    ints = torch.cat([g.type, g.material_id, mesh.material_id[:nf]]).to(
        device=dev, dtype=torch.int32).contiguous()
    return floats, ints


def camera_row(scene: Scene) -> np.ndarray:
    """The camera's 14 floats as the kernel takes them: position, view, up,
    right, pixel length."""
    cam = scene.camera
    return np.concatenate([cam.position.numpy(), cam.view.numpy(), cam.up.numpy(),
                           cam.right.numpy(), cam.pixel_length.numpy()]).astype(np.float32)


def _flags(options: RenderOptions) -> int:
    return ((_ANTIALIAS if options.antialias else 0)
            | (_RNG_FAST if options.rng == "fast" else 0)
            | (_DENOISE if options.denoise else 0)
            | (_FRESNELS if options.fresnels else 0)
            | (_DIELECTRIC if options.dielectric else 0)
            | (_NORMAL_VIEW if options.mesh_normal_view else 0)
            | (_RAY_CULLING if options.ray_culling else 0))


def render_cuda_plain(scene: Scene, options: RenderOptions, num_iterations: int,
                      state: RenderLoopState, pixel_offset: int = 0
                      ) -> RenderLoopState:
    """The megakernel's plain PyTorch version: the wavefront iteration loop."""
    for _ in range(num_iterations):
        state = trace_iteration(scene, options, state, pixel_offset=pixel_offset)
    return state


def launch_megakernel(floats: torch.Tensor, ints: torch.Tensor, cam_row: np.ndarray,
                      acc: torch.Tensor, gbuf: torch.Tensor, *, counts: Sequence[int],
                      resolution: Sequence[int], depth: int, flags: int,
                      pixel_offset: int = 0, start: int = 0, niter: int = 1,
                      rng_offset: int = 0, threads: int = K1_THREADS,
                      blocks_per_sm: int = K1_BLOCKS_PER_SM, chunk: int = K1_CHUNK,
                      stats: Optional[torch.Tensor] = None,
                      kernel: Optional[CudaKernel] = None) -> None:
    """Launch K1 once on the current stream, accumulating into ``acc`` (3, N)
    and ``gbuf`` (7, N) in place; only launches.

    ``floats``, ``ints``: ``pack_scene``'s buffers; ``cam_row``:
    ``camera_row``'s floats; ``counts``: (geoms, materials, faces);
    ``resolution``: (width, height) of the frame whose pixels
    ``pixel_offset`` .. ``pixel_offset + N`` the buffers hold; iterations
    ``start + 1`` .. ``start + niter``, drawn at ``+ rng_offset``.
    ``threads``, ``blocks_per_sm``, ``chunk``: the launch shape
    (``k1_plan``).  ``stats``: None, or an int64 (2,) tensor on the card
    that the kernel adds its lane-steps (32 per warp step) and segments
    traced to.  ``kernel``: another build of the source (``WITNESS``).
    Raises on a wrong shape, type or device; CPU tensors raise too (the
    plain version is ``render_cuda``'s).
    """
    kernel = KERNEL if kernel is None else kernel
    n = acc.shape[1] if acc.dim() == 2 else -1
    for name, t, shape, dtype in (("acc", acc, (3, n), torch.float32),
                                  ("gbuf", gbuf, (7, n), torch.float32)):
        if (t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} CUDA tensor, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dev = acc.device
    n_geoms, n_mats, n_faces = (int(c) for c in counts)
    smem = check_scene_home(n_geoms, n_mats, n_faces)
    n_f = n_geoms * _GEOM_ROW + n_mats * _MAT_ROW + n_faces * _FACE_ROW + 6
    n_i = 2 * n_geoms + n_faces
    for name, t, size, dtype in (("floats", floats, n_f, torch.float32),
                                 ("ints", ints, n_i, torch.int32)):
        if (t.device != dev or t.dtype != dtype or t.dim() != 1 or t.numel() != size
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of {size} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or tuple(stats.shape) != (2,) or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int64 (2,) tensor on {dev}")
    if (not isinstance(cam_row, np.ndarray) or cam_row.dtype != np.float32
            or cam_row.shape != (14,) or not cam_row.flags.c_contiguous):
        raise ValueError("cam_row must be camera_row's contiguous float32 (14,) array")
    w, h = (int(r) for r in resolution)
    if pixel_offset < 0 or pixel_offset + n > w * h or w * h >= 2 ** 31:
        raise ValueError("pixel range outside the frame")
    if niter < 0:
        raise ValueError(f"niter {niter} < 0")
    props = torch.cuda.get_device_properties(dev)
    fit = kernel.blocks_per_sm("aptd_render_blocks_per_sm", dev, threads, smem)
    plan = k1_plan(n, props.multi_processor_count, fit, threads, blocks_per_sm, chunk)
    counter = plan.counter(dev)
    lib = kernel.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.aptd_render_megakernel(
            floats.data_ptr(), ints.data_ptr(), n_geoms, n_mats, n_faces,
            cam_row.ctypes.data, w, h, n, int(pixel_offset), int(start), int(niter),
            int(rng_offset), int(depth), int(flags), acc.data_ptr(), gbuf.data_ptr(),
            counter.data_ptr(), plan.blocks, plan.threads, plan.chunk,
            None if stats is None else stats.data_ptr(), stream)
    check(rc, "render megakernel")
    kernel.launches += 1


def render_cuda(scene: Scene, options: RenderOptions, num_iterations: int,
                state: Optional[RenderLoopState] = None,
                pixel_offset: int = 0, kernel: Optional[CudaKernel] = None
                ) -> RenderLoopState:
    """Run ``num_iterations`` 1-spp iterations through the megakernel.

    Accumulates into a copy of ``state``'s buffers and returns the advanced
    state.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (``kernel``: another build, as ``launch_megakernel``) or raise.
    """
    if not pallas_eligible(scene, options):
        raise ValueError("scene/options not eligible for the megakernel")
    if state is None:
        state = init_render_state(scene, options)
    if state.accum.device.type == "cpu":
        return render_cuda_plain(scene, options, num_iterations, state,
                                 pixel_offset)
    acc, gbuf = state.accum, state.gbuf
    if scene.device != acc.device:
        raise ValueError(f"scene on {scene.device}, state on {acc.device}")
    floats, ints = pack_scene(scene)
    acc, gbuf = acc.clone(), gbuf.clone()
    launch_megakernel(floats, ints, camera_row(scene), acc, gbuf,
                      counts=(scene.geoms.count, scene.materials.count, scene.mesh.num_faces),
                      resolution=scene.camera.resolution, depth=int(scene.trace_depth),
                      flags=_flags(options), pixel_offset=int(pixel_offset),
                      start=int(state.iteration), niter=int(num_iterations),
                      rng_offset=int(state.rng_offset), kernel=kernel)
    return RenderLoopState(accum=acc, gbuf=gbuf,
                           iteration=state.iteration + int(num_iterations),
                           rng_offset=state.rng_offset, segments=state.segments)


# Operations the kernel does per ray segment, counted from its source
# (csrc/render_megakernel.cu): float adds, multiplies, divides, compares
# and selects plus the special functions, each counted once.  They give the
# least time the card could take for a render; see ``render_work``.  A geom
# test keeps t and the world point; the winning geom's world normal (a
# transform, a normalisation and a select: OPS_NORMAL) is made once per
# segment.  (The first version made every geom's: 140 per box, 120 per
# sphere.)
OPS_BOX = 115
OPS_SPHERE = 95
OPS_NORMAL = 25
OPS_TRIANGLE = 60
OPS_AABB = 27
OPS_SHADE = 100      # RNG draw, scatter, throughput update
OPS_RAYGEN = 40


def render_work(scene: Scene, n_pixels: int, niter: int, segments: int):
    """(bytes, operations) the megakernel needs for one launch.

    Bytes: each accumulator and G-buffer plane read once and written once,
    plus the scene buffer.  Operations: the per-segment counts above for
    ``segments`` ray segments (live rays summed over bounces, as the plain
    renderer counts them on the same inputs) plus ray generation.
    """
    types = scene.geoms.type.tolist()
    per_seg = (sum(OPS_BOX if t == CUBE else OPS_SPHERE for t in types)
               + (OPS_NORMAL if types else 0) + OPS_SHADE)
    if scene.mesh.num_faces:
        per_seg += OPS_AABB + OPS_TRIANGLE * scene.mesh.num_faces
    n_bytes = 10 * 4 * 2 * n_pixels + scene_home_bytes(
        scene.geoms.count, scene.materials.count, scene.mesh.num_faces)
    ops = segments * per_seg + n_pixels * niter * OPS_RAYGEN
    return n_bytes, ops


def geoms_work(n_rays: int, types: Sequence[int]):
    """(bytes, operations) of one call of the wavefront's geom kernel K10
    (csrc/geom_intersect.cu) over ``n_rays`` rays and geoms of ``types``:
    six float32 ray planes read, seven float32 planes, a bool plane and an
    int32 plane written; every geom tested on every ray (``OPS_BOX``,
    ``OPS_SPHERE``) and the winner's normal made once (``OPS_NORMAL``)."""
    per_ray = (sum(OPS_BOX if t == CUBE else OPS_SPHERE for t in types)
               + (OPS_NORMAL if len(types) else 0))
    return n_rays * (6 * 4 + 7 * 4 + 1 + 4), n_rays * per_ray


def path_segments(scene: Scene, options: RenderOptions, num_iterations: int,
                  state: Optional[RenderLoopState] = None,
                  pixel_offset: int = 0) -> torch.Tensor:
    """(num_iterations, N) int32: the ray segments each pixel's path traces
    in each iteration, from the plain bounce loop (``trace_iteration``'s
    rays, RNG and shading, without its sums).  Summed, they are the plain
    state's ``segments``; per warp they give ``lane_efficiency``."""
    if not pallas_eligible(scene, options):
        raise ValueError("scene/options not eligible for the megakernel")
    if state is None:
        state = init_render_state(scene, options)
    n = state.accum.shape[1]
    dev = state.accum.device
    pixel_ids = torch.arange(n, dtype=torch.int64, device=dev) + pixel_offset
    mesh_kwargs = dict(ray_culling=options.ray_culling, use_bvh=options.mesh_bvh,
                       kernel_impl=options.mesh_kernel_impl)
    out = torch.zeros((num_iterations, n), dtype=torch.int32, device=dev)
    for k in range(num_iterations):
        rng_iter = state.iteration + 1 + k + state.rng_offset
        ray_o, ray_d = generate_camera_rays_v(scene.camera, rng_iter, options, pixel_ids)
        color = Vec3.full_like(ray_d.x, 1.0)
        remaining = torch.full((n,), scene.trace_depth, dtype=torch.int32, device=dev)
        out[k] += 1
        isect = intersect_scene_v(scene.geoms, scene.mesh, ray_o, ray_d, **mesh_kwargs)
        ray_o, ray_d, color, remaining = _shade(scene, options, rng_iter, isect, ray_d,
                                                color, remaining, pixel_ids)
        for _ in range(scene.trace_depth - 1):
            live = remaining > 0
            if not bool(live.any()):
                break
            out[k] += live.to(torch.int32)
            isect = intersect_scene_v(scene.geoms, scene.mesh, ray_o, ray_d,
                                      active=remaining != 0, **mesh_kwargs)
            ray_o, ray_d, color, remaining = _shade(scene, options, rng_iter, isect, ray_d,
                                                    color, remaining, pixel_ids)
    return out


def lane_efficiency(segments: torch.Tensor, warp: int = 32) -> float:
    """Segments traced over the lane-steps that warps of ``warp``
    consecutive pixels take when each warp runs, in every iteration, as
    long as its longest path: ``segments.sum() / sum(warp * max)`` over
    (iteration, warp).  ``segments``: (iterations, N) from ``path_segments``."""
    it, n = segments.shape
    padded = torch.zeros((it, -(-n // warp) * warp), dtype=torch.int64,
                         device=segments.device)
    padded[:, :n] = segments
    longest = padded.reshape(it, -1, warp).amax(dim=2)
    return float(segments.sum()) / float(warp * longest.sum())
