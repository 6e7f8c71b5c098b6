"""Whole-render CUDA megakernel (counterpart of render/pallas_backend.py).

``render_cuda`` has ``render_pallas``'s contract: run ``num_iterations``
1-spp iterations into a ``RenderLoopState`` and return the advanced state,
with ``pixel_offset`` globalising pixel ids when the state holds a tile of
the frame.  On the card it launches csrc/render_megakernel.cu once; on CPU
tensors it runs the kernel's plain version, the wavefront iteration loop
(render/wavefront.py), which computes the same function.  The kernel's
design and what bounds it are described at the top of its source.

The kernel is built with ``-fmad=false``: multiply-adds are not contracted,
so its arithmetic rounds like the plain version's separate PyTorch kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..config import RenderOptions
from ..scene.structs import CUBE, Scene
from ..utils.cuda_build import CudaKernel, check
from .wavefront import RenderLoopState, init_render_state, trace_iteration

# Meshes up to this many faces go through the kernel's per-face loop (the
# reference's mesh scenes are 12-60 triangles).
MESH_BAKE_MAX_FACES = 64
# Scene buffer rows: geom transform/inverse/inverse-transpose (4x4 each),
# material color3/specular3/refl/refr/ior/emittance, face v0-v2 + n0-n2.
_GEOM_ROW = 48
_MAT_ROW = 10
_FACE_ROW = 18

_ANTIALIAS, _RNG_FAST, _DENOISE, _FRESNELS = 1, 2, 4, 8
_DIELECTRIC, _NORMAL_VIEW, _RAY_CULLING = 16, 32, 64


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_render_megakernel.restype = i
    lib.aptd_render_megakernel.argtypes = [p, p, i, i, i, p, i, i, i, i, i, i,
                                           i, i, i, p, p, p]


KERNEL = CudaKernel("render_megakernel", "render_megakernel.cu",
                    extra_flags=("-fmad=false",), declare=_declare)


def pallas_eligible(scene: Scene, options: RenderOptions) -> bool:
    """Whether the megakernel takes this scene and these options."""
    return (scene.mesh.num_faces <= MESH_BAKE_MAX_FACES
            and not options.sort_material
            and not options.cache_first_bounce
            and not options.motion_blur
            and options.accum_dtype == "float32")


def pack_scene(scene: Scene):
    """(float buffer, int buffer) the kernel copies into shared memory."""
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
        state = trace_iteration(scene, options, state, pixel_offset)
    return state


def render_cuda(scene: Scene, options: RenderOptions, num_iterations: int,
                state: Optional[RenderLoopState] = None,
                pixel_offset: int = 0) -> RenderLoopState:
    """Run ``num_iterations`` 1-spp iterations through the megakernel.

    Accumulates into a copy of ``state``'s buffers and returns the advanced
    state.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.
    """
    if not pallas_eligible(scene, options):
        raise ValueError("scene/options not eligible for the megakernel")
    if state is None:
        state = init_render_state(scene, options)
    if state.accum.device.type == "cpu":
        return render_cuda_plain(scene, options, num_iterations, state,
                                 pixel_offset)
    acc, gbuf = state.accum, state.gbuf
    n = acc.shape[1]
    for name, t, rows in (("accum", acc, 3), ("gbuf", gbuf, 7)):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or t.shape != (rows, n) or not t.is_contiguous()):
            raise ValueError(f"state.{name} must be a contiguous float32 "
                             f"({rows}, N) CUDA tensor, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if scene.device != acc.device:
        raise ValueError(f"scene on {scene.device}, state on {acc.device}")
    w, h = scene.camera.resolution
    if pixel_offset + n > w * h or w * h >= 2 ** 31:
        raise ValueError("pixel range outside the frame")
    cam = scene.camera
    cam_row = np.concatenate([cam.position.numpy(), cam.view.numpy(),
                              cam.up.numpy(), cam.right.numpy(),
                              cam.pixel_length.numpy()]).astype(np.float32)
    floats, ints = pack_scene(scene)
    acc, gbuf = acc.clone(), gbuf.clone()
    lib = KERNEL.lib()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.aptd_render_megakernel(
            floats.data_ptr(), ints.data_ptr(), scene.geoms.count,
            scene.materials.count, scene.mesh.num_faces,
            cam_row.ctypes.data, w, h, n, int(pixel_offset),
            int(state.iteration), int(num_iterations), int(state.rng_offset),
            int(scene.trace_depth), _flags(options), acc.data_ptr(),
            gbuf.data_ptr(), stream)
    check(rc, "render megakernel")
    KERNEL.launches += 1
    return RenderLoopState(accum=acc, gbuf=gbuf,
                           iteration=state.iteration + int(num_iterations),
                           rng_offset=state.rng_offset, segments=state.segments)


# Operations the kernel does per ray segment, counted from its source
# (csrc/render_megakernel.cu): float adds, multiplies, divides, compares
# and selects plus the special functions, each counted once.  They give the
# least time the card could take for a render; see ``render_work``.
OPS_BOX = 140
OPS_SPHERE = 120
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
               + OPS_SHADE)
    if scene.mesh.num_faces:
        per_seg += OPS_AABB + OPS_TRIANGLE * scene.mesh.num_faces
    floats, ints = (scene.geoms.count * _GEOM_ROW
                    + scene.materials.count * _MAT_ROW
                    + scene.mesh.num_faces * _FACE_ROW + 6,
                    2 * scene.geoms.count + scene.mesh.num_faces)
    n_bytes = 10 * 4 * 2 * n_pixels + 4 * (floats + ints)
    ops = segments * per_seg + n_pixels * niter * OPS_RAYGEN
    return n_bytes, ops
