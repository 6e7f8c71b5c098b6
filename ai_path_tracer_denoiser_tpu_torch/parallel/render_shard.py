"""Tile-parallel rendering: the frame's pixels split over ``data``
(counterpart of parallel/render_shard.py).

Each rank traces its contiguous tile of pixels through the whole bounce
loop; the scene is replicated.  The RNG is keyed on global pixel ids
(``pixel_offset``), so an n-rank render is the single-device render bit
for bit.  Megakernel-eligible scenes run each tile through the render
megakernel, everything else through the plain wavefront (a mesh scene's
BVH kernels per tile), by ``render``'s own rule.  No traffic while
tracing; one all-gather per plane assembles the frame on every rank.

The JAX module caches its compiled shard_map programs; nothing is compiled
per call here (the kernels are built once, utils/cuda_build.py), so there
is no such cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..config import RenderOptions
from ..ops.vec3 import Vec3
from ..render.wavefront import (RenderLoopState, _resolve_backend,
                                assemble_gbuffer, current_image,
                                render_iterations)
from ..scene.structs import Scene
from .mesh import all_gather_dim, axis_index, axis_size


def render_tile(scene: Scene, options: RenderOptions, num_iterations: int,
                index: int, count: int,
                use_pallas: Optional[bool] = None) -> RenderLoopState:
    """Tile ``index`` of ``count`` equal tiles of the frame's pixels,
    rendered for ``num_iterations`` iterations: the state of its pixels
    only, what rank ``index`` of ``render_sharded`` traces.  No collective.

    ``use_pallas``: None picks the backend by ``render``'s rule, True the
    megakernel (raises when the scene is ineligible), False the plain
    wavefront.
    """
    w, h = scene.camera.resolution
    n = w * h
    assert n % count == 0, f"{n} pixels not divisible by {count} devices"
    tile = n // count
    if use_pallas is None:
        backend = _resolve_backend(scene, options)
    else:
        backend = "pallas" if use_pallas else "xla"
    acc_dtype = torch.bfloat16 if options.accum_dtype == "bfloat16" else torch.float32
    state = RenderLoopState(
        accum=torch.zeros((3, tile), dtype=acc_dtype, device=scene.device),
        gbuf=torch.zeros((7, tile), dtype=torch.float32, device=scene.device))
    return render_iterations(scene, options, num_iterations, state, backend,
                             pixel_offset=index * tile)


def render_sharded(scene: Scene, options: RenderOptions,
                   num_iterations: int, mesh,
                   use_pallas: Optional[bool] = None):
    """Render with pixels sharded over ``data``; returns (image, gbuffer,
    state), the whole frame on every rank.  Requires the pixel count to be
    divisible by the data-axis size."""
    w, h = scene.camera.resolution
    n_dev = axis_size(mesh, "data")
    assert (w * h) % n_dev == 0, f"{w * h} pixels not divisible by {n_dev} devices"
    local = render_tile(scene, options, num_iterations,
                        axis_index(mesh, "data"), n_dev, use_pallas)
    state = gather_state(local, mesh.get_group("data"))
    image = current_image(state, scene.camera.resolution)
    gbuffer = assemble_gbuffer(state, scene.camera.resolution, options)
    return image, gbuffer, state


def gather_state(local: RenderLoopState, group) -> RenderLoopState:
    """The whole frame's state from every rank's tile: the pixel planes
    gathered in rank order, the segment counts summed; the geoms (motion
    blur moves them alike on every rank) stay."""
    def planes(t):
        return all_gather_dim(t, group, t.dim() - 1)

    segments = torch.tensor([int(local.segments)], dtype=torch.int64,
                            device=local.accum.device)
    dist.all_reduce(segments, group=group)
    cache = local.cache
    if cache is not None:
        t, point, normal, mat = cache
        cache = (planes(t), Vec3(*(planes(c) for c in point)),
                 Vec3(*(planes(c) for c in normal)), planes(mat))
    return dataclasses.replace(local, accum=planes(local.accum),
                               gbuf=planes(local.gbuf),
                               segments=int(segments.item()), cache=cache)
