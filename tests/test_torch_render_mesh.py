"""The port's renderer against the JAX package's on mesh scenes, at the
tolerances and by the method of tests/test_torch_render.py: a 20-triangle
mesh (within the megakernel's 64-face limit) and the 320-face icosphere,
which both packages send through the cluster hierarchy ("auto" resolves to
the per-ray traversal, run on the JAX side in Pallas interpret mode).

Within the port, every mesh intersection gives the same image: the dense
scan, the traversal with and without the carry sort, and the binned
pipeline.  On the CPU all of them are the same PyTorch arithmetic per
(ray, face) pair with the same first-minimal-face rule, so the comparison
is bit for bit.
"""
import dataclasses
import pathlib

import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.render import (cuda_backend, init_render_state,
                                                      render, trace_iteration)
from ai_path_tracer_denoiser_tpu_torch.render.wavefront import _resolve_backend
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene
from ai_path_tracer_denoiser_tpu_torch.utils import timers
from test_torch_render import check_plain_renderer_matches_jax

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("depth,rng_offset", [(8, 11), (3, 0)])
def test_plain_renderer_matches_jax_on_mesh(depth, rng_offset):
    check_plain_renderer_matches_jax("cornell_mesh_icosahedron.txt", depth,
                                     rng_offset)


def test_plain_renderer_matches_jax_on_bvh_mesh():
    check_plain_renderer_matches_jax("cornell_mesh_icosphere.txt", 4, 3,
                                     backend="xla")


def _torus(depth=4, res=64):
    scene = load_scene(str(REPO / "scenes" / "cornell_mesh_torus.txt"), device="cpu")
    c = scene.camera
    return dataclasses.replace(scene, trace_depth=depth, camera=derive_camera(
        (res, res), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))


@pytest.fixture(scope="module")
def torus_dense_scan():
    scene = _torus()
    image, gbuffer, _ = render(scene, RenderOptions(mesh_bvh=False), num_iterations=2)
    assert (gbuffer[6] > 0).float().mean() > 0.5
    return image, gbuffer


@pytest.mark.parametrize("kwargs", [
    dict(mesh_kernel_impl="v2p"),
    dict(mesh_kernel_impl="v2p", mesh_octant_sort=False),
    dict(mesh_kernel_impl="v2s", mesh_sort_cells=-8),
    dict(mesh_kernel_impl="v2p", mesh_sort_cells=0, mesh_kernel_lanes=128),
    dict(mesh_kernel_impl="v2p", mesh_kernel_lanes=2048),
    dict(mesh_kernel_impl="binned"),
    dict(),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()) or "auto")
def test_mesh_paths_render_the_same_image(torus_dense_scan, kwargs):
    scene = _torus()
    fast = timers.totals().get("binned.fast", 0)
    image, gbuffer, state = render(scene, RenderOptions(**kwargs), num_iterations=2)
    assert torch.equal(image, torus_dense_scan[0])
    assert torch.equal(gbuffer, torus_dense_scan[1])
    assert state.iteration == 2
    if kwargs.get("mesh_kernel_impl") == "binned":
        assert timers.totals()["binned.fast"] > fast


@pytest.mark.parametrize("lanes", [2048, 100])
def test_mesh_kernel_lanes_is_checked_on_the_v2_path_only(lanes):
    """Any ``mesh_kernel_lanes`` constructs (the JAX options take any value);
    "v2", whose CUDA block it is, refuses one that is no block size when it
    runs, naming the limit."""
    opts = RenderOptions(mesh_kernel_impl="v2", mesh_kernel_lanes=lanes)
    with pytest.raises(ValueError, match="a multiple of 128, at most 1024"):
        render(_torus(depth=2, res=16), opts, num_iterations=1)


def test_sorted_tile_draws_the_frame_s_noise():
    """A tile of the frame, rendered with the carry sort and a pixel offset,
    equals the same pixels of the whole frame: the RNG and the final
    scatter-add go by pixel, not by lane."""
    scene = _torus(depth=3, res=32)
    opts = RenderOptions(mesh_kernel_impl="v2p")
    full = trace_iteration(scene, opts, init_render_state(scene, opts))
    tile = init_render_state(scene, opts)
    tile = dataclasses.replace(tile, accum=tile.accum[:, :256].clone(),
                               gbuf=tile.gbuf[:, :256].clone())
    part = trace_iteration(scene, opts, tile, pixel_offset=512)
    assert torch.equal(part.accum, full.accum[:, 512:768])
    assert torch.equal(part.gbuf, full.gbuf[:, 512:768])
    assert part.accum.abs().sum() > 0


def test_bvh_mesh_is_not_megakernel_eligible():
    scene = _torus()
    assert not cuda_backend.pallas_eligible(scene, RenderOptions())
    assert _resolve_backend(scene, RenderOptions()) == "xla"
    with pytest.raises(ValueError, match="ineligible"):
        _resolve_backend(scene, RenderOptions(backend="pallas"))
