"""The render megakernel K1's host-side helpers, on the CPU.

``path_segments`` (each pixel's ray segments per iteration, from the plain
bounce loop) against the plain renderer's own count; ``lane_efficiency``
against a count by hand; the persistent launch's chunk plan; the
operation count of ``render_work`` against a count by hand; the scene's
home in shared memory and the routing of a scene past it.  The kernel
itself is held to its plain version and to its one-pixel-per-thread
witness on the card (tests/test_torch_cuda.py); the renderer against the
JAX one in tests/test_torch_render.py.  Integer
counts are compared exactly.  64x64 fixtures and smaller.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.render import cuda_backend, init_render_state, render
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _scene(name, res, depth=8):
    scene = load_scene(str(REPO / "scenes" / name), device="cpu")
    c = scene.camera
    return dataclasses.replace(scene, trace_depth=depth, camera=derive_camera(
        (res, res), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))


@pytest.mark.parametrize("name,depth,culling,niter,rng_offset,tile", [
    ("cornell_box.txt", 8, True, 2, 0, False),
    ("cornell_box.txt", 3, True, 3, 11, False),
    ("cornell_mesh_icosahedron.txt", 8, True, 2, 5, False),
    ("cornell_mesh_icosahedron.txt", 8, False, 2, 5, False),
    ("cornell_box.txt", 8, True, 2, 3, True)])
def test_path_segments_sum_to_the_plain_segments(name, depth, culling, niter, rng_offset,
                                                 tile):
    scene = _scene(name, 64, depth)
    opts = RenderOptions(ray_culling=culling)
    state = dataclasses.replace(init_render_state(scene, opts), rng_offset=rng_offset)
    offset = 0
    if tile:                       # 1,001 pixels from id 1517, from iteration 1 on
        state = dataclasses.replace(state, accum=state.accum[:, :1001].clone(),
                                    gbuf=state.gbuf[:, :1001].clone(), iteration=1)
        offset = 1517
    plain = cuda_backend.render_cuda_plain(scene, opts, niter, state, offset)
    seg = cuda_backend.path_segments(scene, opts, niter, state, offset)
    n = state.accum.shape[1]
    assert seg.shape == (niter, n) and seg.dtype == torch.int32
    assert int(seg.sum()) == plain.segments - state.segments
    assert int(seg.min()) >= 1 and int(seg.max()) <= depth
    assert int(seg.max()) > 1                      # some path bounces


def test_lane_efficiency_equals_a_hand_count():
    scene = _scene("cornell_box.txt", 8)           # 64 pixels: two warps
    seg = cuda_backend.path_segments(scene, RenderOptions(), 3)
    steps = 0
    for it in seg.tolist():
        for w in range(0, len(it), 32):
            steps += 32 * max(it[w:w + 32])
    assert cuda_backend.lane_efficiency(seg) == int(seg.sum()) / steps
    # a ragged last warp still takes 32 lanes: 40 pixels = 2 warps
    made = torch.tensor([[2] * 32 + [1] * 7 + [5], [1] * 40], dtype=torch.int32)
    assert cuda_backend.lane_efficiency(made) == (64 + 12 + 40) / (32 * (2 + 5) + 32 * (1 + 1))
    assert cuda_backend.lane_efficiency(made, warp=8) == 116 / (8 * (2 * 4 + 5) + 8 * 5)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4097])
@pytest.mark.parametrize("threads,blocks_per_sm,chunk", [(128, 0, 32), (32, 1, 1),
                                                         (256, 3, 7), (64, 2, 5000)])
def test_chunk_plan_covers_each_pixel_once(n, threads, blocks_per_sm, chunk):
    plan = cuda_backend.k1_plan(n, sm_count=132, fit_per_sm=6, threads=threads,
                                blocks_per_sm=blocks_per_sm, chunk=chunk)
    assert plan.threads == threads and plan.chunk == chunk
    per_sm = 6 if blocks_per_sm == 0 else min(blocks_per_sm, 6)
    assert 1 <= plan.blocks <= min(132 * per_sm, -(-n // threads))
    ranges = plan.chunk_ranges(pixel_offset=1517)
    ids = [p for r in ranges for p in r]
    assert sorted(ids) == list(range(1517, 1517 + n)) and len(set(ids)) == n
    assert len(ranges) == plan.chunks and all(len(r) > 0 for r in ranges)
    counter = plan.counter("cpu")
    assert counter.dtype == torch.int32 and counter.tolist() == [0]


@pytest.mark.parametrize("kwargs", [dict(threads=48), dict(threads=512), dict(chunk=0),
                                    dict(fit_per_sm=0), dict(n=2 ** 31 - 40)])
def test_chunk_plan_rejects_what_the_kernel_cannot_take(kwargs):
    args = dict(n=4097, sm_count=132, fit_per_sm=6)
    args.update(kwargs)
    with pytest.raises(ValueError):
        cuda_backend.k1_plan(**args)


def test_render_work_counts_one_box_one_sphere_and_twelve_faces():
    scene = _scene("cornell_box.txt", 16)
    mesh = _scene("cornell_mesh_icosahedron.txt", 16).mesh
    types = scene.geoms.type.tolist()
    keep = torch.tensor([types.index(1), types.index(0)])          # a box, a sphere
    geoms = dataclasses.replace(scene.geoms, **{
        f.name: getattr(scene.geoms, f.name)[keep] for f in dataclasses.fields(scene.geoms)
        if isinstance(getattr(scene.geoms, f.name), torch.Tensor)}, type_tuple=(1, 0))
    scene = dataclasses.replace(scene, geoms=geoms,
                                mesh=dataclasses.replace(mesh, num_faces=12))
    mats = scene.materials.count
    n_bytes, ops = cuda_backend.render_work(scene, 256, 3, 1000)
    # a box test 115, a sphere test 95, the winner's normal 25, shading 100,
    # the AABB gate 27 and 12 face tests of 60 per segment; 40 per ray generated
    assert ops == 1000 * (115 + 95 + 25 + 100 + 27 + 12 * 60) + 256 * 3 * 40
    floats = 2 * 48 + mats * 10 + 12 * 18 + 6
    assert n_bytes == 80 * 256 + 4 * (floats + 2 * 2 + 12)
    # without geoms no world normal is made
    bare = dataclasses.replace(scene, geoms=dataclasses.replace(
        geoms, **{f.name: getattr(geoms, f.name)[:0] for f in dataclasses.fields(geoms)
                  if isinstance(getattr(geoms, f.name), torch.Tensor)}, type_tuple=()))
    assert cuda_backend.render_work(bare, 256, 3, 1000)[1] == (
        1000 * (100 + 27 + 12 * 60) + 256 * 3 * 40)


def test_a_scene_too_large_for_the_kernel_home_raises():
    """The packed scene lives in each block's shared memory (at most 227 KB
    on an H100); a scene past that raises, it is not put elsewhere."""
    limit = cuda_backend.SCENE_HOME_BYTES
    assert cuda_backend.check_scene_home(7, 8, 64) == cuda_backend.scene_home_bytes(7, 8, 64)
    geoms = (limit - 4 * (10 + 6)) // (4 * (48 + 2))                # fills the home
    assert cuda_backend.scene_home_bytes(geoms, 1, 0) <= limit
    cuda_backend.check_scene_home(geoms, 1, 0)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_backend.check_scene_home(geoms + 1, 1, 0)
    scene = _scene("cornell_box.txt", 8)
    big = torch.arange(geoms + 1) % scene.geoms.count
    many = dataclasses.replace(scene, geoms=dataclasses.replace(scene.geoms, **{
        f.name: getattr(scene.geoms, f.name)[big] for f in dataclasses.fields(scene.geoms)
        if isinstance(getattr(scene.geoms, f.name), torch.Tensor)}))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_backend.pack_scene(many)
    floats, ints = cuda_backend.pack_scene(scene)                    # the real one fits
    assert 4 * (floats.numel() + ints.numel()) == cuda_backend.scene_home_bytes(
        scene.geoms.count, scene.materials.count, scene.mesh.num_faces)


def crowded_cornell(path, spheres=1200):
    """scenes/cornell_box.txt plus ``spheres`` small spheres, written to ``path``."""
    rng = np.random.default_rng(7)
    blocks = [f"OBJECT {7 + k}\nsphere\nmaterial {k % 4 + 1}\n"
              f"TRANS {x:.3f} {y:.3f} {z:.3f}\nROTAT 0 0 0\nSCALE .1 .1 .1\n"
              for k, (x, y, z) in enumerate(rng.uniform((-4, 1, -4), (4, 9, 4), (spheres, 3)))]
    path.write_text((REPO / "scenes" / "cornell_box.txt").read_text() + "\n"
                    + "\n".join(blocks))
    return str(path)


def test_a_scene_past_the_kernel_home_takes_the_plain_wavefront(tmp_path):
    """Routing by eligibility: a packed scene larger than a block's shared
    memory is not the megakernel's, so "auto" takes the plain wavefront and
    a forced "pallas" raises the ineligible error (on the CPU too)."""
    scene = load_scene(crowded_cornell(tmp_path / "crowded.txt"), device="cpu")
    c = scene.camera
    scene = dataclasses.replace(scene, camera=derive_camera(
        (64, 64), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))
    assert scene.geoms.count == 1207
    assert cuda_backend.scene_home_bytes(scene.geoms.count, scene.materials.count,
                                         scene.mesh.num_faces) > cuda_backend.SCENE_HOME_BYTES
    assert not cuda_backend.pallas_eligible(scene, RenderOptions())
    with pytest.raises(ValueError, match="ineligible.*shared memory"):
        render(scene, RenderOptions(backend="pallas"), num_iterations=1)
    img, gbuf, state = render(scene, RenderOptions(), num_iterations=1)
    assert state.iteration == 1 and torch.isfinite(gbuf).all() and img.shape == (64, 64, 3)
    assert cuda_backend.pallas_eligible(_scene("cornell_box.txt", 64), RenderOptions())


def test_launch_megakernel_does_not_take_cpu_tensors():
    """The launcher only launches: CPU buffers raise (``render_cuda`` runs
    the plain version for them) and count no launch."""
    scene = _scene("cornell_box.txt", 8)
    floats, ints = cuda_backend.pack_scene(scene)
    launches = cuda_backend.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_backend.launch_megakernel(
            floats, ints, cuda_backend.camera_row(scene), torch.zeros((3, 64)),
            torch.zeros((7, 64)),
            counts=(scene.geoms.count, scene.materials.count, scene.mesh.num_faces),
            resolution=scene.camera.resolution, depth=scene.trace_depth,
            flags=cuda_backend._flags(RenderOptions()))
    assert cuda_backend.KERNEL.launches == launches
