"""The plain wavefront's three optional stages (material sort, first-bounce
cache, motion blur) against the JAX wavefront, on the CPU.

64x64 frames through ``render(..., backend="xla")`` of both packages.
Tolerances are the renderer's (ROADMAP queue C, tests/test_torch_render.py):
G-buffer planes isclose(rtol 1e-5, atol 1e-5) on at least 99.8% of pixels,
radiance by mean (relative error < 1e-3) and PSNR (>= 40 dB).
scenes/cornell_motion_blur.txt has two spheres, and 9 of its 4096 pixels,
all on them, miss the isclose bar by up to 9e-5 (the sphere quadratic's
cancellation; 2-6 pixels on the cornell box's one sphere): its share is
99.7%.  Without jitter the primary rays pass exactly through pixel centres,
and 4 of 4096 of them meet the edge between two walls, where the two
packages pick different geoms: the cached material ids are held to the
same 99.8%.  The moved
geometry (``advance_geoms``) agrees to 1e-6: both packages build the same
float32 matrices and invert them with LAPACK-style routines that round
differently in the last bits.  Inside the port the sort and the cache are
pure permutations / value selects, so those renders equal the plain one bit
for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.config import RenderOptions as JaxRenderOptions
from ai_path_tracer_denoiser_tpu.render import motion_blur as jmotion_blur
from ai_path_tracer_denoiser_tpu.render import render as jax_render
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.render import motion_blur, render
from ai_path_tracer_denoiser_tpu_torch.render.wavefront import _maybe_sort_by_material
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.utils.debug import assert_render_finite
from test_torch_render import _scenes, assert_gbuffer_close, assert_radiance_close

torch.set_num_threads(2)
GEOM_ATOL = 1e-6


def both_renders(name, depth, iterations, **flags):
    js, ts = _scenes(name, depth)
    _, jg, jstate = jax_render(js, JaxRenderOptions(backend="xla", **flags),
                               num_iterations=iterations)
    _, tg, tstate = render(ts, RenderOptions(backend="xla", **flags),
                           num_iterations=iterations)
    return (js, ts), (np.asarray(jg), tg.numpy()), (jstate, tstate)


@pytest.mark.parametrize("name,flags,iterations,min_frac", [
    ("cornell_box.txt", dict(sort_material=True), 2, 0.998),
    ("cornell_box.txt", dict(cache_first_bounce=True, antialias=False), 3, 0.998),
    ("cornell_motion_blur.txt", dict(motion_blur=True), 5, 0.997),
], ids=["sort_material", "cache_first_bounce", "motion_blur"])
def test_option_matches_jax_wavefront(name, flags, iterations, min_frac):
    _, (jg, tg), (jstate, tstate) = both_renders(name, 4, iterations, **flags)
    assert tg.shape == jg.shape == (10, 64, 64) and (tg[6] > 0).mean() > 0.5
    assert_gbuffer_close(tg, jg, min_frac)
    assert_radiance_close(tg[:3], jg[:3])
    if "motion_blur" in flags:
        # iteration 4 moved the geoms, and the state carries them
        for f in ("translation", "transform", "inverse_transform", "inv_transpose"):
            np.testing.assert_allclose(getattr(tstate.geoms, f).numpy(),
                                       np.asarray(getattr(jstate.geoms, f)),
                                       rtol=0, atol=GEOM_ATOL, err_msg=f)
    if "cache_first_bounce" in flags:
        t, point, normal, mat = tstate.cache
        same = mat.numpy() == np.asarray(jstate.cache_mat)
        close = np.isclose(t.numpy(), np.asarray(jstate.cache_t), rtol=1e-5, atol=1e-5)
        assert (same & close).mean() >= 0.998 and (mat.numpy() >= 0).mean() > 0.5


def test_advance_geoms_matches_jax():
    js, ts = _scenes("cornell_motion_blur.txt", 3)
    assert float(ts.geoms.vel.abs().sum()) > 0
    jg, tg = js.geoms, ts.geoms
    for _ in range(3):
        jg, tg = jmotion_blur.advance_geoms(jg), motion_blur.advance_geoms(tg)
    for f in ("translation", "transform", "inverse_transform", "inv_transpose"):
        np.testing.assert_allclose(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                   rtol=0, atol=GEOM_ATOL, err_msg=f)
    moving = (ts.geoms.vel != 0).any(dim=1)
    assert moving.any() and not moving.all()
    # geoms at rest keep their matrices bit for bit (moveGeom's early-out)
    assert torch.equal(tg.transform[~moving], ts.geoms.transform[~moving])
    assert not torch.equal(tg.transform[moving], ts.geoms.transform[moving])
    assert tg.type_tuple == ts.geoms.type_tuple


def test_build_matrices_matches_jax():
    rng = np.random.default_rng(0)
    tr, rot, sc = (rng.uniform(lo, hi, (6, 3)).astype(np.float32)
                   for lo, hi in ((-5, 5), (-180, 180), (0.2, 4)))
    want = jmotion_blur._build_matrices(jnp.asarray(tr), jnp.asarray(rot), jnp.asarray(sc))
    got = motion_blur._build_matrices(*(torch.from_numpy(a) for a in (tr, rot, sc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=GEOM_ATOL)


@pytest.mark.parametrize("name,flags", [
    ("cornell_box.txt", dict(sort_material=True)),
    ("cornell_box.txt", dict(sort_material=True, cache_first_bounce=True, antialias=False)),
    ("cornell_mesh_icosphere.txt", dict(sort_material=True)),
    ("cornell_mesh_icosphere.txt", dict(sort_material=True, mesh_octant_sort=False)),
    ("cornell_mesh_icosphere.txt", dict(cache_first_bounce=True, antialias=False,
                                        mesh_kernel_impl="v3")),
], ids=["sort", "sort+cache", "mesh-sort", "mesh-sort-only", "mesh-cache-v3"])
def test_sort_and_cache_do_not_change_the_render(name, flags):
    _, ts = _scenes(name, 4)
    base = {k: v for k, v in flags.items() if k in ("antialias", "mesh_kernel_impl")}
    _, want, _ = render(ts, RenderOptions(backend="xla", **base), num_iterations=3)
    _, got, state = render(ts, RenderOptions(backend="xla", **flags), num_iterations=3)
    assert torch.equal(got, want)
    assert (state.cache is not None) == ("cache_first_bounce" in flags)


def test_material_sort_is_a_stable_permutation_with_dead_lanes_last():
    n = 64
    rng = np.random.default_rng(1)
    mat = torch.from_numpy(rng.integers(-1, 4, n).astype(np.int32))
    alive = torch.from_numpy(rng.uniform(size=n) < 0.7)
    plane = torch.arange(n, dtype=torch.float32)
    vec = Vec3(plane, plane + 100, plane + 200)
    carry = (vec, vec, vec, alive.to(torch.int32), torch.arange(n))
    assert _maybe_sort_by_material(RenderOptions(), mat, alive, carry) is carry
    _, _, color, remaining, pixel_index = _maybe_sort_by_material(
        RenderOptions(sort_material=True), mat, alive, carry)
    key = np.where(alive.numpy(), mat.numpy(), 2 ** 30)
    np.testing.assert_array_equal(pixel_index.numpy(), np.argsort(key, kind="stable"))
    assert torch.equal(color.y, pixel_index.to(torch.float32) + 100)
    n_alive = int(alive.sum())
    assert remaining[:n_alive].all() and not remaining[n_alive:].any()


def test_motion_blur_moves_every_fourth_iteration():
    _, ts = _scenes("cornell_motion_blur.txt", 2)
    opts = RenderOptions(motion_blur=True)
    _, _, s3 = render(ts, opts, num_iterations=3)
    assert torch.equal(s3.geoms.transform, ts.geoms.transform)
    _, _, s8 = render(ts, opts, num_iterations=5, state=s3)
    twice = motion_blur.advance_geoms(motion_blur.advance_geoms(ts.geoms))
    assert torch.equal(s8.geoms.transform, twice.transform)
    _, still, _ = render(ts, RenderOptions(backend="xla"), num_iterations=8)
    _, moved, _ = render(ts, opts, num_iterations=8)
    assert torch.equal(moved[3:], still[3:])          # the G-buffer is iteration 1's
    assert not torch.equal(moved[:3], still[:3])


def test_assert_render_finite_names_the_iteration():
    _, ts = _scenes("cornell_box.txt", 2)
    state = assert_render_finite(ts, RenderOptions(motion_blur=True), num_iterations=2)
    assert state.iteration == 2
    bad = dataclasses.replace(ts, materials=dataclasses.replace(
        ts.materials, color=ts.materials.color * float("nan")))
    with pytest.raises(FloatingPointError, match="after iteration 1"):
        assert_render_finite(bad, RenderOptions(), num_iterations=2)
