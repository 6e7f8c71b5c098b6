"""The port's renderer against the JAX package's.

The JAX side runs ``render(..., RenderOptions(backend="xla"))``, which
tests/test_pallas.py holds bitwise equal to the TPU megakernel; the port's
side is the megakernel's plain PyTorch version (what ``render_cuda`` runs
on CPU tensors).  64x64 frames, 2 iterations.

Tolerances: the depth-0 G-buffer planes are deterministic, so they agree
to float32 rounding (isclose rtol 1e-5, atol 1e-5) on at least 99.8% of
pixels.  The pixels that miss that bar (2-6 of 4096 here) are all grazing
hits on the refractive sphere: XLA:CPU contracts multiply-adds and rounds
rsqrt differently from PyTorch, the rays differ in the last bit, and the
cancellation in the sphere quadratic (intersections.h:106-148) grows that
to ~1e-4 in depth and normal.  Radiance is compared by mean (relative
error < 1e-3) and PSNR (>= 40 dB), since a near-tie hit can send one path
down another branch.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.config import RenderOptions as JaxRenderOptions
from ai_path_tracer_denoiser_tpu.render import init_render_state as jax_init_state
from ai_path_tracer_denoiser_tpu.render import render as jax_render
from ai_path_tracer_denoiser_tpu.scene import load_scene as jax_load_scene
from ai_path_tracer_denoiser_tpu.scene.camera import derive_camera as jax_derive
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.render import (cuda_backend,
                                                      init_render_state, render)
from ai_path_tracer_denoiser_tpu_torch.render.wavefront import _resolve_backend
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 64


def _scenes(name, depth):
    path = str(REPO / "scenes" / name)
    js = jax_load_scene(path)
    js = dataclasses.replace(js, trace_depth=depth, camera=jax_derive(
        (RES, RES), 45.0, np.asarray(js.camera.position),
        np.asarray(js.camera.look_at), np.asarray(js.camera.up)))
    ts = load_scene(path, device="cpu")
    c = ts.camera
    ts = dataclasses.replace(ts, trace_depth=depth, camera=derive_camera(
        (RES, RES), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))
    return js, ts


def assert_gbuffer_close(got, want, min_frac=0.998):
    """(10, H, W) G-buffers: planes 3-9 close on >= min_frac of pixels."""
    ok = np.isclose(got[3:], want[3:], rtol=1e-5, atol=1e-5).all(axis=0)
    assert ok.mean() >= min_frac, f"only {ok.mean():.5f} of pixels agree"


def assert_radiance_close(got, want):
    rel = abs(float(got.mean()) - float(want.mean())) / max(float(want.mean()), 1e-8)
    assert rel < 1e-3, rel
    mse = float(((got - want) ** 2).mean())
    peak = max(float(want.max()), 1.0)
    psnr = 10 * np.log10(peak ** 2 / max(mse, 1e-30))
    assert psnr >= 40.0, psnr


def check_plain_renderer_matches_jax(name, depth, rng_offset):
    js, ts = _scenes(name, depth)
    jstate = dataclasses.replace(jax_init_state(js), rng_offset=jnp.int32(rng_offset))
    _, jg, _ = jax_render(js, JaxRenderOptions(backend="xla"), num_iterations=2,
                          state=jstate)
    tstate = dataclasses.replace(init_render_state(ts), rng_offset=rng_offset)
    # backend="pallas" on CPU tensors: render_cuda's plain version
    opts = RenderOptions(backend="pallas")
    assert _resolve_backend(ts, opts) == "pallas"
    _, tg, st = render(ts, opts, num_iterations=2, state=tstate)
    assert st.iteration == 2 and st.segments >= 2 * RES * RES
    jg, tg = np.asarray(jg), tg.numpy()
    assert tg.shape == jg.shape == (10, RES, RES)
    assert (tg[6] > 0).mean() > 0.5          # depth filled on most pixels
    assert_gbuffer_close(tg, jg)
    assert_radiance_close(tg[:3], jg[:3])


@pytest.mark.parametrize("depth,rng_offset", [(8, 0), (3, 11)])
def test_plain_renderer_matches_jax(depth, rng_offset):
    check_plain_renderer_matches_jax("cornell_box.txt", depth, rng_offset)


def test_pixel_offset_tile_matches_frame():
    """A state holding a tile of the frame renders that tile's pixels."""
    _, ts = _scenes("cornell_box.txt", 3)
    opts = RenderOptions()
    full = cuda_backend.render_cuda(ts, opts, 2)
    tile = init_render_state(ts)
    tile = dataclasses.replace(tile, accum=tile.accum[:, :1024].clone(),
                               gbuf=tile.gbuf[:, :1024].clone())
    part = cuda_backend.render_cuda(ts, opts, 2, tile, pixel_offset=2048)
    np.testing.assert_array_equal(part.accum.numpy(),
                                  full.accum[:, 2048:3072].numpy())
    np.testing.assert_array_equal(part.gbuf.numpy(), full.gbuf[:, 2048:3072].numpy())


def test_backend_routing():
    _, ts = _scenes("cornell_box.txt", 3)
    assert cuda_backend.pallas_eligible(ts, RenderOptions())
    assert _resolve_backend(ts, RenderOptions()) == "xla"     # CPU tensors
    assert _resolve_backend(ts, RenderOptions(backend="xla")) == "xla"
    bf16 = RenderOptions(accum_dtype="bfloat16", backend="pallas")
    with pytest.raises(ValueError):
        _resolve_backend(ts, bf16)
    with pytest.raises(NotImplementedError):
        render(ts, RenderOptions(sort_material=True), num_iterations=1)


def test_render_work_counts():
    _, ts = _scenes("cornell_mesh_icosahedron.txt", 3)
    n_bytes, ops = cuda_backend.render_work(ts, RES * RES, 1, 3 * RES * RES)
    assert n_bytes > 80 * RES * RES
    assert ops > 3 * RES * RES * 20 * cuda_backend.OPS_TRIANGLE

