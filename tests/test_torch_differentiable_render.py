"""The port's differentiable plain wavefront against the JAX package's.

``trace_iteration(differentiable=True)`` keeps the mesh on the dense scan
and lets autograd reach the materials, the geoms' matrices, the mesh
vertices and the camera.  Its forward is the non-differentiable forward
bit for bit.  Against JAX (cornell 64x64, depth 3, one iteration) it meets
the render bar of tests/test_torch_render.py: G-buffer planes
isclose(1e-5, 1e-5) on >= 99.8% of pixels; the radiance is bit for bit
with antialiasing (measured: 0 of 4096 pixels differ) and within the
mean/PSNR bar without it (measured: 9 grazing hits on the refractive
sphere differ).

Gradients: autograd against ``jax.grad`` where JAX's is finite, at rtol
1e-3 (measured gap below 1e-6 relative); the albedo/emittance gradient
also against central differences at the bar of JAX's
tests/test_render.py (rtol 0.02, atol 1e-4).  JAX's gradient of a
G-buffer loss is NaN on scenes with a sphere or a mesh (its
``jnp.maximum`` multiplies the infinite derivative of ``sqrt`` at 0 by 0
on lanes that miss), where the port's ``clamp_min`` masks those lanes and
stays finite; there the port is held to central differences of its own
forward on the pixels whose hit does not change (depth is smooth within
a surface).  Rays parallel to an axis of a box (a pixel column through
the image centre without antialiasing) divide by an exact 0 in the slab
test in both packages, which makes a camera gradient NaN in both: those
cases run with antialiasing.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.config import RenderOptions as JaxRenderOptions
from ai_path_tracer_denoiser_tpu.render import edge_grad as jeg
from ai_path_tracer_denoiser_tpu.render.wavefront import init_render_state as jax_init
from ai_path_tracer_denoiser_tpu.render.wavefront import trace_iteration as jax_trace
from ai_path_tracer_denoiser_tpu.scene import parse_scene_text as jax_parse
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.ops.intersect import (_matrix_entries, box_intersect_v,
                                                             sphere_intersect_v)
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import cuda_backend, edge_grad, render
from ai_path_tracer_denoiser_tpu_torch.render.wavefront import (_resolve_backend,
                                                                init_render_state,
                                                                trace_iteration)
from ai_path_tracer_denoiser_tpu_torch.scene import parse_scene_text
from ai_path_tracer_denoiser_tpu_torch.scene.structs import SPHERE
from test_torch_edge_grad import BOX_SCENE_TEXT, MESH_SCENE_TEXT, SCENE_TEXT
from test_torch_render import _scenes, assert_gbuffer_close, assert_radiance_close

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cornell():
    return _scenes("cornell_box.txt", 3)


def _state_arrays(state):
    """(accum (3, N), gbuf (7, N)) numpy arrays of either package's state."""
    if isinstance(state.accum, torch.Tensor):
        return state.accum.detach().numpy(), state.gbuf.detach().numpy()
    return (np.stack([np.asarray(a) for a in state.accum]),
            np.stack([np.asarray(a) for a in state.gbuf]))


@pytest.mark.parametrize("antialias", [False, True])
def test_differentiable_forward_equals_plain(cornell, antialias):
    _, ts = cornell
    opts = RenderOptions(antialias=antialias)
    plain = trace_iteration(ts, opts, init_render_state(ts))
    diff = trace_iteration(ts, opts, init_render_state(ts), differentiable=True)
    assert torch.equal(plain.accum, diff.accum) and torch.equal(plain.gbuf, diff.gbuf)
    assert plain.segments == diff.segments


@pytest.mark.parametrize("antialias", [False, True])
def test_differentiable_forward_matches_jax(cornell, antialias):
    js, ts = cornell
    jst = jax_trace(js, JaxRenderOptions(antialias=antialias), jax_init(js),
                    differentiable=True)
    tst = trace_iteration(ts, RenderOptions(antialias=antialias), init_render_state(ts),
                          differentiable=True)
    (ja, jg), (ta, tg) = _state_arrays(jst), _state_arrays(tst)
    res = ts.camera.resolution
    assert_gbuffer_close(np.concatenate([ta, tg]).reshape(10, res[1], res[0]),
                         np.concatenate([ja, jg]).reshape(10, res[1], res[0]))
    if antialias:
        np.testing.assert_array_equal(ta, ja)
    else:
        assert_radiance_close(ta, ja)


def _camera_moved(scene, position):
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera,
                                                                 position=position))


def test_camera_position_gradient_matches_jax(cornell):
    """The counterpart of JAX tests/test_render.py::test_differentiable_path:
    d mean(radiance) / d camera position through one differentiable
    iteration is finite and equals ``jax.grad``'s (both zero here: the
    radiance is a product of albedos and emittances)."""
    js, ts = cornell
    opts = RenderOptions(antialias=False)

    def jloss(p):
        s = _camera_moved(js, p)
        st = jax_trace(s, JaxRenderOptions(antialias=False), jax_init(s),
                       differentiable=True)
        return jnp.mean(jnp.stack(list(st.accum)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(js.camera.position)))
    pos = ts.camera.position.clone().requires_grad_()
    s = _camera_moved(ts, pos)
    accum = trace_iteration(s, opts, init_render_state(s), differentiable=True).accum
    got = (torch.autograd.grad(accum.mean(), pos)[0].numpy() if accum.requires_grad
           else np.zeros(3, np.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-7)


def test_material_gradient_matches_jax_and_finite_differences(cornell):
    """The counterpart of JAX tests/test_render.py:157: the albedo and
    emittance scale gradients against ``jax.grad`` and against central
    differences of the port's own forward."""
    js, ts = cornell
    opts = RenderOptions(antialias=False)

    def radiance(theta):
        mats = dataclasses.replace(ts.materials, color=ts.materials.color * theta[0],
                                   emittance=ts.materials.emittance * theta[1])
        s = dataclasses.replace(ts, materials=mats)
        return trace_iteration(s, opts, init_render_state(s), differentiable=True
                               ).accum.mean()

    def jradiance(theta):
        mats = dataclasses.replace(js.materials, color=js.materials.color * theta[0],
                                   emittance=js.materials.emittance * theta[1])
        s = dataclasses.replace(js, materials=mats)
        st = jax_trace(s, JaxRenderOptions(antialias=False), jax_init(s),
                       differentiable=True)
        return jnp.mean(jnp.stack(list(st.accum)))

    theta = torch.ones(2, requires_grad=True)
    g = torch.autograd.grad(radiance(theta), theta)[0].numpy()
    want = np.asarray(jax.grad(jradiance)(jnp.ones(2, jnp.float32)))
    eps = 1e-3
    for k in range(2):
        step = torch.zeros(2)
        step[k] = eps
        with torch.no_grad():
            fd = (float(radiance(1 + step)) - float(radiance(1 - step))) / (2 * eps)
        assert np.isfinite(g[k]) and abs(g[k]) > 1e-4, g
        np.testing.assert_allclose(g[k], fd, rtol=0.02, atol=1e-4, err_msg=f"param {k}")
        np.testing.assert_allclose(g[k], want[k], rtol=0.02, atol=1e-4)


def _edge_scene(text):
    return (jax_parse(text, base_dir=str(REPO)),
            parse_scene_text(text, base_dir=str(REPO), device="cpu"))


def _gbuffer_loss(state):
    """mean radiance + mean depth + mean normal x: the G-buffer planes are
    where geometry enters continuously."""
    if isinstance(state.accum, torch.Tensor):
        return state.accum.mean() + state.gbuf[3].mean() + state.gbuf[0].mean()
    return (jnp.mean(jnp.stack(list(state.accum))) + jnp.mean(state.gbuf[3])
            + jnp.mean(state.gbuf[0]))


def test_geometry_and_camera_gradients_match_jax():
    """A cube in front of a wall, with antialiasing: d(G-buffer loss) /
    d(camera position, cube translation) equals ``jax.grad``'s."""
    js, ts = _edge_scene(BOX_SCENE_TEXT)

    def jloss(p, d):
        s = dataclasses.replace(_camera_moved(js, p),
                                geoms=jeg.translate_geom(js.geoms, 1, d))
        return _gbuffer_loss(jax_trace(s, JaxRenderOptions(), jax_init(s),
                                       differentiable=True))

    want = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(js.camera.position), jnp.zeros(3))]
    pos = ts.camera.position.clone().requires_grad_()
    delta = torch.zeros(3, requires_grad=True)
    s = dataclasses.replace(_camera_moved(ts, pos),
                            geoms=edge_grad.translate_geom(ts.geoms, 1, delta))
    loss = _gbuffer_loss(trace_iteration(s, RenderOptions(), init_render_state(s),
                                         differentiable=True))
    got = [g.numpy() for g in torch.autograd.grad(loss, (pos, delta))]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.abs(g).max() > 1e-3
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("what", ["mesh", "sphere", "camera"])
def test_gradients_match_central_differences(what):
    """Mesh vertices, a sphere's matrices and the camera position: the
    gradient of the summed depth over the pixels that hit the same object
    in all three renders (base, +eps, -eps along each axis) and whose two
    one-sided differences agree (a ray that crosses an edge between two
    of the mesh's faces does not) against central differences of that
    masked loss."""
    text = MESH_SCENE_TEXT if what == "mesh" else SCENE_TEXT
    _, ts = _edge_scene(text)
    opts = RenderOptions(antialias=what == "camera")

    def moved(delta):
        if what == "mesh":
            return dataclasses.replace(ts, mesh=edge_grad.translate_mesh(ts.mesh, delta))
        if what == "sphere":
            return dataclasses.replace(ts, geoms=edge_grad.translate_geom(ts.geoms, 1, delta))
        return _camera_moved(ts, ts.camera.position + delta)

    def planes(delta):
        s = moved(delta)
        st = trace_iteration(s, opts, init_render_state(s), differentiable=True)
        # albedo after the first shade tells the black object (0) from the
        # emissive wall (2)
        return st.gbuf[3], st.gbuf[4] < 1.0

    eps = 1e-2
    delta = torch.zeros(3, requires_grad=True)
    depth, on_obj = planes(delta)
    for axis in range(3):
        step = torch.zeros(3)
        step[axis] = eps
        with torch.no_grad():
            d_p, m_p = planes(step)
            d_m, m_m = planes(-step)
        keep = (on_obj == m_p) & (on_obj == m_m) & (depth.detach() > 0)
        keep &= (d_p > 0) & (d_m > 0)
        d0 = depth.detach()
        keep &= ((d_p - d0) - (d0 - d_m)).abs() <= 0.05 * (d_p - d_m).abs() + 4e-6
        assert int(keep.sum()) > 1000
        (g,) = torch.autograd.grad((depth * keep).sum(), delta, retain_graph=True)
        fd = float(((d_p - d_m) * keep).sum()) / (2 * eps)
        assert np.isfinite(g.numpy()).all()
        # float32 depths round by about 1e-6: 1e-4 per pixel in fd
        np.testing.assert_allclose(float(g[axis]), fd, rtol=2e-3,
                                   atol=1e-5 * int(keep.sum()),
                                   err_msg=f"{what} axis {axis}")


def test_differentiable_render_is_never_the_megakernel(cornell):
    _, ts = cornell
    assert cuda_backend.pallas_eligible(ts, RenderOptions())
    assert not cuda_backend.pallas_eligible(ts, RenderOptions(), differentiable=True)
    assert _resolve_backend(ts, RenderOptions(), differentiable=True) == "xla"
    with pytest.raises(ValueError, match="differentiable render"):
        _resolve_backend(ts, RenderOptions(backend="pallas"), differentiable=True)
    with pytest.raises(ValueError, match="differentiable render"):
        render(ts, RenderOptions(backend="pallas"), num_iterations=1,
               differentiable=True)


def test_render_differentiable_passes_a_gradient(cornell):
    """``render(differentiable=True)`` runs the plain wavefront on its
    differentiable path: its image equals the plain render's and the
    G-buffer's depth carries a gradient to the geoms' matrices."""
    _, ts = cornell
    t = ts.geoms.transform.clone().requires_grad_()
    inv = ts.geoms.inverse_transform.clone().requires_grad_()
    s = dataclasses.replace(ts, geoms=dataclasses.replace(ts.geoms, transform=t,
                                                          inverse_transform=inv))
    img, gbuf, _ = render(s, RenderOptions(backend="xla"), num_iterations=2,
                          differentiable=True)
    plain, plain_gbuf, _ = render(ts, RenderOptions(backend="xla"), num_iterations=2)
    assert torch.equal(img, plain) and torch.equal(gbuf, plain_gbuf)
    g_t, g_inv = torch.autograd.grad(gbuf[6].mean(), (t, inv))
    assert np.isfinite(g_t.numpy()).all() and np.isfinite(g_inv.numpy()).all()
    assert g_inv.abs().max() > 0


def test_intersect_tensor_matrices_equal_python_floats(cornell):
    """The geoms' matrices enter the intersection tests as 0-dim tensors
    (so that a gradient reaches them); every plane equals the one the
    same tests give with python-float entries, bit for bit, for each of
    cornell's geoms on 4096 random rays."""
    _, ts = cornell
    rng = np.random.default_rng(3)
    o = Vec3(*torch.from_numpy(rng.uniform(-4, 4, (3, 4096)).astype(np.float32)))
    d = Vec3(*torch.from_numpy(rng.normal(size=(3, 4096)).astype(np.float32))).normalized()
    g = ts.geoms
    mats = [(m.tolist(), _matrix_entries(m)) for m in (g.transform, g.inverse_transform,
                                                       g.inv_transpose)]
    for i, ty in enumerate(g.type.tolist()):
        floats, tensors = ([m[k][i] for m in mats] for k in (0, 1))
        if ty == SPHERE:
            want, got = sphere_intersect_v(*floats, o, d), sphere_intersect_v(*tensors, o, d)
        else:
            want, got = box_intersect_v(*floats[:2], o, d), box_intersect_v(*tensors[:2], o, d)
        for w, t in zip(want, got):
            for a, b in zip(w if isinstance(w, Vec3) else (w,), t if isinstance(t, Vec3) else (t,)):
                assert torch.equal(a, b), (i, ty)


def test_normal_view_interior_term_is_nan_in_both(cornell):
    """Shading by |normal| makes cornell's radiance depend on the light's
    rotation, and the interior term is NaN in JAX and in the port alike:
    the sphere test's ``sqrt`` of a radicand clamped to 0 has an infinite
    derivative, times a zero cotangent on the lanes that miss."""
    js, ts = cornell

    def j_interior(delta):
        s = dataclasses.replace(js, geoms=jeg.retrs_geom(js.geoms, 0, delta, jnp.zeros((3,))))
        state = jax_trace(s, JaxRenderOptions(mesh_normal_view=True), jax_init(s),
                          differentiable=True)
        return jnp.mean(jnp.stack(list(state.accum)))

    want = np.asarray(jax.grad(j_interior)(jnp.zeros((3,))))
    got = edge_grad._interior_gradient(
        ts, RenderOptions(mesh_normal_view=True), lambda d: dataclasses.replace(
            ts, geoms=edge_grad.retrs_geom(ts.geoms, 0, d, torch.zeros(3))))
    assert np.isnan(want).all() and torch.isnan(got).all(), (want, got)
