"""The port's edge-sampled geometry gradients (render/edge_grad.py) against
the JAX package's, on the scenes of tests/test_edge_grad.py at 64x64.

Host topology (the box's silhouette loop, the mesh's silhouette segments)
is the same numpy code: equal exactly.  The differentiable helpers agree
to 1e-6 relative (float32 operations in another library).  The gradient
functions run with the same samples, iterations and lane salts as JAX's;
their radiances here are deterministic (a black object before an emissive
wall), so they agree to rtol 1e-4 (measured: at most 2e-5 relative, on
the sphere's y component).  The curve tangent is held to
central differences, and the sphere's translation gradient to the
shoelace area oracle of JAX tests/test_edge_grad.py:150 at its 4% bar,
computed in the port alone.  ``mean_radiance`` batched over its
iterations equals its plain loop (``mean_radiance_loop``) bit for bit.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.config import RenderOptions as JaxRenderOptions
from ai_path_tracer_denoiser_tpu.render import edge_grad as jeg
from ai_path_tracer_denoiser_tpu.scene import parse_scene_text as jax_parse
from ai_path_tracer_denoiser_tpu.scene import structs as jstructs
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.ops.intersect import mesh_intersect_v
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import edge_grad as teg
from ai_path_tracer_denoiser_tpu_torch.render import mesh_kernel, mesh_kernel_v2p, mesh_kernel_v3
from ai_path_tracer_denoiser_tpu_torch.scene import parse_scene_text, structs
from test_torch_bvh import rays, soup

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent

SCENE_TEXT = """
// emissive white wall
MATERIAL 0
RGB         1 1 1
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   2

// black diffuse sphere
MATERIAL 1
RGB         0 0 0
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

CAMERA
RES         64 64
FOVY        45
ITERATIONS  8
DEPTH       3
FILE        edge_test
EYE         0 0 6
LOOKAT      0 0 0
UP          0 1 0

// wall behind the sphere, covering the whole frame
OBJECT 0
cube
material 0
TRANS       0 0 -6
ROTAT       0 0 0
SCALE       60 60 0.2

// off-axis sphere (world radius 1)
OBJECT 1
sphere
material 1
TRANS       1.2 0.4 0
ROTAT       0 0 0
SCALE       2 2 2
"""
_SPHERE_BLOCK = """OBJECT 1
sphere
material 1
TRANS       1.2 0.4 0
ROTAT       0 0 0
SCALE       2 2 2
"""
BOX_SCENE_TEXT = SCENE_TEXT.replace(_SPHERE_BLOCK, """OBJECT 1
cube
material 1
TRANS       1.2 0.4 0
ROTAT       20 35 10
SCALE       1.6 1.2 1.4
""")
MESH_SCENE_TEXT = SCENE_TEXT.replace(_SPHERE_BLOCK, """MESH 0
PATH        assets/icosahedron.obj
material 1
TRANS       1.2 0.4 0
ROTAT       15 30 0
SCALE       1.8 1.8 1.8
""")
SCENES = {"sphere": SCENE_TEXT, "box": BOX_SCENE_TEXT, "mesh": MESH_SCENE_TEXT}
OBJ = 1                       # the sphere's / the cube's geom index
JOPTS, OPTS = JaxRenderOptions(antialias=False), RenderOptions(antialias=False)
RTOL, ATOL = 1e-4, 1e-9       # gradient functions against JAX


@pytest.fixture(scope="module")
def scenes():
    return {k: (jax_parse(t, base_dir=str(REPO)),
                parse_scene_text(t, base_dir=str(REPO), device="cpu"))
            for k, t in SCENES.items()}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Helpers against JAX on identical inputs
# ---------------------------------------------------------------------------

def test_box_silhouette_loop_equals_jax(scenes):
    js, ts = scenes["box"]
    for obj_space in (False, True):
        want = jeg.box_silhouette_loop(js.geoms, OBJ, np.asarray(js.camera.position),
                                       object_space=obj_space)
        got = teg.box_silhouette_loop(ts.geoms, OBJ, ts.camera.position,
                                      object_space=obj_space)
        assert got.shape[0] in (4, 6)
        np.testing.assert_array_equal(got, want)


def test_mesh_silhouette_segments_equal_jax(scenes):
    js, ts = scenes["mesh"]
    want = jeg.mesh_silhouette_segments(js.mesh, np.asarray(js.camera.position))
    got = teg.mesh_silhouette_segments(ts.mesh, ts.camera.position)
    assert 6 <= got[0].shape[0] <= 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _phis(n=37):
    return np.linspace(0.01, 2 * np.pi - 0.01, n).astype(np.float32)


def test_sphere_points_projection_and_rays_equal_jax(scenes):
    js, ts = scenes["sphere"]
    center = np.float32([1.2, 0.4, 0.0])
    pos = np.float32([0.1, -0.2, 6.0])
    want = jeg.silhouette_points_sphere(jnp.asarray(center), 1.0, jnp.asarray(pos),
                                        jnp.asarray(_phis()))
    got = teg.silhouette_points_sphere(torch.from_numpy(center), 1.0,
                                       torch.from_numpy(pos), torch.from_numpy(_phis()))
    close(got, want)
    close(teg.project_to_pixels(got, ts.camera),
          jeg.project_to_pixels(want, js.camera), atol=1e-4)
    close(teg.project_to_pixels(got, ts.camera, position=torch.from_numpy(pos)),
          jeg.project_to_pixels(want, js.camera, position=jnp.asarray(pos)), atol=1e-4)
    uv = np.random.default_rng(0).uniform(0, 64, (50, 2)).astype(np.float32)
    (to, td), (jo, jd) = (teg.rays_through_pixels(ts.camera, torch.from_numpy(uv)),
                          jeg.rays_through_pixels(js.camera, jnp.asarray(uv)))
    for a, b in zip((*to, *td), (*jo, *jd)):
        close(a, b)


def test_polygon_points_equal_jax(scenes):
    js, ts = scenes["box"]
    verts = jeg.box_silhouette_loop(js.geoms, OBJ, np.asarray(js.camera.position))
    close(teg.polygon_points(torch.from_numpy(verts), torch.from_numpy(_phis())),
          jeg.polygon_points(jnp.asarray(verts), jnp.asarray(_phis())))


def test_rotation_retrs_and_translate_geom_equal_jax(scenes):
    js, ts = scenes["box"]
    rot = np.float32([20.0, 35.0, 10.0])
    close(teg.rotation_matrix_xyz_deg(torch.from_numpy(rot)),
          jeg.rotation_matrix_xyz_deg(jnp.asarray(rot)))
    drot, dscl, delta = (np.float32([1.5, -2.0, 0.5]), np.float32([0.1, -0.05, 0.2]),
                         np.float32([0.3, -0.7, 0.25]))
    got = teg.retrs_geom(ts.geoms, OBJ, torch.from_numpy(drot), torch.from_numpy(dscl))
    want = jeg.retrs_geom(js.geoms, OBJ, jnp.asarray(drot), jnp.asarray(dscl))
    got_t = teg.translate_geom(ts.geoms, OBJ, torch.from_numpy(delta))
    want_t = jeg.translate_geom(js.geoms, OBJ, jnp.asarray(delta))
    for f in ("translation", "rotation", "scale", "transform", "inverse_transform",
              "inv_transpose"):
        close(getattr(got, f), getattr(want, f))
        close(getattr(got_t, f), getattr(want_t, f))
    # only the moved geom's rows change, and those bit for bit as JAX adds
    np.testing.assert_array_equal(got_t.transform[0].numpy(), ts.geoms.transform[0].numpy())
    np.testing.assert_array_equal(got_t.transform.numpy(), np.asarray(want_t.transform))


def test_translate_mesh_shifts_bvh_rigidly():
    """The port's counterpart of tests/test_bvh.py:188: ``translate_mesh``
    on a mesh with a hierarchy moves the vertices and the four tables as
    JAX's does, bit for bit, and every traversal's plain walk of the moved
    tables equals the dense scan of the moved mesh bit for bit."""
    verts, norms, mats = soup(400, seed=3)
    mesh = structs.make_mesh(verts, norms, mats)
    jmesh = jstructs.make_mesh(verts, norms, mats)
    assert mesh.bvh is not None and jmesh.bvh is not None
    delta = np.float32([0.37, -1.21, 0.58])
    moved = teg.translate_mesh(mesh, torch.from_numpy(delta))
    jmoved = jeg.translate_mesh(jmesh, jnp.asarray(delta))
    np.testing.assert_array_equal(moved.vertices.numpy(), np.asarray(jmoved.vertices))
    for f in ("aabb_lb", "aabb_ub"):
        np.testing.assert_array_equal(getattr(moved, f).numpy(), np.asarray(getattr(jmoved, f)))
    np.testing.assert_array_equal(moved.bvh.faces_packed.numpy(),
                                  np.asarray(jmoved.bvh.faces_packed)[:, :19])
    for f in ("cluster_bounds", "super_bounds", "hyper_bounds"):
        np.testing.assert_array_equal(getattr(moved.bvh, f).numpy(),
                                      np.asarray(getattr(jmoved.bvh, f)), err_msg=f)
    assert np.array_equal(moved.vertices[:400].reshape(400, 9).numpy(),
                          moved.bvh.faces_packed[:400, 0:9].numpy())
    # the source tables are untouched: the update is out of place
    assert torch.equal(mesh.bvh.faces_packed, structs.make_mesh(verts, norms, mats
                                                                ).bvh.faces_packed)
    o_np, d_np = rays(512, seed=9)
    o = Vec3(*(torch.from_numpy(c) for c in o_np))
    d = Vec3(*(torch.from_numpy(c) for c in d_np))
    t_ref, p_ref, n_ref, m_ref = mesh_intersect_v(moved, o, d)
    assert torch.isfinite(t_ref).any()
    for walk in (mesh_kernel.mesh_intersect_bvh_plain,
                 mesh_kernel_v3.mesh_intersect_bvh_v3_plain,
                 mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain):
        t, p, n, m = walk(moved.bvh, o, d)[:4]
        assert torch.equal(t, t_ref) and torch.equal(m, m_ref), walk.__name__
        assert all(torch.equal(a, b) for a, b in zip((*p, *n), (*p_ref, *n_ref)))


@pytest.mark.parametrize("kind", ["sphere", "box", "camera"])
def test_curve_tangent_matches_central_differences(scenes, kind):
    """The boundary term's curve tangent (one jvp with a ones tangent) and
    edge velocity (jacfwd over delta) against central differences of the
    silhouette map: the guard against a batched forward-mode Jacobian
    through ``torch.linalg.solve`` going wrong."""
    _, ts = scenes["box" if kind == "box" else "sphere"]
    cam = ts.camera
    phis = torch.from_numpy(_phis(64)).double()
    if kind == "box":
        verts = torch.from_numpy(teg.box_silhouette_loop(ts.geoms, OBJ, cam.position))

        def uv_fn(delta, p):
            return teg.project_to_pixels(teg.polygon_points(verts.double(), p) + delta,
                                         _double(cam))
    else:
        center = ts.geoms.translation[OBJ].double()

        def uv_fn(delta, p):
            pos = cam.position.double() + (delta if kind == "camera" else 0.0)
            c = center + (0.0 if kind == "camera" else delta)
            return teg.project_to_pixels(teg.silhouette_points_sphere(c, 1.0, pos, p),
                                         _double(cam), position=pos)

    zero = torch.zeros(3, dtype=torch.float64)
    tang = torch.func.jvp(lambda p: uv_fn(zero, p), (phis,), (torch.ones_like(phis),))[1]
    vel = torch.func.jacfwd(lambda d: uv_fn(d, phis))(zero)
    h = 1e-6
    fd_tang = (uv_fn(zero, phis + h) - uv_fn(zero, phis - h)) / (2 * h)
    np.testing.assert_allclose(tang.numpy(), fd_tang.numpy(), rtol=1e-5, atol=1e-5)
    for axis in range(3):
        step = torch.zeros(3, dtype=torch.float64)
        step[axis] = h
        fd_vel = (uv_fn(step, phis) - uv_fn(-step, phis)) / (2 * h)
        np.testing.assert_allclose(vel[..., axis].numpy(), fd_vel.numpy(),
                                   rtol=1e-5, atol=1e-5)


def _double(cam):
    return dataclasses.replace(cam, **{f: getattr(cam, f).double() for f in
                                       ("position", "view", "right", "up",
                                        "pixel_length")})


# ---------------------------------------------------------------------------
# Ray-batch radiance
# ---------------------------------------------------------------------------

def _edge_rays(scenes, n=256):
    js, ts = scenes["sphere"]
    uv = np.random.default_rng(1).uniform(0, 64, (n, 2)).astype(np.float32)
    return (js, ts, jeg.rays_through_pixels(js.camera, jnp.asarray(uv)),
            teg.rays_through_pixels(ts.camera, torch.from_numpy(uv)))


def test_trace_and_mean_radiance_equal_jax(scenes):
    js, ts, (jo, jd), (to, td) = _edge_rays(scenes)
    for it, off in ((1, 0), (3, 1 << 20)):
        want = jeg.trace_radiance(js, JOPTS, jo, jd, jnp.int32(it), lane_offset=off)
        got = teg.trace_radiance(ts, OPTS, to, td, it, lane_offset=off)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jeg.mean_radiance(js, JOPTS, jo, jd, 3, lane_offset=5)
    got = teg.mean_radiance(ts, OPTS, to, td, 3, lane_offset=5)
    for g, w in zip(got, want):
        close(g, w)
    assert float(got.x.min()) == 0.0 and float(got.x.max()) == 2.0


@pytest.mark.parametrize("spp,max_lanes", [(5, 1 << 21), (5, 512)])
def test_batched_mean_radiance_equals_loop(scenes, spp, max_lanes, monkeypatch):
    """All iterations as one batch, and in groups of two (``MAX_BATCH_LANES``
    at 512 lanes), equal the loop bit for bit: cornell at depth 8, where
    paths scatter and end at different bounces."""
    ts = parse_scene_text((REPO / "scenes" / "cornell_box.txt").read_text(),
                          base_dir=str(REPO), device="cpu")
    rng = np.random.default_rng(2)
    uv = torch.from_numpy(rng.uniform(0, 800, (256, 2)).astype(np.float32))
    o, d = teg.rays_through_pixels(ts.camera, uv)
    monkeypatch.setattr(teg, "MAX_BATCH_LANES", max_lanes)
    loop = teg.mean_radiance_loop(ts, RenderOptions(), o, d, spp, lane_offset=7)
    batch = teg.mean_radiance(ts, RenderOptions(), o, d, spp, lane_offset=7)
    assert float(loop.x.max()) > 0
    for a, b in zip(loop, batch):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The gradient functions against JAX
# ---------------------------------------------------------------------------

# name: (scene, call, shading by |normal|).  Shading by |normal|
# (``mesh_normal_view``) makes the radiance depend on the box's rotation
# continuously, so that case has an interior term (about 1e-5 per axis);
# with the default shading every interior term here is zero.
GRADIENTS = {
    "translation_sphere": ("sphere", lambda m, sc, o: m.translation_gradient(
        sc, o, OBJ, n_edge=128, spp=2)),
    "translation_box": ("box", lambda m, sc, o: m.translation_gradient(
        sc, o, OBJ, n_edge=128, spp=2)),
    "rotation_box": ("box", lambda m, sc, o: m.rotation_gradient(
        sc, o, OBJ, n_edge=128, spp=2)),
    "scale_sphere": ("sphere", lambda m, sc, o: m.scale_gradient(
        sc, o, OBJ, n_edge=128, spp=2)),
    "camera_box": ("box", lambda m, sc, o: m.camera_translation_gradient(
        sc, o, n_edge=128, spp=2)),
    "mesh": ("mesh", lambda m, sc, o: m.mesh_translation_gradient(
        sc, o, samples_per_edge=8, spp=2)),
    "rotation_box_normal_view": ("box", lambda m, sc, o, **kw: m.rotation_gradient(
        sc, o, OBJ, n_edge=128, spp=2, **kw)),
}


@pytest.mark.parametrize("name", list(GRADIENTS))
def test_gradient_function_matches_jax(scenes, name):
    kind, call = GRADIENTS[name]
    js, ts = scenes[kind]
    normal_view = name.endswith("normal_view")
    jopts = dataclasses.replace(JOPTS, mesh_normal_view=normal_view)
    opts = dataclasses.replace(OPTS, mesh_normal_view=normal_view)
    want = np.asarray(call(jeg, js, jopts))
    got = call(teg, ts, opts)
    assert isinstance(got, torch.Tensor) and got.shape == (3,) and got.device == ts.device
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if normal_view:
        interior = got - call(teg, ts, opts, include_interior=False)
        assert float(interior.abs().min()) > 1e-6, interior


def test_rotation_gradient_sphere_is_zero(scenes):
    """A uniformly scaled sphere is rotation-invariant: both the boundary
    velocity and the interior term vanish (JAX tests/test_edge_grad.py:408)."""
    _, ts = scenes["sphere"]
    g = teg.rotation_gradient(ts, OPTS, OBJ, n_edge=128, spp=2).numpy()
    assert np.all(np.abs(g) < 1e-4), g


def _shoelace_area(uv):
    x0, y0 = uv[:, 0], uv[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    return abs(np.sum(x0 * y1 - x1 * y0)) / 2.0


def test_translation_gradient_matches_area_oracle(scenes):
    """Boundary estimator == (L_in - L_out)/N_px * dA/dtheta on all three
    axes, with dA/dtheta the central difference of the shoelace area of
    the projected silhouette (JAX tests/test_edge_grad.py:150, here in the
    port alone, at 128x128 as there)."""
    text = SCENE_TEXT.replace("RES         64 64", "RES         128 128")
    ts = parse_scene_text(text, base_dir=str(REPO), device="cpu")
    cam = ts.camera
    w, h = cam.resolution
    g = teg.translation_gradient(ts, OPTS, OBJ, n_edge=512, spp=2, eps_px=0.75).numpy()
    phis = torch.linspace(0, 2 * np.pi, 8192 + 1)[:-1]

    def area(delta):
        c = ts.geoms.translation[OBJ] + torch.from_numpy(delta)
        x = teg.silhouette_points_sphere(c, 1.0, cam.position, phis)
        return _shoelace_area(teg.project_to_pixels(x, cam).numpy().astype(np.float64))

    eps = 2e-3
    for axis in range(3):
        d = np.zeros(3, np.float32)
        d[axis] = eps
        expect = (0.0 - 2.0) * (area(d) - area(-d)) / (2 * eps) / (w * h)
        np.testing.assert_allclose(g[axis], expect, rtol=0.04, atol=2e-6,
                                   err_msg=f"axis {axis}")
    assert g[2] < 0
