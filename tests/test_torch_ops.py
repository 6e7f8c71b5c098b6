"""The PyTorch port's ray math against the JAX package: RNG bit for bit,
the pixel-id split, and the intersection and BSDF primitives in float32.

Inputs are made with numpy from a seed and handed to both packages.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.ops import bsdf as jbsdf
from ai_path_tracer_denoiser_tpu.ops import intersect as jisect
from ai_path_tracer_denoiser_tpu.ops import rng as jrng
from ai_path_tracer_denoiser_tpu.ops.vec3 import Vec3 as JVec3
from ai_path_tracer_denoiser_tpu.scene.structs import geom_matrices
from ai_path_tracer_denoiser_tpu_torch.ops import bsdf, intersect, rng
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
N = 200_000


def _u32(seed, n=N):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _np(v):
    return np.stack([np.asarray(c) for c in v], -1)


def test_utilhash_bitwise():
    a = _u32(0)
    want = np.asarray(jrng.utilhash(jnp.asarray(a.astype(np.uint32))))
    got = rng.utilhash(torch.from_numpy(a.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_seeded_engine_and_lcg_bitwise():
    it = _u32(1) % 5000
    idx = _u32(2)
    depth = _u32(3) % 9
    want = np.asarray(jrng.make_seeded_engine(
        jnp.asarray(it.astype(np.uint32)), jnp.asarray(idx.astype(np.uint32)),
        jnp.asarray(depth.astype(np.uint32))))
    got = rng.make_seeded_engine(torch.from_numpy(it.astype(np.int64)),
                                 torch.from_numpy(idx.astype(np.int64)),
                                 torch.from_numpy(depth.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # minstd steps over the whole state range, including the ends
    states = np.concatenate([(_u32(4) % (2 ** 31 - 2)) + 1,
                             [1, 2, 2 ** 31 - 2, 48271, 44488]]).astype(np.int64)
    want = np.asarray(jrng.lcg_next(jnp.asarray(states.astype(np.int32))))
    got = rng.lcg_next(torch.from_numpy(states)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_draw_uniforms_bitwise(mode):
    idx = _u32(5)
    depth = _u32(6) % 9
    want = np.asarray(jrng.draw_uniforms(
        7, jnp.asarray(idx.astype(np.uint32)),
        jnp.asarray(depth.astype(np.uint32)), 2, mode))
    got = rng.draw_uniforms(7, torch.from_numpy(idx.astype(np.int64)),
                            torch.from_numpy(depth.astype(np.int64)), 2,
                            mode).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", [64, 800, 1920])
def test_pixel_split_matches_float_fixup(w):
    """The port splits pid -> (x, y) with integer division; the TPU
    megakernel used a float reciprocal plus an integer fix-up.  Both give
    the same (x, y) for every pixel id of a frame."""
    pid = np.arange(w * min(w, 1080), dtype=np.int64)
    inv_w = np.float32(1.0 / w)
    y_est = np.floor((pid.astype(np.float32) + np.float32(0.5)) * inv_w).astype(np.int64)
    x_int = pid - y_est * w
    y_est = np.where(x_int < 0, y_est - 1, y_est)
    x_int = np.where(x_int < 0, x_int + w, x_int)
    y_est = np.where(x_int >= w, y_est + 1, y_est)
    x_int = np.where(x_int >= w, x_int - w, x_int)
    t = torch.from_numpy(pid)
    np.testing.assert_array_equal((t % w).numpy(), x_int)
    np.testing.assert_array_equal(torch.div(t, w, rounding_mode="floor").numpy(),
                                  y_est)


def _rays(seed, n=4096):
    r = np.random.default_rng(seed)
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("kind", ["cube", "sphere"])
def test_primitive_intersection(kind):
    o, d = _rays(7)
    m, inv, invt = geom_matrices((0.3, -0.2, 0.1), (10.0, 25.0, -5.0), (2.0, 1.5, 1.0))
    if kind == "cube":
        jt, jp, jn, jo = jisect.box_intersect_v(m, inv, _jv(o), _jv(d))
        tt, tp, tn, to = intersect.box_intersect_v(m.tolist(), inv.tolist(), _tv(o), _tv(d))
    else:
        jt, jp, jn, jo = jisect.sphere_intersect_v(m, inv, invt, _jv(o), _jv(d))
        tt, tp, tn, to = intersect.sphere_intersect_v(m.tolist(), inv.tolist(),
                                                      invt.tolist(), _tv(o), _tv(d))
    jt = np.asarray(jt)
    hit = jt > 0
    assert 100 < hit.sum() < len(jt)
    np.testing.assert_array_equal(tt.numpy() > 0, hit)
    np.testing.assert_array_equal(to.numpy()[hit], np.asarray(jo)[hit])
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tp)[hit], _np(jp)[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tn)[hit], _np(jn)[hit], rtol=1e-5, atol=1e-5)


def test_triangle_and_aabb():
    o, d = _rays(8)
    r = np.random.default_rng(9)
    v = r.uniform(-2, 2, (16, 3, 3)).astype(np.float32)
    jv = [JVec3(*(jnp.asarray(v[None, :, c, k]) for k in range(3))) for c in range(3)]
    tv = [Vec3(*(torch.from_numpy(v[None, :, c, k].copy()) for k in range(3)))
          for c in range(3)]
    o2j = JVec3(*(jnp.asarray(o[:, k:k + 1]) for k in range(3)))
    d2j = JVec3(*(jnp.asarray(d[:, k:k + 1]) for k in range(3)))
    o2t = Vec3(*(torch.from_numpy(o[:, k:k + 1].copy()) for k in range(3)))
    d2t = Vec3(*(torch.from_numpy(d[:, k:k + 1].copy()) for k in range(3)))
    jt, ju, jw, jh = jisect._triangle_t(*jv, o2j, d2j)
    tt, tu, tw, th = intersect._triangle_t(*tv, o2t, d2t)
    jh = np.asarray(jh)
    assert jh.sum() > 50
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_allclose(tt.numpy()[jh], np.asarray(jt)[jh], rtol=1e-5, atol=1e-5)
    lb, ub = np.float32([-1, -1, -1]), np.float32([1, 0.5, 2])
    want = np.asarray(jisect.ray_aabb_intersect_v(_jv(o), _jv(d), lb, ub))
    got = intersect.ray_aabb_intersect_v(_tv(o), _tv(d), lb.tolist(), ub.tolist())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["fresnels", "schlick_off", "dielectric",
                                     "normal_view"])
def test_scatter_ray(variant):
    n = 4096
    r = np.random.default_rng(10)
    _, ray_d = _rays(11, n)
    normal = r.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    point = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    u1, u2 = r.uniform(0, 1, (2, n)).astype(np.float32)
    kind = r.integers(0, 4, n)
    mat_np = dict(
        color=r.uniform(0, 1, (n, 3)).astype(np.float32),
        specular_color=r.uniform(0, 1, (n, 3)).astype(np.float32),
        has_reflective=np.isin(kind, (1, 3)).astype(np.float32),
        has_refractive=np.isin(kind, (2, 3)).astype(np.float32),
        index_of_refraction=r.uniform(1.1, 1.8, n).astype(np.float32))
    kw = dict(fresnels=variant != "schlick_off", dielectric=variant == "dielectric",
              mesh_normal_view=variant == "normal_view")

    def mats(conv_v, conv_s):
        return {k: (conv_v(v) if v.ndim == 2 else conv_s(v)) for k, v in mat_np.items()}

    jd, jo, jc = jbsdf.scatter_ray_v(_jv(ray_d), _jv(point), _jv(normal),
                                     mats(_jv, jnp.asarray), jnp.asarray(u1),
                                     jnp.asarray(u2), **kw)
    td, to, tc = bsdf.scatter_ray_v(_tv(ray_d), _tv(point), _tv(normal),
                                    mats(_tv, torch.from_numpy),
                                    torch.from_numpy(u1), torch.from_numpy(u2), **kw)
    for got, want in ((td, jd), (to, jo), (tc, jc)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


def test_seeded_engine_alias_and_schrage_step_bitwise():
    """``seeded_engine`` is ``make_seeded_engine``; ``lcg_next_schrage``
    equals ``lcg_next`` and the JAX ``lcg_next_schrage`` over [1, M - 1],
    edges included (tests/test_rng.py:86-92 for the port)."""
    assert rng.seeded_engine is rng.make_seeded_engine
    m, q = 2 ** 31 - 1, (2 ** 31 - 1) // 48271
    edges = np.array([1, 2, 3, q - 1, q, q + 1, 2 * q, m // 2, m - 2, m - 1], np.int64)
    states = np.concatenate([edges, np.random.default_rng(12).integers(1, m, N)])
    want = np.asarray(jrng.lcg_next_schrage(jnp.asarray(states.astype(np.int32))))
    got = rng.lcg_next_schrage(torch.from_numpy(states))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert torch.equal(got, rng.lcg_next(torch.from_numpy(states)))


def _aos(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_aos_intersection_wrappers_match_jax():
    """box/sphere/triangle/ray-AABB wrappers on (N, 3) rows against the
    JAX ones, at the bars of the planes' tests above."""
    o, d = _rays(13)
    m, inv, invt = geom_matrices((0.3, -0.2, 0.1), (10.0, 25.0, -5.0), (2.0, 1.5, 1.0))
    pairs = [(jisect.box_intersect(m, inv, jnp.asarray(o), jnp.asarray(d)),
              intersect.box_intersect(m.tolist(), inv.tolist(), _aos(o), _aos(d))),
             (jisect.sphere_intersect(m, inv, invt, jnp.asarray(o), jnp.asarray(d)),
              intersect.sphere_intersect(m.tolist(), inv.tolist(), invt.tolist(),
                                         _aos(o), _aos(d)))]
    for want, got in pairs:
        hit = np.asarray(want[0]) > 0
        assert 100 < hit.sum() < len(hit)
        np.testing.assert_array_equal(got[0].numpy() > 0, hit)
        np.testing.assert_array_equal(got[3].numpy()[hit], np.asarray(want[3])[hit])
        for g, w in zip(got[:3], want[:3]):
            assert tuple(g.shape) == np.asarray(w).shape
            np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit], rtol=1e-5, atol=1e-5)

    r = np.random.default_rng(14)
    v = r.uniform(-2, 2, (16, 3, 3)).astype(np.float32)
    nv = r.normal(size=(16, 3, 3)).astype(np.float32)
    jt, jp, jn = jisect.triangle_intersect(jnp.asarray(v), jnp.asarray(nv),
                                           jnp.asarray(o), jnp.asarray(d))
    tt, tp, tn = intersect.triangle_intersect(_aos(v), _aos(nv), _aos(o), _aos(d))
    jt = np.asarray(jt)
    hit = jt != -1
    assert hit.sum() > 50 and tt.shape == jt.shape and tp.shape == np.asarray(jp).shape
    np.testing.assert_array_equal(tt.numpy() != -1, hit)
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.numpy()[hit], np.asarray(jp)[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tn.numpy()[hit], np.asarray(jn)[hit], rtol=1e-5, atol=1e-5)

    lb, ub = np.float32([-1, -1, -1]), np.float32([1, 0.5, 2])
    np.testing.assert_array_equal(
        intersect.ray_aabb_intersect(_aos(o), _aos(d), lb.tolist(), ub.tolist()).numpy(),
        np.asarray(jisect.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), lb, ub)))


def test_intersect_scene_wrapper_matches_jax(cornell_scene):
    """``intersect_scene`` on the Cornell box from rays inside it."""
    from ai_path_tracer_denoiser_tpu_torch.scene import load_scene
    scene = load_scene(str(REPO / "scenes" / "cornell_box.txt"), device="cpu")
    r = np.random.default_rng(15)
    o = r.uniform(-4, 4, (4096, 3)).astype(np.float32) + np.float32([0, 5, 0])
    d = r.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = jisect.intersect_scene(cornell_scene.geoms, cornell_scene.mesh,
                                  jnp.asarray(o), jnp.asarray(d))
    got = intersect.intersect_scene(scene.geoms, scene.mesh, _aos(o), _aos(d))
    hit = np.asarray(want["t"]) > 0
    assert hit.mean() > 0.8
    for key in ("material_id", "is_inside"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    # the render bar (ROADMAP C, "Render"): grazing sphere hits move the
    # last bits of a few rays, so isclose(1e-5, 1e-5) on >= 99.8% of rays
    for key in ("t", "point", "normal"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape
        close = np.isclose(g, w, rtol=1e-5, atol=1e-5).reshape(len(o), -1).all(axis=1)
        assert close.mean() >= 0.998, (key, close.mean())


def test_aos_bsdf_wrappers_match_jax():
    n = 4096
    r = np.random.default_rng(16)
    _, ray_d = _rays(17, n)
    normal = r.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    point = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    u1, u2 = r.uniform(0, 1, (2, n)).astype(np.float32)
    eta = r.uniform(0.5, 1.8, n).astype(np.float32)
    kind = r.integers(0, 4, n)
    mat = dict(color=r.uniform(0, 1, (n, 3)).astype(np.float32),
               specular_color=r.uniform(0, 1, (n, 3)).astype(np.float32),
               has_reflective=np.isin(kind, (1, 3)).astype(np.float32),
               has_refractive=np.isin(kind, (2, 3)).astype(np.float32),
               index_of_refraction=r.uniform(1.1, 1.8, n).astype(np.float32))
    J, T = jnp.asarray, _aos

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    close(bsdf.reflect(T(ray_d), T(normal)), jbsdf.reflect(J(ray_d), J(normal)))
    (td, tok), (jd, jok) = (bsdf.glm_refract(T(ray_d), T(normal), T(eta)),
                            jbsdf.glm_refract(J(ray_d), J(normal), J(eta)))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < np.asarray(jok).mean() < 1
    close(td, jd)
    np.testing.assert_array_equal(
        bsdf.refract_possible(T(ray_d), T(normal), T(eta)).numpy(),
        np.asarray(jbsdf.refract_possible(J(ray_d), J(normal), J(eta))))
    close(bsdf.cosine_hemisphere_direction(T(normal), T(u1), T(u2)),
          jbsdf.cosine_hemisphere_direction(J(normal), J(u1), J(u2)))
    got = bsdf.scatter_ray(T(ray_d), T(point), T(normal), {k: T(v) for k, v in mat.items()},
                           T(u1), T(u2))
    want = jbsdf.scatter_ray(J(ray_d), J(point), J(normal), {k: J(v) for k, v in mat.items()},
                             J(u1), J(u2))
    for g, w in zip(got, want):
        close(g, w)


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports jax or the JAX package."""
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|ai_path_tracer_denoiser_tpu\b(?!_torch))",
                     re.M)
    files = sorted((REPO / "ai_path_tracer_denoiser_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        assert not bad.search(text), f"{f} imports jax or the JAX package"
        assert "ai_path_tracer_denoiser_tpu." not in text.replace(
            "ai_path_tracer_denoiser_tpu_torch", ""), f
