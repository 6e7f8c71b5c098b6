"""The port's cluster hierarchy, sort key and per-ray traversal (K4's
function) against the JAX package, on the CPU.

The hierarchy build is host numpy code on both sides and must agree bit for
bit.  ``octant_cell_key`` produces integers and must agree exactly.  The
traversal is compared with the JAX Pallas kernel in interpret mode, as
tests/test_bvh.py runs it: on CPU tensors the port's wrapper runs the
kernel's plain version (the dense scan over the hierarchy's face table).

Tolerance of the traversal: hit mask and material equal, t and point
within rtol 3e-6, atol 1e-6, the JAX tests' own off-TPU bar
(tests/test_binned.py): XLA:CPU contracts multiply-adds and rounds rsqrt
differently from PyTorch, so values differ in the last bits.  Normals get
atol 5e-5: the soups carry random per-vertex normals, whose barycentric
mix can nearly cancel, and normalising a short vector grows the last-bit
difference of the barycentrics (measured up to 1.6e-5 here).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.ops import bvh as jbvh
from ai_path_tracer_denoiser_tpu.ops import intersect as jintersect
from ai_path_tracer_denoiser_tpu.ops.vec3 import Vec3 as JVec3
from ai_path_tracer_denoiser_tpu.render import mesh_kernel as jmesh_kernel
from ai_path_tracer_denoiser_tpu.render.mesh_kernel_v2p import (
    mesh_intersect_bvh_v2p as jax_v2p)
from ai_path_tracer_denoiser_tpu.scene import load_scene as jax_load_scene
from ai_path_tracer_denoiser_tpu.scene import structs as jstructs
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.ops import bvh as tbvh
from ai_path_tracer_denoiser_tpu_torch.ops import intersect as tintersect
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import mesh_kernel_v2p
from ai_path_tracer_denoiser_tpu_torch.scene import load_scene, structs

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 3e-6, 1e-6
NORMAL_ATOL = 5e-5


def soup(n_faces, seed=0, spread=3.0):
    """(vertices, normals, material ids) of a random triangle soup."""
    rng = np.random.default_rng(seed)
    base = (rng.uniform(-spread, spread, (n_faces, 1, 3))
            .repeat(3, axis=1).astype(np.float32))
    verts = base + rng.uniform(-0.4, 0.4, (n_faces, 3, 3)).astype(np.float32)
    normals = rng.normal(size=(n_faces, 3, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    mats = rng.integers(0, 5, n_faces).astype(np.int32)
    return verts, normals, mats


def rays(n, seed=1, spread=6.0):
    """(origins (3, n), unit directions (3, n)) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def cull_distances(n, seed, dead_every=5):
    rng = np.random.default_rng(seed)
    tc = rng.uniform(0.5, 20.0, n).astype(np.float32)
    tc[::dead_every] = -np.inf
    return tc


def tvec(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def jvec(a):
    return JVec3(*(jnp.asarray(c) for c in a))


def both_bvhs(n_faces, seed):
    """The JAX hierarchy of a soup and the port's, from the same arrays."""
    v, n, m = soup(n_faces, seed)
    jb, jorder = jbvh.build_mesh_bvh(v, n, m)
    tb, torder = tbvh.build_mesh_bvh(v, n, m)
    np.testing.assert_array_equal(jorder, torder)
    return jb, tb


def assert_same_bvh(tb, jb):
    assert (tb.num_faces, tb.cluster) == (jb.num_faces, jb.cluster)
    assert (tb.n_clusters_real, tb.n_supers_real, tb.n_hypers_real) == (
        jb.n_clusters_real, jb.n_supers_real, jb.n_hypers_real)
    np.testing.assert_array_equal(tb.faces_packed.numpy(),
                                  np.asarray(jb.faces_packed)[:, :19])
    for f in ("cluster_bounds", "super_bounds", "hyper_bounds"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def _assert_close(a, b, rtol, atol, outliers):
    """All of ``a`` within (rtol, atol) of ``b``; with ``outliers`` > 0 that
    share of the elements may miss the bar, and then stays within 1e-4."""
    if not outliers:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        return
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    assert bad.mean() <= outliers, bad.mean()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def assert_same_hits(got, want, rtol=RTOL, atol=ATOL, outliers=0.0):
    """(t, point, normal, material): torch results vs JAX results."""
    tt, tp, tn, tm = got
    jt, jp, jn, jm = want
    tt, jt = tt.numpy(), np.asarray(jt)
    hit = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    assert hit.sum() > 0
    np.testing.assert_array_equal(tm.numpy()[hit], np.asarray(jm)[hit])
    assert (tm.numpy()[~hit] == -1).all()
    _assert_close(tt[hit], jt[hit], rtol, atol, outliers)
    for a, b, tol in ((tp, jp, atol), (tn, jn, NORMAL_ATOL)):
        for ca, cb in zip(a, b):
            _assert_close(ca.numpy()[hit], np.asarray(cb)[hit], rtol, tol, outliers)


@pytest.mark.parametrize("name,faces,bins", [
    ("cornell_mesh_icosphere.txt", 320, 2), ("cornell_mesh_torus.txt", 800, 4),
    ("cornell_mesh_blob.txt", 5120, 20)])
def test_scene_hierarchy_equals_jax(name, faces, bins):
    path = str(REPO / "scenes" / name)
    js = jax_load_scene(path)
    ts = load_scene(path, device="cpu")
    assert ts.mesh.num_faces == js.mesh.num_faces == faces
    assert ts.mesh.bvh.n_supers_real == bins
    for f in ("vertices", "normals", "material_id", "valid", "aabb_lb", "aabb_ub"):
        np.testing.assert_array_equal(getattr(ts.mesh, f).numpy(),
                                      np.asarray(getattr(js.mesh, f)), err_msg=f)
    assert_same_bvh(ts.mesh.bvh, js.mesh.bvh)
    # the scan's face order is the hierarchy's
    np.testing.assert_array_equal(
        ts.mesh.bvh.faces_packed[:faces, :9].numpy(),
        ts.mesh.vertices[:faces].reshape(faces, 9).numpy())


@pytest.mark.parametrize("n_faces", [1, 33, 300, 2048])
def test_soup_hierarchy_equals_jax(n_faces):
    jb, tb = both_bvhs(n_faces, seed=n_faces)
    assert_same_bvh(tb, jb)
    back = tbvh.bvh_from_numpy(np.asarray(jb.faces_packed), np.asarray(jb.cluster_bounds),
                               np.asarray(jb.super_bounds), np.asarray(jb.hyper_bounds),
                               jb.num_faces, jb.cluster)
    assert_same_bvh(back, jb)


@pytest.mark.parametrize("n_faces,has_bvh", [(64, False), (65, False), (66, True)])
def test_hierarchy_threshold_matches_jax(n_faces, has_bvh):
    v, n, m = soup(n_faces, seed=3)
    jm = jstructs.make_mesh(v, n, m)
    tm = structs.make_mesh(v, n, m)
    assert (jm.bvh is not None) == (tm.bvh is not None) == has_bvh
    np.testing.assert_array_equal(tm.vertices.numpy(), np.asarray(jm.vertices))
    if has_bvh:
        assert_same_bvh(tm.bvh, jm.bvh)
    else:   # file order kept: no Morton reorder without a hierarchy
        np.testing.assert_array_equal(tm.vertices[:n_faces].numpy(), v)


def test_bvh_from_numpy_rejects_short_tables():
    jb, _ = both_bvhs(300, seed=1)
    with pytest.raises(ValueError, match="do not cover"):
        tbvh.bvh_from_numpy(np.asarray(jb.faces_packed)[:256], np.asarray(jb.cluster_bounds),
                            np.asarray(jb.super_bounds), np.asarray(jb.hyper_bounds),
                            jb.num_faces)


@pytest.mark.parametrize("sort_cells", [0, 8, -8, 100])
def test_octant_cell_key_equals_jax(sort_cells):
    n = 5000
    o, d = rays(n, seed=sort_cells + 20)
    rng = np.random.default_rng(7)
    dead = rng.uniform(size=n) < 0.3
    o[:, dead] = 0.0                 # the wavefront zeroes dead lanes' origins
    d[0, ::13] = 0.0
    jk = jintersect.octant_cell_key(jvec(o), jvec(d), jnp.asarray(dead), sort_cells)
    tk = tintersect.octant_cell_key(tvec(o), tvec(d), torch.from_numpy(dead), sort_cells)
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (tk.numpy()[dead] == 1 << 30).all() and len(np.unique(tk.numpy())) > 8


def _boundary_rays(bounds, n, seed):
    """Rays with zero direction components whose origins lie exactly on box
    faces: the slab test's 0 * inf cases."""
    o, d = rays(n, seed)
    d[0, ::3] = 0.0
    d[1, 1::4] = 0.0
    d[2, 2::5] = 0.0
    rows = np.asarray(bounds)
    pick = np.arange(n) % max(1, min(rows.shape[0], 4))
    o[0, ::3] = rows[pick[::3], 0]       # on the lower x face
    o[1, 1::4] = rows[pick[1::4], 4]     # on the upper y face
    o[2, 2::5] = rows[pick[2::5], 2]
    return o, d


def test_slab_live_nan_rule_equals_jax():
    jb, tb = both_bvhs(2048, seed=5)
    n = 3000
    o, d = _boundary_rays(jb.super_bounds, n, seed=4)
    tc = cull_distances(n, seed=6)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (1.0 / d).astype(np.float32)
        assert np.isnan((np.asarray(jb.super_bounds)[0, 0] - o[0]) * inv[0]).any()
    kb = jb.n_supers_real
    want = np.stack([np.asarray(jmesh_kernel._slab_live(
        jb.super_bounds[k:k + 1], jvec(o), jvec(inv), jnp.asarray(tc)))
        for k in range(kb)])
    got = mesh_kernel_v2p._slab_live(tb.super_bounds[:kb], tvec(o), tvec(inv),
                                     torch.from_numpy(tc))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("with_cull", [False, True])
def test_v2p_matches_jax_kernel(with_cull):
    jb, tb = both_bvhs(2048, seed=11)
    n = 4096
    o, d = rays(n, seed=2)
    tc = cull_distances(n, seed=4) if with_cull else None
    want = jax_v2p(jb, jvec(o), jvec(d), None if tc is None else jnp.asarray(tc),
                   interpret=True)
    launches = mesh_kernel_v2p.KERNEL.launches
    got = mesh_kernel_v2p.mesh_intersect_bvh_v2p(
        tb, tvec(o), tvec(d), None if tc is None else torch.from_numpy(tc))
    assert mesh_kernel_v2p.KERNEL.launches == launches   # CPU: the plain version
    assert_same_hits(got, want)
    if with_cull:
        assert not np.isfinite(got[0].numpy()[::5]).any()     # dead lanes
        assert (got[0].numpy() < tc)[np.isfinite(got[0].numpy())].all()
        for c in (*got[1], *got[2]):
            assert (c.numpy()[~np.isfinite(got[0].numpy())] == 0).all()


def test_traversal_work_counts():
    _, tb = both_bvhs(2048, seed=11)
    n = 512
    o, d = rays(n, seed=2)
    tc = torch.from_numpy(cull_distances(n, seed=4))
    n_bytes, face_tests, node_tests = mesh_kernel_v2p.traversal_work(
        tb, tvec(o), tvec(d), tc)
    hits = int(torch.isfinite(mesh_kernel_v2p.mesh_intersect_bvh_v2p(
        tb, tvec(o), tvec(d), tc)[0]).sum())
    assert n_bytes > 4 * 15 * n and node_tests >= n * tb.n_hypers_real
    assert hits * 1 <= face_tests <= n * 2048 and face_tests % 32 == 0


@pytest.mark.parametrize("impl", ["v2", "v3"])
def test_unported_traversals_raise(impl):
    """"v2" and "v3" raised while they were not ported; now they answer as
    "v2p" does, and only an unknown name raises."""
    scene = load_scene(str(REPO / "scenes" / "cornell_mesh_icosphere.txt"), device="cpu")
    o, d = rays(512, seed=1, spread=4.0)
    o[1] += 5.0                                   # into the box, around the mesh
    got = tintersect.intersect_scene_v(scene.geoms, scene.mesh, tvec(o), tvec(d),
                                       kernel_impl=impl)
    want = tintersect.intersect_scene_v(scene.geoms, scene.mesh, tvec(o), tvec(d),
                                        kernel_impl="v2p")
    assert (want["material_id"] >= 0).sum() > 100
    for k in ("t", "material_id", "is_inside"):
        assert torch.equal(got[k], want[k]), k
    for k in ("point", "normal"):
        for a, b in zip(got[k], want[k]):
            assert torch.equal(a, b), k
    with pytest.raises(ValueError):
        tintersect.intersect_scene_v(scene.geoms, scene.mesh, tvec(o), tvec(d),
                                     kernel_impl="v9")
    with pytest.raises(ValueError):
        RenderOptions(mesh_kernel_impl="v9")


@pytest.mark.parametrize("impl,sort_cells", [("v2p", 8), ("v2p", 0), ("binned", 8)])
def test_octant_round_trip_changes_nothing(impl, sort_cells):
    scene = load_scene(str(REPO / "scenes" / "cornell_mesh_torus.txt"), device="cpu")
    o, d = rays(3000, seed=9, spread=4.0)
    o[1] += 5.0                                   # into the box, around the mesh
    active = torch.from_numpy(np.arange(3000) % 4 != 0)
    kw = dict(kernel_impl=impl, active=active)
    plain = tintersect.intersect_scene_v(scene.geoms, scene.mesh, tvec(o), tvec(d), **kw)
    sorted_ = tintersect.intersect_scene_v(scene.geoms, scene.mesh, tvec(o), tvec(d),
                                          octant_sort=True, sort_cells=sort_cells, **kw)
    assert (plain["material_id"] >= 0).sum() > 100
    for k in ("t", "material_id", "is_inside"):
        assert torch.equal(plain[k], sorted_[k]), k
    for k in ("point", "normal"):
        for a, b in zip(plain[k], sorted_[k]):
            assert torch.equal(a, b), k


def test_resolve_mesh_impl_routes_by_bins():
    small = load_scene(str(REPO / "scenes" / "cornell_mesh_torus.txt"), device="cpu")
    assert tintersect.resolve_mesh_impl(small.mesh) == "v2p"
    assert tintersect.resolve_mesh_impl(small.mesh, "binned") == "binned"
    v, n, m = soup(64 * 256, seed=2)
    big = structs.make_mesh(v, n, m)
    assert big.bvh.n_supers_real == 64
    assert tintersect.resolve_mesh_impl(big) == "binned"
    v, n, m = soup(63 * 256, seed=2)
    assert tintersect.resolve_mesh_impl(structs.make_mesh(v, n, m)) == "v2p"
    tiny = structs.make_mesh(*soup(12, seed=1))
    assert tiny.bvh is None and tintersect.resolve_mesh_impl(tiny) == "v2p"
