"""The port's tile-gated ("v2", K7's function) and front-to-back ("v3", K8's
function) traversals against the JAX package, on the CPU.

The same numpy-seeded soups and rays go through the JAX Pallas kernels in
interpret mode, as tests/test_bvh.py runs them, and through the port's
wrappers, which on CPU tensors run the kernels' plain versions (the tile
walks of render/mesh_kernel.py and render/mesh_kernel_v3.py).

Tolerances.  Against JAX: hit mask and material equal, t and point within
rtol 3e-6, atol 1e-6, normals atol 5e-5 (ROADMAP queue C: XLA:CPU contracts
multiply-adds and rounds rsqrt differently from PyTorch, and a short
interpolated normal grows the last bit when it is normalised).  Inside the
port everything is bit for bit: both traversals against the dense scan, any
``lanes`` against any other, and 64x64 renders with "v2" / "v3" against the
"v2p" render.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.ops import bvh as jbvh
from ai_path_tracer_denoiser_tpu.ops.vec3 import Vec3 as JVec3
from ai_path_tracer_denoiser_tpu.render import mesh_kernel as jmesh_kernel
from ai_path_tracer_denoiser_tpu.render import mesh_kernel_v3 as jmesh_kernel_v3
from ai_path_tracer_denoiser_tpu.render.mesh_kernel import mesh_intersect_bvh as jax_v2
from ai_path_tracer_denoiser_tpu_torch.config import RenderOptions
from ai_path_tracer_denoiser_tpu_torch.ops import bvh as tbvh
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import (mesh_kernel, mesh_kernel_v2p,
                                                      mesh_kernel_v3, render)
from ai_path_tracer_denoiser_tpu_torch.scene import derive_camera, load_scene

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL, NORMAL_ATOL = 3e-6, 1e-6, 5e-5


def soup(f, seed=0):
    """tests/test_bvh.py's soup: (vertices, normals, material ids)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (f, 1, 3))
    verts = (centers + rng.uniform(-0.3, 0.3, (f, 3, 3))).astype(np.float32)
    norms = rng.normal(size=(f, 3, 3)).astype(np.float32)
    norms /= np.linalg.norm(norms, axis=-1, keepdims=True)
    return verts, norms, rng.integers(0, 5, f).astype(np.int32)


def rays(n=1536, seed=1):
    """(origins (3, n), unit directions (3, n)) float32."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def cull_distances(n, seed):
    """Cull distances with dead lanes (-inf) and unbounded ones (+inf)."""
    tc = np.random.default_rng(seed).uniform(0.5, 6.0, n).astype(np.float32)
    tc[1::7] = np.inf
    tc[::5] = -np.inf
    return tc


def tvec(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def jvec(a):
    return JVec3(*(jnp.asarray(c) for c in a))


def flat(result):
    t, p, n, mat = result
    return (t, *p, *n, mat)


def assert_bitwise(got, want):
    for i, (a, b) in enumerate(zip(flat(got), flat(want))):
        assert torch.equal(a, b), f"plane {i} differs"


def assert_same_hits(got, want):
    """(t, point, normal, material): the port's result vs the JAX kernel's."""
    tt, tp, tn, tm = got
    jt, jp, jn, jm = want
    tt, jt = tt.numpy(), np.asarray(jt)
    hit = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    assert hit.sum() > 0
    np.testing.assert_array_equal(tm.numpy()[hit], np.asarray(jm)[hit])
    assert (tm.numpy()[~hit] == -1).all()
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=RTOL, atol=ATOL)
    for a, b, tol in ((tp, jp, ATOL), (tn, jn, NORMAL_ATOL)):
        for ca, cb in zip(a, b):
            np.testing.assert_allclose(ca.numpy()[hit], np.asarray(cb)[hit],
                                       rtol=RTOL, atol=tol)


def port_fn(impl):
    if impl == "v2":
        return mesh_kernel.mesh_intersect_bvh
    return mesh_kernel_v3.mesh_intersect_bvh_v3


def jax_fn(impl):
    if impl == "v2":
        return jax_v2
    return jmesh_kernel_v3.mesh_intersect_bvh_v3


@pytest.mark.parametrize("n_faces", [65, 300, 500])
@pytest.mark.parametrize("with_cull", [False, True], ids=["all", "culled"])
@pytest.mark.parametrize("impl", ["v2", "v3"])
def test_traversal_matches_jax_kernel(impl, with_cull, n_faces):
    v, nrm, m = soup(n_faces, seed=n_faces)
    jb, jorder = jbvh.build_mesh_bvh(v, nrm, m)
    tb, torder = tbvh.build_mesh_bvh(v, nrm, m)
    np.testing.assert_array_equal(jorder, torder)
    n = 1536
    o, d = rays(n, seed=2)
    tc = cull_distances(n, seed=4) if with_cull else None
    want = jax_fn(impl)(jb, jvec(o), jvec(d), None if tc is None else jnp.asarray(tc),
                        interpret=True)
    kernel = (mesh_kernel if impl == "v2" else mesh_kernel_v3).KERNEL
    launches = kernel.launches
    got = port_fn(impl)(tb, tvec(o), tvec(d), None if tc is None else torch.from_numpy(tc))
    assert kernel.launches == launches             # CPU tensors: the plain version
    assert_same_hits(got, want)
    if with_cull:
        t = got[0].numpy()
        assert not np.isfinite(t[::5]).any()       # dead lanes
        assert (t < tc)[np.isfinite(t)].all()      # strictly below the cull distance
        for c in (*got[1], *got[2]):
            assert (c.numpy()[~np.isfinite(t)] == 0).all()


@pytest.mark.parametrize("n_faces,n_rays", [(65, 700), (777, 1536), (2100, 1573)])
@pytest.mark.parametrize("impl", ["v2", "v3"])
def test_traversal_equals_dense_scan_bitwise(impl, n_faces, n_rays):
    tb, _ = tbvh.build_mesh_bvh(*soup(n_faces, seed=7))
    o, d = rays(n_rays, seed=3)
    for tc in (None, torch.from_numpy(cull_distances(n_rays, seed=9))):
        want = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(tb, tvec(o), tvec(d), tc)
        assert torch.isfinite(want[0]).sum() > 0
        assert_bitwise(port_fn(impl)(tb, tvec(o), tvec(d), tc), want)


@pytest.mark.parametrize("lanes", [128, 384])
def test_v2_lanes_are_pure_work_partitioning(lanes):
    """tests/test_bvh.py::test_kernel_lanes_bitwise_invariant for the port."""
    tb, _ = tbvh.build_mesh_bvh(*soup(777))
    o, d = rays()
    tc = torch.from_numpy(cull_distances(o.shape[1], seed=1))
    wide = mesh_kernel.mesh_intersect_bvh(tb, tvec(o), tvec(d), tc)
    assert_bitwise(mesh_kernel.mesh_intersect_bvh(tb, tvec(o), tvec(d), tc, lanes=lanes), wide)


@pytest.mark.parametrize("impl", ["v2", "v3"])
def test_wrappers_refuse_a_mesh_over_the_face_cap_as_jax_does(impl):
    """K7's and K8's wrappers refuse a hierarchy stand-in of
    MAX_KERNEL_FACES + 1 faces before any device work, on the CPU too, as
    the JAX wrappers do; at the cap they take it."""
    assert mesh_kernel.MAX_KERNEL_FACES == jmesh_kernel.MAX_KERNEL_FACES == 1_000_000
    v, nrm, m = soup(65)
    jb, _ = jbvh.build_mesh_bvh(v, nrm, m)
    tb, _ = tbvh.build_mesh_bvh(v, nrm, m)
    o, d = rays(128)
    over = mesh_kernel.MAX_KERNEL_FACES + 1
    with pytest.raises(ValueError, match="MAX_KERNEL_FACES"):
        jax_fn(impl)(dataclasses.replace(jb, num_faces=over), jvec(o), jvec(d),
                     interpret=True)
    with pytest.raises(ValueError, match="MAX_KERNEL_FACES"):
        port_fn(impl)(dataclasses.replace(tb, num_faces=over), tvec(o), tvec(d))
    from ai_path_tracer_denoiser_tpu_torch.render.mesh_kernel_v2p import _check_bvh
    _check_bvh(dataclasses.replace(tb, num_faces=mesh_kernel.MAX_KERNEL_FACES))


@pytest.mark.parametrize("impl", ["v2p", "v2", "v3", "binned"])
def test_wrappers_refuse_a_hierarchy_of_another_cluster(impl):
    """A hierarchy of another cluster (the JAX package's, built under
    APTD_BVH_CLUSTER and carried across) is refused by every hierarchy
    kernel's wrapper, on the CPU too: the kernels are compiled for 32 faces
    per cluster.  The JAX tile kernel refuses a mismatch the same way."""
    from ai_path_tracer_denoiser_tpu_torch.render import mesh_binned
    tb, _ = tbvh.build_mesh_bvh(*soup(65))
    jb, _ = jbvh.build_mesh_bvh(*soup(65))
    o, d = rays(128)
    fn = {"v2p": mesh_kernel_v2p.mesh_intersect_bvh_v2p, "binned":
          mesh_binned.mesh_intersect_binned}.get(impl) or port_fn(impl)
    assert tbvh.CLUSTER == tb.cluster == 32
    with pytest.raises(ValueError, match="cluster=16"):
        fn(dataclasses.replace(tb, cluster=16), tvec(o), tvec(d))
    with pytest.raises(ValueError, match="cluster=16"):
        jax_v2(dataclasses.replace(jb, cluster=16), jvec(o), jvec(d), interpret=True)


@pytest.mark.parametrize("lanes", [0, 100, 2048])
def test_v2_rejects_lanes_that_are_no_block_size(lanes):
    tb, _ = tbvh.build_mesh_bvh(*soup(100))
    o, d = rays(64)
    with pytest.raises(ValueError, match="multiple of 128"):
        mesh_kernel.mesh_intersect_bvh(tb, tvec(o), tvec(d), lanes=lanes)
    # the options take any value, as the JAX package's do: only "v2" checks it
    assert RenderOptions(mesh_kernel_lanes=lanes).mesh_kernel_lanes == lanes


def coincident_soup():
    """128 faces in file order, four clusters.  Cluster 2 repeats faces 0..30
    of cluster 0 with other materials, so every hit of one ties exactly with
    the other's; its last face is a sliver across the whole scene, which
    makes its box contain every ray origin: a front-to-back walk enters it at
    distance 0 and visits it BEFORE cluster 0, and only the cluster-index
    tie-break then keeps the dense scan's winner."""
    rng = np.random.default_rng(11)

    def blob(center):
        c = center + rng.uniform(-0.3, 0.3, (32, 1, 3))
        return (c + rng.uniform(-0.15, 0.15, (32, 3, 3))).astype(np.float32)

    a, b, c = blob(np.zeros(3)), blob(np.array([0.3, 0.0, 0.0])), blob(np.array([0.0, 0.4, 0.0]))
    copy = a.copy()
    copy[31] = np.array([[-5, -5, -5], [5, 5, 5], [5, 5, 5.001]], np.float32)
    v = np.concatenate([a, b, copy, c])
    nrm = rng.normal(size=(128, 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[64:95] = nrm[0:31]
    m = rng.integers(0, 5, 128).astype(np.int32)
    m[64:95] = (m[0:31] + 1) % 5
    return v, nrm, m


def aimed_rays(v, n, seed):
    """Rays from a sphere of radius 3.5 around the soup towards points of
    its faces 0..30."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n))
    o = (3.5 * o / np.linalg.norm(o, axis=0, keepdims=True)).astype(np.float32)
    bary = rng.dirichlet(np.ones(3), n).astype(np.float32)
    target = np.einsum("nc,ncx->nx", bary, v[rng.integers(0, 31, n)])
    d = target.T - o
    return o, (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("impl", ["v2", "v3"])
def test_coincident_clusters_keep_the_first_face(impl):
    v, nrm, m = coincident_soup()
    jb, _ = jbvh.build_mesh_bvh(v, nrm, m, reorder=False)
    tb, _ = tbvh.build_mesh_bvh(v, nrm, m, reorder=False)
    rest, _ = tbvh.build_mesh_bvh(v[32:], nrm[32:], m[32:], reorder=False)
    n = 2048
    o, d = aimed_rays(v, n, seed=5)
    tc = cull_distances(n, seed=6)
    tc[tc > 0] = np.inf
    ttc = torch.from_numpy(tc)
    want = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(tb, tvec(o), tvec(d), ttc)
    # without cluster 0 its copy answers: the same t, another material
    other = mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(rest, tvec(o), tvec(d), ttc)
    tied = torch.isfinite(want[0]) & (other[0] == want[0]) & (other[3] != want[3])
    assert tied.sum() > 200
    got = port_fn(impl)(tb, tvec(o), tvec(d), ttc)
    assert_bitwise(got, want)
    # The JAX kernel picks the same faces.  Aimed rays meet many faces of the
    # soup edge-on (a large 1/a in the triangle test), where the two
    # packages' last bits grow, and at a shared edge they may pick the
    # neighbouring face: t is held to rtol 1e-4 on 99.5% of the hits here, the
    # masks and materials exactly.
    jt, _, _, jm = jax_fn(impl)(jb, jvec(o), jvec(d), jnp.asarray(tc), interpret=True)
    hit = np.isfinite(np.asarray(jt))
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()), hit)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(jm))
    close = np.isclose(got[0].numpy()[hit], np.asarray(jt)[hit], rtol=1e-4, atol=0)
    assert close.mean() >= 0.995, close.mean()


def test_v3_tie_against_the_cull_seed_loses():
    """A hit exactly AT ``t_cull`` is no hit: the scene merge takes the mesh
    only on strictly smaller t."""
    tb, _ = tbvh.build_mesh_bvh(*soup(300, seed=2))
    o, d = rays(1024, seed=8)
    free = mesh_kernel_v3.mesh_intersect_bvh_v3(tb, tvec(o), tvec(d))
    hit = torch.isfinite(free[0])
    assert hit.sum() > 10
    seeded = mesh_kernel_v3.mesh_intersect_bvh_v3(tb, tvec(o), tvec(d), free[0].clone())
    assert not torch.isfinite(seeded[0]).any() and (seeded[3] == -1).all()
    eased = mesh_kernel_v3.mesh_intersect_bvh_v3(
        tb, tvec(o), tvec(d), torch.nextafter(free[0], torch.full_like(free[0], float("inf"))))
    assert_bitwise(eased, free)


def test_sorting_network_sorts_and_keeps_indices():
    rng = np.random.default_rng(3)
    assert jmesh_kernel_v3._NET8 == mesh_kernel_v3._NET8
    for _ in range(200):
        vals = rng.choice([0.0, 0.5, 1.0, 2.0, float("inf")], size=8).tolist()
        out, idx = mesh_kernel_v3.sort8(vals)
        assert out == sorted(vals) and sorted(idx) == list(range(8))
        assert [vals[i] for i in idx] == out


def test_root_box_ignores_dead_padding_rows():
    tb, _ = tbvh.build_mesh_bvh(*soup(300, seed=2))
    root = mesh_kernel_v3.root_box(tb).numpy()
    assert tb.hyper_bounds.shape[0] > tb.n_hypers_real      # padded with dead rows
    assert np.abs(root).max() < 10 and (root[:3] < root[3:6]).all()
    faces = tb.faces_packed[:300, :9].reshape(-1, 3).numpy()
    assert (faces.min(0) >= root[:3]).all() and (faces.max(0) <= root[3:6]).all()


def _scene(name, res=64, depth=4):
    s = load_scene(str(REPO / "scenes" / name), device="cpu")
    c = s.camera
    return dataclasses.replace(s, trace_depth=depth, camera=derive_camera(
        (res, res), 45.0, c.position.numpy(), c.look_at.numpy(), c.up.numpy()))


@pytest.fixture(scope="module")
def icosphere_v2p_render():
    scene = _scene("cornell_mesh_icosphere.txt")
    return scene, render(scene, RenderOptions(mesh_kernel_impl="v2p"), num_iterations=2)[1]


@pytest.mark.parametrize("kwargs", [
    dict(mesh_kernel_impl="v2"),
    dict(mesh_kernel_impl="v2", mesh_kernel_lanes=128),
    dict(mesh_kernel_impl="v2", mesh_octant_sort=False),
    dict(mesh_kernel_impl="v3"),
    dict(mesh_kernel_impl="v3", mesh_octant_sort=False, mesh_sort_cells=0),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_renders_equal_the_v2p_render_bitwise(icosphere_v2p_render, kwargs):
    scene, want = icosphere_v2p_render
    got = render(scene, RenderOptions(**kwargs), num_iterations=2)[1]
    assert (want[6] > 0).float().mean() > 0.5
    assert torch.equal(got, want)
