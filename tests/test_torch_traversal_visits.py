"""The clusters the tile traversals visit, on the CPU: the plain versions of
K7 (render/mesh_kernel.py, tile-gated index-order descent) and K8
(render/mesh_kernel_v3.py, front to back by 128-ray subtiles), whose
counts the kernels are held to on the card, and the rules the kernels'
ray-by-ray face tests rest on.

A visit is a (tile, cluster) pair the walk ran face tests for.  K7 visits
cluster c with a tile iff one of its rays is live in c at c's turn, and a
ray's running t does not depend on the tiling, so a 1024-ray tile visits
the union of what its eight 128-ray subtiles visit, and the count can be
computed from each ray's running t alone.  Everything here is bit for bit:
outputs with and without a visit counter, and against the dense scan.
Small random soups (300-2,100 faces), as tests/test_torch_mesh_kernels.py
uses.
"""
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.ops.bvh import CLUSTER, build_mesh_bvh
from ai_path_tracer_denoiser_tpu_torch.ops.intersect import _triangle_t
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import mesh_kernel, mesh_kernel_v2p, mesh_kernel_v3
from ai_path_tracer_denoiser_tpu_torch.render.mesh_kernel_v2p import _slab_live
from ai_path_tracer_denoiser_tpu_torch.tools import traversal_sweep

torch.set_num_threads(2)


def soup(n_faces, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (n_faces, 1, 3))
    verts = (centers + rng.uniform(-0.3, 0.3, (n_faces, 3, 3))).astype(np.float32)
    normals = rng.normal(size=(n_faces, 3, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return build_mesh_bvh(verts, normals, rng.integers(0, 5, n_faces).astype(np.int32))[0]


def rays(n, seed):
    """Rays from a shell around the soup aimed into it, with dead lanes
    (t_cull = -inf), finite cull distances and a zero direction component."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n))
    o = 5.0 * o / np.linalg.norm(o, axis=0, keepdims=True)
    d = rng.uniform(-1.5, 1.5, (3, n)) - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[0, ::19] = 0.0
    tc = rng.uniform(3.0, 9.0, n).astype(np.float32)
    tc[1::3] = np.inf
    tc[::11] = -np.inf
    vec = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(c, np.float32)) for c in a))
    return vec(o), vec(d), torch.from_numpy(tc)


def flat(result):
    t, p, n, mat = result
    return (t, *p, *n, mat)


def assert_bitwise(got, want):
    for i, (a, b) in enumerate(zip(flat(got), flat(want))):
        assert torch.equal(a, b), f"plane {i} differs"


CASES = [(300, 2048, 1), (2100, 1500, 2)]   # faces, rays (a ragged last tile), seed


@pytest.mark.parametrize("n_faces,n_rays,seed", CASES)
def test_k7_tile_visits_the_union_of_its_subtiles(n_faces, n_rays, seed):
    bvh = soup(n_faces, seed)
    o, d, tc = rays(n_rays, seed + 10)
    wide = mesh_kernel.visited_clusters(bvh, o, d, tc, 1024)
    narrow = mesh_kernel.visited_clusters(bvh, o, d, tc, 128)
    assert len(wide) == -(-n_rays // 1024) and len(narrow) == -(-n_rays // 128)
    for i, tile in enumerate(wide):
        assert tile == sorted(tile)                       # index order
        assert set(tile) == set().union(*narrow[8 * i:8 * i + 8])
    assert sum(map(len, wide)) < sum(map(len, narrow))


def per_ray_visits(bvh, o, d, tc, lanes):
    """K7's visits from each ray's running t alone: before cluster c a ray
    holds the least of its cull distance and its hits in clusters below c
    (a hit below the running t needs the ray live in the hit's cluster),
    and a tile visits c iff one of its rays is live in c at that t."""
    f = bvh.num_faces
    rows = bvh.faces_packed[:f]

    def corner(c):
        return Vec3(*(rows[:, 3 * c + a, None] for a in range(3)))

    t, _, _, hit = _triangle_t(corner(0), corner(1), corner(2), Vec3(*(c[None] for c in o)),
                               Vec3(*(c[None] for c in d)))
    t = torch.where(hit & (t > 0.0), t, float("inf"))                   # (F, N)
    k = bvh.n_clusters_real
    pad = torch.full((k * CLUSTER - f, t.shape[1]), float("inf"))
    per_cluster = torch.cat([t, pad]).reshape(k, CLUSTER, -1).amin(1)   # (K, N)
    before = torch.cat([tc[None], per_cluster[:-1]]).cummin(0).values   # t at c's turn
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    live = _slab_live(bvh.cluster_bounds[:k], o, inv, before)           # (K, N)
    n = tc.shape[0]
    tail = live.new_zeros((k, -n % lanes))
    return int(torch.cat([live, tail], 1).reshape(k, -1, lanes).any(2).sum())


@pytest.mark.parametrize("lanes", [128, 1024])
@pytest.mark.parametrize("n_faces,n_rays,seed", CASES)
def test_k7_visits_follow_each_rays_running_t(n_faces, n_rays, seed, lanes):
    bvh = soup(n_faces, seed)
    o, d, tc = rays(n_rays, seed + 10)
    counter = torch.zeros(1, dtype=torch.int32)
    mesh_kernel.mesh_intersect_bvh_plain(bvh, o, d, tc, lanes, visit_counter=counter)
    assert int(counter) == per_ray_visits(bvh, o, d, tc, lanes) > 0
    assert int(counter) == sum(map(len, mesh_kernel.visited_clusters(bvh, o, d, tc, lanes)))


PLAINS = {
    "v2@128": lambda bvh, o, d, tc, **kw: mesh_kernel.mesh_intersect_bvh_plain(
        bvh, o, d, tc, 128, **kw),
    "v2@1024": lambda bvh, o, d, tc, **kw: mesh_kernel.mesh_intersect_bvh_plain(
        bvh, o, d, tc, 1024, **kw),
    "v3": lambda bvh, o, d, tc, **kw: mesh_kernel_v3.mesh_intersect_bvh_v3_plain(
        bvh, o, d, tc, **kw),
}


@pytest.mark.parametrize("impl", list(PLAINS))
@pytest.mark.parametrize("n_faces,n_rays,seed", CASES)
def test_counting_visits_changes_no_bit(n_faces, n_rays, seed, impl):
    bvh = soup(n_faces, seed)
    o, d, tc = rays(n_rays, seed + 10)
    counter = torch.full((1,), -5, dtype=torch.int32)
    counted = PLAINS[impl](bvh, o, d, tc, visit_counter=counter)
    assert_bitwise(counted, PLAINS[impl](bvh, o, d, tc))
    assert_bitwise(counted, mesh_kernel_v2p.mesh_intersect_bvh_v2p_plain(bvh, o, d, tc))
    assert int(counter) > 0 and int(torch.isfinite(counted[0]).sum()) > n_rays // 10


def test_wrappers_report_the_plain_visits_on_cpu():
    bvh = soup(700, 3)
    o, d, tc = rays(1100, 4)
    launches = (mesh_kernel.KERNEL.launches, mesh_kernel_v3.KERNEL.launches)
    for wrapper, plain in (
            (lambda **kw: mesh_kernel.mesh_intersect_bvh(bvh, o, d, tc, 256, **kw),
             lambda **kw: mesh_kernel.mesh_intersect_bvh_plain(bvh, o, d, tc, 256, **kw)),
            (lambda **kw: mesh_kernel_v3.mesh_intersect_bvh_v3(bvh, o, d, tc, **kw),
             lambda **kw: mesh_kernel_v3.mesh_intersect_bvh_v3_plain(bvh, o, d, tc, **kw))):
        got, want = (torch.zeros(1, dtype=torch.int32) for _ in range(2))
        assert_bitwise(wrapper(visit_counter=got), plain(visit_counter=want))
        assert int(got) == int(want) > 0
        for bad in (torch.zeros(1, dtype=torch.int64), torch.zeros(2, dtype=torch.int32)):
            with pytest.raises(ValueError, match="visit_counter"):
                wrapper(visit_counter=bad)
    assert (mesh_kernel.KERNEL.launches, mesh_kernel_v3.KERNEL.launches) == launches


def test_cached_root_box_follows_the_hyper_table():
    bvh = soup(2100, 5)
    root = mesh_kernel_v3.cached_root_box(bvh)
    assert torch.equal(root, mesh_kernel_v3.root_box(bvh))
    assert mesh_kernel_v3.cached_root_box(bvh) is root
    bvh.hyper_bounds[0, 0] -= 1.0                      # in place: the version moves
    again = mesh_kernel_v3.cached_root_box(bvh)
    assert again is not root and torch.equal(again, mesh_kernel_v3.root_box(bvh))
    assert float(again[0]) < float(root[0])


def pooled_winner(t, limit):
    """The kernels' ray-by-ray step for one ray (csrc/mesh_tile.cuh:
    pooled_tests): lane f holds face f's t (> 0, or +inf on a miss); the key
    is t's bits where t < limit, else all ones; the least key wins, of equal
    keys the lowest lane.  Returns (t, face), face -1 where no key is set."""
    keys = np.where(t < limit, t.view(np.uint32), np.uint32(0xFFFFFFFF))
    least = keys.min()
    if least == 0xFFFFFFFF:
        return np.float32(np.inf), -1
    return np.uint32(least).view(np.float32), int(np.flatnonzero(keys == least)[0])


def sequential_scan(t, limit):
    """The plain walks' scan of a cluster: faces in ascending order, a
    strict `<`."""
    best, face = limit, -1
    for f, tf in enumerate(t):
        if tf < best:
            best, face = tf, f
    return best, face


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pooled_winner_is_the_sequential_scan(seed):
    rng = np.random.default_rng(seed)
    for trial in range(400):
        n = int(rng.integers(1, 33))                  # a cluster's real faces
        # a few values repeated (ties in t), misses, a subnormal, and fresh values
        t = rng.choice(np.array([0.5, 0.75, 1.0, 2.0, 1e-40, np.inf], np.float32), n)
        fresh = rng.random(n) < 0.3
        t[fresh] = rng.uniform(0.1, 3.0, int(fresh.sum())).astype(np.float32)
        limit = np.float32(rng.choice([np.inf, 1.0, 0.75, 2.0]))
        # K7: the ray's running t is the limit, ties go to the earlier face
        got_t, got_f = pooled_winner(t, limit)
        want_t, want_f = sequential_scan(t, limit)
        assert got_f == want_f and (got_f < 0 or got_t == want_t), (t, limit)
        # K8: every hit counts (limit +inf), the cluster's first minimal hit
        got_t, got_f = pooled_winner(t, np.float32(np.inf))
        first = int(np.argmin(t)) if np.isfinite(t).any() else -1
        assert got_f == first and (first < 0 or got_t == t[first])
    # positive floats, subnormals and +inf order as their bits
    vals = np.array([1e-45, 1e-40, 1.17e-38, 1e-3, 1.0, 3e38, np.inf], np.float32)
    assert (np.diff(vals.view(np.uint32).astype(np.int64)) > 0).all()


def test_sweep_variants_edit_the_sources():
    builds = traversal_sweep.variant_builds()
    names = {b.name for _, b in builds}
    assert set(traversal_sweep.VARIANTS) <= names
    for served, build in builds:
        assert set(served) <= set(traversal_sweep.TRAVERSALS)
        assert "-fmad=false" in build.flags
