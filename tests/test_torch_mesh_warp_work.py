"""The work count of a thread-per-ray warp (``traversal_warp_work``) on the
CPU: the face and node tests that a warp of 32 consecutive rays issues
when every node or cluster that one of its rays is live in costs all of
its lanes.

It is held against a brute-force Python loop over the groups of rays and
the nodes of each level, against ``traversal_work`` at ``group=1`` (the
per-ray sum, K4's bound), and shown never to fall below that sum.
Integer counts: all comparisons are exact.
"""
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu_torch.ops import bvh as tbvh
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import mesh_kernel_v2p

torch.set_num_threads(2)


def hierarchy(n_faces, seed):
    """A soup of ``n_faces`` small faces spread over a cube, its hierarchy."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-3.0, 3.0, (n_faces, 1, 3)).repeat(3, axis=1)
    verts = (base + rng.uniform(-0.3, 0.3, (n_faces, 3, 3))).astype(np.float32)
    normals = np.tile(np.float32([0.0, 0.0, 1.0]), (n_faces, 3, 1))
    return tbvh.build_mesh_bvh(verts, normals, np.zeros(n_faces, np.int32))[0]


def ray_batch(n, seed, sort=False):
    """Rays from a box around the soup, every fifth dead (t_cull = -inf),
    some with finite cull distances; ``sort`` orders them by direction
    octant and origin, so that neighbours share nodes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6.0, 6.0, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tc = np.full(n, np.inf, np.float32)
    tc[1::3] = rng.uniform(1.0, 12.0, n)[1::3]
    tc[::5] = -np.inf
    if sort:
        key = ((d > 0) * np.array([[4], [2], [1]])).sum(0) * 1000 + np.round(o[0] + 6.0)
        order = np.argsort(key, kind="stable")
        o, d, tc = o[:, order], d[:, order], tc[order]
    return (Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in o)),
            Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in d)),
            torch.from_numpy(tc))


def brute_force(bvh, o, d, tc, group):
    """The warp count by loops: for each group of rays and each node of a
    level, all ``group`` lanes pay when one ray of the group is live."""
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    n = tc.shape[0]
    starts = range(0, n, group)
    live = {}
    for level, table, real in (("h", bvh.hyper_bounds, bvh.n_hypers_real),
                               ("s", bvh.super_bounds, bvh.n_supers_real),
                               ("c", bvh.cluster_bounds, bvh.n_clusters_real)):
        count = 0
        for lo in starts:
            sl = slice(lo, min(lo + group, n))
            oo = Vec3(o.x[sl], o.y[sl], o.z[sl])
            ii = Vec3(inv.x[sl], inv.y[sl], inv.z[sl])
            for k in range(real):
                if bool(mesh_kernel_v2p._slab_live(table[k:k + 1], oo, ii, tc[sl]).any()):
                    count += 1
        live[level] = count
    node_tests = group * (len(starts) * bvh.n_hypers_real
                          + tbvh.FANOUT * (live["h"] + live["s"]))
    return group * tbvh.CLUSTER * live["c"], node_tests


@pytest.mark.parametrize("n_faces,n_rays,group,sort", [
    (2500, 320, 32, False), (2500, 320, 32, True), (700, 203, 32, False),
    (5000, 160, 8, True)])
def test_warp_work_equals_brute_force_loop(n_faces, n_rays, group, sort):
    bvh = hierarchy(n_faces, seed=n_faces)
    o, d, tc = ray_batch(n_rays, seed=n_rays, sort=sort)
    n_bytes, face_tests, node_tests = mesh_kernel_v2p.traversal_warp_work(
        bvh, o, d, tc, group=group)
    assert (face_tests, node_tests) == brute_force(bvh, o, d, tc, group)
    per_warp = mesh_kernel_v2p.warp_live_clusters(bvh, o, d, tc, group=group)
    assert per_warp.shape == (-(-n_rays // group),)
    assert int(per_warp.sum()) * group * tbvh.CLUSTER == face_tests
    assert n_bytes == mesh_kernel_v2p.traversal_work(bvh, o, d, tc)[0]
    assert face_tests > 0


@pytest.mark.parametrize("sort", [False, True])
def test_warp_work_of_one_lane_groups_is_traversal_work(sort):
    bvh = hierarchy(5000, seed=3)
    o, d, tc = ray_batch(400, seed=5, sort=sort)
    assert (mesh_kernel_v2p.traversal_warp_work(bvh, o, d, tc, group=1)
            == mesh_kernel_v2p.traversal_work(bvh, o, d, tc))


def test_warp_work_never_falls_below_the_per_ray_sum():
    bvh = hierarchy(5000, seed=4)
    for sort in (False, True):
        o, d, tc = ray_batch(640, seed=6, sort=sort)
        _, face_sum, node_sum = mesh_kernel_v2p.traversal_work(bvh, o, d, tc)
        previous = (face_sum, node_sum)
        for group in (2, 8, 32):
            _, faces, nodes = mesh_kernel_v2p.traversal_warp_work(bvh, o, d, tc, group)
            assert faces >= face_sum and nodes >= node_sum
            # a group pays at least what the smaller groups inside it pay
            assert faces >= previous[0] and nodes >= previous[1]
            previous = (faces, nodes)
