"""The packed face table of the per-ray traversal kernel K4 on the CPU.

K4 reads each face as v0, e1 = v1 - v0 and e2 = v2 - v0 in 12 floats
(``mesh_kernel_v2p.pack_faces_v0e1e2``), built once per hierarchy
(``packed_faces``).  The edges must be the very float32 subtractions the
triangle test made on the 19-column rows, so that K4 stays bit for bit
equal to the dense scan: the Moller-Trumbore test on packed rows is held to
``ops/intersect.py:_triangle_t`` on the rows bit for bit (t, u, w and the
hit mask), on the faces of scenes/cornell_mesh_blob.txt and random rays.

Against the JAX package's ``_triangle_t`` the bar is the mesh path's
(ROADMAP C): hit masks equal, t, u and w within rtol 3e-6, atol 1e-6 where
both hit.  XLA:CPU contracts multiply-adds, so values differ in the last
bits.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.ops import intersect as jintersect
from ai_path_tracer_denoiser_tpu.ops.vec3 import Vec3 as JVec3
from ai_path_tracer_denoiser_tpu_torch.ops import intersect as tintersect
from ai_path_tracer_denoiser_tpu_torch.ops.vec3 import Vec3
from ai_path_tracer_denoiser_tpu_torch.render import mesh_kernel_v2p
from ai_path_tracer_denoiser_tpu_torch.scene import load_scene

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 3e-6, 1e-6


@pytest.fixture(scope="module")
def blob_bvh():
    return load_scene(str(REPO / "scenes" / "cornell_mesh_blob.txt"), device="cpu").mesh.bvh


def blob_rays(bvh, n, seed):
    """(origins, unit directions) as (3, n) float32: from a box around the
    blob, half aimed at points inside random faces, half anywhere."""
    rng = np.random.default_rng(seed)
    v = bvh.faces_packed[:bvh.num_faces, :9].numpy().reshape(-1, 3, 3)
    lo, hi = v.min((0, 1)), v.max((0, 1))
    mid, ext = (lo + hi) / 2, (hi - lo)
    o = (mid[:, None] + rng.uniform(-1.5, 1.5, (3, n)) * ext[:, None]).astype(np.float32)
    bary = rng.dirichlet(np.ones(3), n)
    target = np.einsum("nc,ncx->xn", bary, v[rng.integers(0, len(v), n)])
    d = np.where(np.arange(n) % 2 == 0, target - o, rng.normal(size=(3, n)))
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    return o, d


def row_planes(rows, corner):
    """The (F, 1) planes of columns 3 corner .. 3 corner + 2 of face rows."""
    return Vec3(*(rows[:, 3 * corner + k, None] for k in range(3)))


def triangle_t_packed(packed, o, d):
    """The triangle test on packed rows, as K4 computes it: (F, N) t, u, w, hit."""
    return tintersect._triangle_t_edges(row_planes(packed, 0), row_planes(packed, 1),
                                        row_planes(packed, 2), o, d)


def test_packed_rows_hold_v0_and_the_two_edges(blob_bvh):
    rows = blob_bvh.faces_packed
    packed = mesh_kernel_v2p.pack_faces_v0e1e2(rows)
    assert packed.shape == (rows.shape[0], mesh_kernel_v2p.EDGE_COLS)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert torch.equal(packed[:, 0:3], rows[:, 0:3])
    assert torch.equal(packed[:, 3:6], rows[:, 3:6] - rows[:, 0:3])
    assert torch.equal(packed[:, 6:9], rows[:, 6:9] - rows[:, 0:3])
    assert not packed[:, 9:].any()
    # the padding faces past num_faces stay degenerate: no ray can hit them
    assert not packed[blob_bvh.num_faces:, 3:].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_triangle_test_equals_the_row_test_bitwise(blob_bvh, seed):
    o, d = blob_rays(blob_bvh, 256, seed)
    to, td = Vec3(*map(torch.from_numpy, o)), Vec3(*map(torch.from_numpy, d))
    rows = blob_bvh.faces_packed[:blob_bvh.num_faces]
    want = tintersect._triangle_t(row_planes(rows, 0), row_planes(rows, 1),
                                  row_planes(rows, 2), to, td)
    got = triangle_t_packed(mesh_kernel_v2p.pack_faces_v0e1e2(rows), to, td)
    assert int(want[3].sum()) > 100                     # the rays hit faces
    for g, w in zip(got, want):
        assert g.shape == (rows.shape[0], 256)
        assert torch.equal(g, w)


def test_packed_triangle_test_matches_jax(blob_bvh):
    o, d = blob_rays(blob_bvh, 256, seed=2)
    rows = blob_bvh.faces_packed[:blob_bvh.num_faces]
    got = triangle_t_packed(
        mesh_kernel_v2p.pack_faces_v0e1e2(rows), Vec3(*map(torch.from_numpy, o)),
        Vec3(*map(torch.from_numpy, d)))
    rn = rows.numpy()

    def jface(corner):                        # (1, F) face planes
        return JVec3(*(jnp.asarray(rn[None, :, 3 * corner + k]) for k in range(3)))

    jt, ju, jw, jhit = jintersect._triangle_t(
        jface(0), jface(1), jface(2), JVec3(*(jnp.asarray(c[:, None]) for c in o)),
        JVec3(*(jnp.asarray(c[:, None]) for c in d)))            # (N, F)
    hit = got[3].numpy().T
    np.testing.assert_array_equal(hit, np.asarray(jhit))
    assert hit.sum() > 100
    for g, w in zip(got[:3], (jt, ju, jw)):
        np.testing.assert_allclose(g.numpy().T[hit], np.asarray(w)[hit], rtol=RTOL, atol=ATOL)


def test_packed_faces_are_built_once_per_hierarchy(blob_bvh):
    first = mesh_kernel_v2p.packed_faces(blob_bvh)
    assert mesh_kernel_v2p.packed_faces(blob_bvh) is first
    assert torch.equal(first, mesh_kernel_v2p.pack_faces_v0e1e2(blob_bvh.faces_packed))
    # another hierarchy (here: the same tables copied) gets a table of its own
    other = dataclasses.replace(blob_bvh, faces_packed=blob_bvh.faces_packed.clone())
    second = mesh_kernel_v2p.packed_faces(other)
    assert second is not first and torch.equal(second, first)
    # an in-place edit of a face table is a new table
    other.faces_packed[0, 3] += 1.0
    third = mesh_kernel_v2p.packed_faces(other)
    assert third is not second and not torch.equal(third, second)
    assert torch.equal(third, mesh_kernel_v2p.pack_faces_v0e1e2(other.faces_packed))
