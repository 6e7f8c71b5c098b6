"""Host-side build of the mesh's cluster hierarchy (counterpart of ops/bvh.py).

A fixed-shape 3-level hierarchy over Morton-ordered faces:

  faces    -> grouped into clusters of ``CLUSTER`` (32)
  clusters -> groups of ``FANOUT`` (8) per supercluster (one "bin" of 256
              faces for the binned pipeline, render/mesh_binned.py)
  supers   -> groups of ``FANOUT`` (8) per hypercluster

Every level is a dense table of conservative AABBs, widened by a small
relative epsilon so the float32 slab test can never round a true hit out
of its node.  Faces are reordered in place by the caller
(scene/structs.py:make_mesh), so the dense scan and the hierarchy share
one face order and one tie-break.

The build is numpy code that repeats the JAX package's arithmetic step by
step (float64 centroids, stable argsort, float32 widening, the dead
padding row, the ``2 * FANOUT`` row minimum), so the tables are bitwise
equal to its tables; tests/test_torch_bvh.py holds them to that.  The one
difference is the face table's width: the JAX package pads each row to 128
floats for its copy engine's alignment, the port keeps the 19 used
columns.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

CLUSTER = 32      # faces per cluster
FANOUT = 8        # clusters per super, supers per hyper
FACE_COLS = 19    # v0 v1 v2 | n0 n1 n2 | material id

# Relative AABB widening: covers worst-case f32 rounding in the slab test.
_WIDEN_REL = 1e-5
_WIDEN_ABS = 1e-6

# Fill values for min/max reductions over partially padded groups, so that
# padding children never widen a real parent's box.
_PAD_LB = np.float32(3e38)
_PAD_UB = np.float32(-3e38)

# Padding bounds row: a box that is dead under the kernels' slab test.  An
# "inverted" box (lb=+big, ub=-big) is NOT dead there, because the slab test
# takes min/max of the two plane distances per axis.  This row gives each
# axis a point interval at +3e38 (x), -3e38 (y), 0 (z): for every sign
# combination of the direction the per-axis t-intervals are disjoint, or
# meet only at +/-inf where the strict entry < t_run cull kills them.
_DEAD_ROW = np.array([3e38, -3e38, 0.0, 3e38, -3e38, 0.0, 0.0, 0.0],
                     np.float32)


@dataclasses.dataclass
class MeshBVH:
    """Kernel-ready face table + hierarchy tables, all in Morton face order.

    ``faces_packed`` is one (19,) f32 row per face, [v0 v1 v2 | n0 n1 n2 |
    material_id]; material ids ride as f32 (exact below 2^24) and padding
    rows carry -1 there.  Bounds rows are [lbx lby lbz ubx uby ubz 0 0];
    padding rows carry ``_DEAD_ROW``, which can never pass the slab test.
    """

    faces_packed: torch.Tensor    # (Fp, 19) f32
    cluster_bounds: torch.Tensor  # (Kp, 8) f32
    super_bounds: torch.Tensor    # (Sp, 8) f32
    hyper_bounds: torch.Tensor    # (Hp, 8) f32
    num_faces: int = 0            # true face count
    cluster: int = CLUSTER        # faces per cluster this table was built with

    # Real (unpadded) node counts; rows past these are dead padding.
    @property
    def n_clusters_real(self) -> int:
        return max(1, -(-self.num_faces // self.cluster))

    @property
    def n_supers_real(self) -> int:
        return -(-self.n_clusters_real // FANOUT)

    @property
    def n_hypers_real(self) -> int:
        return -(-self.n_supers_real // FANOUT)

    def to(self, device) -> "MeshBVH":
        return dataclasses.replace(
            self, faces_packed=self.faces_packed.to(device),
            cluster_bounds=self.cluster_bounds.to(device),
            super_bounds=self.super_bounds.to(device),
            hyper_bounds=self.hyper_bounds.to(device))


def morton_order(vertices: np.ndarray) -> np.ndarray:
    """Sort faces by the 30-bit Morton code of their centroid (stable)."""
    c = vertices.astype(np.float64).mean(axis=1)            # (F, 3)
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.minimum((1023.0 * (c - lo) / ext), 1023.0).astype(np.uint64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & np.uint64(0x30000FF)
        x = (x | (x << 8)) & np.uint64(0x300F00F)
        x = (x | (x << 4)) & np.uint64(0x30C30C3)
        x = (x | (x << 2)) & np.uint64(0x9249249)
        return x

    code = (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) \
        | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _bounds_rows(vmin: np.ndarray, vmax: np.ndarray, pad_to: int) -> np.ndarray:
    """Stack (n,3) min/max into widened (pad_to, 8) rows."""
    n = vmin.shape[0]
    widen = _WIDEN_REL * np.maximum(np.abs(vmin), np.abs(vmax)) + _WIDEN_ABS
    rows = np.tile(_DEAD_ROW, (pad_to, 1))
    rows[:n, 0:3] = (vmin - widen).astype(np.float32)
    rows[:n, 3:6] = (vmax + widen).astype(np.float32)
    rows[:n, 6:8] = 0.0
    return rows


def _group_bounds(lb: np.ndarray, ub: np.ndarray, group: int,
                  pad_mult: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Min/max-reduce (n,3) child bounds into ceil(n/group) parent bounds.

    Row tables keep a 2*FANOUT minimum, as the JAX package's do.
    """
    n = lb.shape[0]
    m = -(-n // group)
    pl_ = np.full((m * group, 3), _PAD_LB, lb.dtype)
    pu = np.full((m * group, 3), _PAD_UB, ub.dtype)
    pl_[:n] = lb
    pu[:n] = ub
    glb = pl_.reshape(m, group, 3).min(axis=1)
    gub = pu.reshape(m, group, 3).max(axis=1)
    pad = max(-(-m // pad_mult) * pad_mult, 2 * FANOUT)
    return glb, gub, _bounds_rows(glb, gub, pad)


def build_mesh_bvh(vertices: np.ndarray, normals: np.ndarray,
                   material_id: np.ndarray, reorder: bool = True
                   ) -> Tuple[MeshBVH, np.ndarray]:
    """Build the hierarchy from (F,3,3) world-space faces (CPU tensors).

    Returns (bvh, order); ``order`` is the Morton permutation applied, which
    the caller applies to its own face arrays so that the dense scan shares
    the hierarchy's face order and tie-breaks.
    """
    vertices = np.asarray(vertices, np.float32)
    normals = np.asarray(normals, np.float32)
    material_id = np.asarray(material_id, np.int32)
    f = vertices.shape[0]
    order = morton_order(vertices) if (reorder and f > 1) \
        else np.arange(f, dtype=np.int64)
    v = vertices[order]
    nrm = normals[order]
    mid = material_id[order]

    # Faces pad to a whole number of clusters and clusters to a whole number
    # of supers, so every k in [0, Kp) indexes a full 32-face block.
    k = max(1, -(-f // CLUSTER))
    kp = max(-(-k // FANOUT) * FANOUT, 2 * FANOUT)
    fp = kp * CLUSTER
    packed = np.zeros((fp, FACE_COLS), np.float32)
    packed[:, 18] = -1.0
    packed[:f, 0:9] = v.reshape(f, 9)
    packed[:f, 9:18] = nrm.reshape(f, 9)
    packed[:f, 18] = mid.astype(np.float32)

    # cluster bounds from real faces only, which keeps the boxes tight
    fmin = np.full((fp, 3), _PAD_LB, np.float32)
    fmax = np.full((fp, 3), _PAD_UB, np.float32)
    fmin[:f] = v.min(axis=1)
    fmax[:f] = v.max(axis=1)
    clb = fmin.reshape(kp, CLUSTER, 3).min(axis=1)[:k]
    cub = fmax.reshape(kp, CLUSTER, 3).max(axis=1)[:k]
    cluster_rows = _bounds_rows(clb, cub, kp)

    slb, sub_, super_rows = _group_bounds(clb, cub, FANOUT, FANOUT)
    _, _, hyper_rows = _group_bounds(slb, sub_, FANOUT, FANOUT)
    return bvh_from_numpy(packed, cluster_rows, super_rows, hyper_rows, f), order


def bvh_from_numpy(faces_packed, cluster_bounds, super_bounds, hyper_bounds,
                   num_faces: int, cluster: int = CLUSTER) -> MeshBVH:
    """A ``MeshBVH`` from numpy tables; a wider face table (the JAX
    package's 128-column rows) is cut to its 19 used columns."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))   # an own copy

    bvh = MeshBVH(faces_packed=t(np.asarray(faces_packed)[:, :FACE_COLS]),
                  cluster_bounds=t(cluster_bounds), super_bounds=t(super_bounds),
                  hyper_bounds=t(hyper_bounds), num_faces=int(num_faces),
                  cluster=int(cluster))
    if bvh.super_bounds.shape[0] * FANOUT < bvh.cluster_bounds.shape[0] \
            or bvh.hyper_bounds.shape[0] * FANOUT < bvh.super_bounds.shape[0] \
            or bvh.faces_packed.shape[0] < bvh.n_supers_real * FANOUT * cluster:
        raise ValueError("hierarchy tables do not cover their children")
    return bvh
