"""Per-ray traversal of the mesh's cluster hierarchy (counterpart of
render/mesh_kernel_v2p.py, and of render/mesh_kernel.py's ``_slab_live``).

``mesh_intersect_bvh_v2p`` has the JAX function's contract: the closest
face hit with t strictly below ``t_cull`` per ray, as (t, point, normal,
material), with t = +inf, zero vectors and material -1 where nothing beat
``t_cull``.  On CUDA tensors it launches csrc/mesh_bvh_v2p.cu; on CPU
tensors it runs the kernel's plain version, the dense scan over the
hierarchy's own face table with the ``t < t_cull`` rule applied, which
computes the same function (every cull of the traversal is conservative).

The JAX package's "v2p" and "v2s" modes differ only in how finely a tile of
rays gates a cluster (whole tile or 128-lane column).  The CUDA kernel gates
per ray, finer than either, so both modes run it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ops.bvh import CLUSTER, FANOUT, MeshBVH
from ..ops.intersect import scan_faces_v
from ..ops.vec3 import Vec3
from ..utils.cuda_build import CudaKernel, check

_INF = float("inf")
MAX_KERNEL_FACES = 1_000_000   # keeps face and pair indices well inside int32


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_mesh_bvh_v2p.restype = i
    lib.aptd_mesh_bvh_v2p.argtypes = [p] * 7 + [i] + [p] * 4 + [i] * 4 + [p] * 3


KERNEL = CudaKernel("mesh_bvh_v2p", "mesh_bvh_v2p.cu", extra_flags=("-fmad=false",),
                    declare=_declare, headers=("mesh_common.cuh",))


def _slab_entry(rows: torch.Tensor, o: Vec3, inv: Vec3):
    """Rays vs AABB rows: (tmin, tmax) of each ray's overlap with each box.

    ``rows``: (K, 8) bounds rows [lbx lby lbz ubx uby ubz _ _]; the ray
    planes are (N,).  Returns two (K, N) tensors.  A NaN plane distance
    (0 * inf: the origin on a box face with a zero direction component)
    leaves that axis unbounded instead of culling, so a gate built on this
    is only ever conservative; the rule is written out because
    ``torch.minimum`` propagates NaN while the CUDA kernels' ``fminf`` drops
    it.
    """
    tmin = torch.full((rows.shape[0], o.x.shape[0]), -_INF,
                      dtype=torch.float32, device=o.x.device)
    tmax = torch.full_like(tmin, _INF)
    for axis, (oc, ic) in enumerate(((o.x, inv.x), (o.y, inv.y), (o.z, inv.z))):
        t1 = (rows[:, axis, None] - oc) * ic
        t2 = (rows[:, axis + 3, None] - oc) * ic
        nan = torch.isnan(t1) | torch.isnan(t2)
        lo = torch.where(nan, -_INF, torch.minimum(t1, t2))
        hi = torch.where(nan, _INF, torch.maximum(t1, t2))
        tmin = torch.maximum(tmin, lo)
        tmax = torch.minimum(tmax, hi)
    return tmin, tmax


def _slab_live(rows: torch.Tensor, o: Vec3, inv: Vec3, t_run: torch.Tensor):
    """Rays vs AABB rows: live = hits the box & enters it before ``t_run``.
    Returns (K, N) bool."""
    tmin, tmax = _slab_entry(rows, o, inv)
    return (tmax >= tmin) & (tmax >= 0.0) & (torch.clamp_min(tmin, 0.0) < t_run)


def bvh_face_tables(bvh: MeshBVH):
    """(vertices (F,3,3), normals (F,3,3), material ids (F,) int32) of the
    hierarchy's real faces, as views of its packed table."""
    f = bvh.num_faces
    rows = bvh.faces_packed[:f]
    return (rows[:, 0:9].reshape(f, 3, 3), rows[:, 9:18].reshape(f, 3, 3),
            rows[:, 18].to(torch.int32))


def mesh_intersect_bvh_v2p_plain(bvh: MeshBVH, o: Vec3, d: Vec3,
                                 t_cull: Optional[torch.Tensor] = None,
                                 chunk: int = 16
                                 ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """The kernel's plain PyTorch version: the dense scan over the
    hierarchy's face table, keeping only hits strictly below ``t_cull``.
    ``chunk`` (faces per scan step) changes the cost, not the result."""
    t, p, nrm, mat = scan_faces_v(*bvh_face_tables(bvh), o, d, chunk)
    if t_cull is None:
        return t, p, nrm, mat
    keep = t < t_cull

    def sel(a):
        return torch.where(keep, a, 0.0)

    return (torch.where(keep, t, _INF), Vec3(sel(p.x), sel(p.y), sel(p.z)),
            Vec3(sel(nrm.x), sel(nrm.y), sel(nrm.z)), torch.where(keep, mat, -1))


def _check_bvh(bvh: MeshBVH) -> None:
    if bvh.cluster != CLUSTER:
        raise ValueError(f"bvh built with cluster={bvh.cluster}, the kernels "
                         f"are written for CLUSTER={CLUSTER}")
    if bvh.num_faces > MAX_KERNEL_FACES:
        raise ValueError(f"mesh has {bvh.num_faces} faces > {MAX_KERNEL_FACES}")


def ray_planes(o: Vec3, d: Vec3, extra: torch.Tensor):
    """The seven planes a mesh kernel reads, checked: float32 (``extra``
    may be int32), 1-D, one length, contiguous, on one CUDA device."""
    n = extra.shape[0]
    planes = []
    for name, t in zip(("o.x", "o.y", "o.z", "d.x", "d.y", "d.z", "extra"),
                       (*o, *d, extra)):
        want = (torch.float32, torch.int32) if name == "extra" else (torch.float32,)
        if t.device != extra.device or t.dtype not in want or t.shape != (n,):
            raise ValueError(f"ray plane {name}: expected {want[0]} ({n},) on "
                             f"{extra.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        planes.append(t.contiguous())
    return planes


def table_ptr(table: torch.Tensor, cols: int, device) -> int:
    """Pointer of a hierarchy table, checked: contiguous float32 (R, cols)."""
    if (table.device != device or table.dtype != torch.float32
            or table.ndim != 2 or table.shape[1] != cols
            or not table.is_contiguous()):
        raise ValueError(f"hierarchy table must be contiguous float32 "
                         f"(R, {cols}) on {device}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    return table.data_ptr()


def table_ptrs(bvh: MeshBVH, device):
    """Pointers of the face table and the three bounds tables, checked."""
    return (table_ptr(bvh.faces_packed, 19, device), table_ptr(bvh.cluster_bounds, 8, device),
            table_ptr(bvh.super_bounds, 8, device), table_ptr(bvh.hyper_bounds, 8, device))


def hit_buffers(n: int, device):
    """The (7, n) float32 and (n,) int32 buffers a traversal kernel fills."""
    return (torch.empty((7, n), dtype=torch.float32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device))


def hit_planes(out: torch.Tensor, mat: torch.Tensor):
    """(t, point, normal, material) views of a traversal kernel's buffers."""
    return out[0], Vec3(out[1], out[2], out[3]), Vec3(out[4], out[5], out[6]), mat


def mesh_intersect_bvh_v2p(bvh: MeshBVH, o: Vec3, d: Vec3,
                           t_cull: Optional[torch.Tensor] = None,
                           lanes: Optional[int] = None, subtile: bool = False,
                           ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """Closest-hit query through the hierarchy, strictly below ``t_cull``.

    ``lanes`` (the TPU kernel's rays per tile, its gating granule) and
    ``subtile`` (its per-column gating) are accepted for the JAX function's
    signature and have no effect: the CUDA kernel gates per ray.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    del lanes, subtile
    _check_bvh(bvh)
    n = o.x.shape[0]
    if t_cull is None:
        t_cull = torch.full((n,), _INF, dtype=torch.float32, device=o.x.device)
    if t_cull.device.type == "cpu":
        return mesh_intersect_bvh_v2p_plain(bvh, o, d, t_cull)
    dev = t_cull.device
    planes = ray_planes(o, d, t_cull)
    tables = table_ptrs(bvh, dev)
    out, mat = hit_buffers(n, dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.aptd_mesh_bvh_v2p(
            *(p.data_ptr() for p in planes), n, *tables, bvh.num_faces,
            bvh.n_clusters_real, bvh.n_supers_real, bvh.n_hypers_real,
            out.data_ptr(), mat.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "mesh BVH kernel")
    KERNEL.launches += 1
    return hit_planes(out, mat)


def traversal_work(bvh: MeshBVH, o: Vec3, d: Vec3, t_cull: torch.Tensor,
                   chunk: int = 64):
    """(bytes, face tests, node tests) the traversal cannot avoid for these
    rays: each ray plane read and each result plane written once, the
    tables once; one face test per face of every cluster the ray is live
    in at its ``t_cull`` and one node test per child of every live node,
    counted level by level with ``_slab_live``."""
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    n = t_cull.shape[0]

    def live_count(table, real):
        total = 0
        for lo in range(0, real, chunk):
            total += int(_slab_live(table[lo:min(lo + chunk, real)], o, inv,
                                    t_cull).sum())
        return total

    live_h = live_count(bvh.hyper_bounds, bvh.n_hypers_real)
    live_s = live_count(bvh.super_bounds, bvh.n_supers_real)
    live_c = live_count(bvh.cluster_bounds, bvh.n_clusters_real)
    node_tests = n * bvh.n_hypers_real + FANOUT * (live_h + live_s)
    face_tests = CLUSTER * live_c
    tables = sum(t.numel() for t in (bvh.faces_packed, bvh.cluster_bounds,
                                     bvh.super_bounds, bvh.hyper_bounds))
    n_bytes = 4 * (7 * n + 8 * n + tables)
    return n_bytes, face_tests, node_tests
