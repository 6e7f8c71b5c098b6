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

The kernel reads the faces from a second table, ``packed_faces``: v0 and
the two edges per face in 12 floats, built once per hierarchy on the
table's device (its plain version is ``pack_faces_v0e1e2``).
``traversal_work`` counts the tests the rays need (the kernel's bound),
``traversal_warp_work`` what a thread-per-ray warp would issue for them.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..ops.bvh import CLUSTER, FANOUT, MeshBVH
from ..ops.intersect import scan_faces_v
from ..ops.vec3 import Vec3
from ..utils.cuda_build import CudaKernel, check
from ..utils.derived_cache import DerivedCache

_INF = float("inf")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_mesh_bvh_v2p.restype = i
    lib.aptd_mesh_bvh_v2p.argtypes = [p] * 7 + [i] + [p] * 5 + [i] * 4 + [p] * 4


# Live rays in a warp from which the kernel tests a cluster's faces lane by
# ray (each live lane all 32 faces) instead of ray by ray (the 32 lanes on
# the 32 faces of one ray at a time).  Chosen by chip_smoke.py's sweep on the
# card (PERF.md); a constant of the build, not an option.
K_THR = 16


def kernel_build(k_thr: int, name: str = "mesh_bvh_v2p") -> CudaKernel:
    """K4's source built with the threshold ``k_thr``."""
    return CudaKernel(name, "mesh_bvh_v2p.cu",
                      extra_flags=("-fmad=false", f"-DAPTD_K4_K_THR={k_thr}"),
                      declare=_declare, headers=("mesh_common.cuh",))


KERNEL = kernel_build(K_THR)


EDGE_COLS = 12    # v0 | e1 = v1 - v0 | e2 = v2 - v0 | 0 0 0: three 16-byte pieces


def pack_faces_v0e1e2(faces_packed: torch.Tensor) -> torch.Tensor:
    """The face table K4 reads: (F, 19) rows -> (F, 12) rows [v0 | v1 - v0 |
    v2 - v0 | 0 0 0], the edges the same float32 subtractions that the
    triangle test makes (``ops/intersect.py:_triangle_t``)."""
    v0, v1, v2 = faces_packed[:, 0:3], faces_packed[:, 3:6], faces_packed[:, 6:9]
    return torch.cat([v0, v1 - v0, v2 - v0, torch.zeros_like(v0)], 1)


_EDGES = DerivedCache(8)


def packed_edges(faces_packed: torch.Tensor) -> torch.Tensor:
    """``pack_faces_v0e1e2(faces_packed)`` on the table's device, built once
    per table (K4 and the binned pair kernel share the entry)."""
    return _EDGES.get(faces_packed, (), lambda: pack_faces_v0e1e2(faces_packed))


def packed_faces(bvh: MeshBVH) -> torch.Tensor:
    """The hierarchy's packed (v0, e1, e2) face table, built once per
    hierarchy."""
    return packed_edges(bvh.faces_packed)


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
    """Refuse, on every device, a hierarchy the kernels cannot take: built
    with another cluster, or over ``MAX_KERNEL_FACES`` faces."""
    # mesh_kernel.py imports this module's helpers, so its cap is read here
    from .mesh_kernel import MAX_KERNEL_FACES
    if bvh.cluster != CLUSTER:
        raise ValueError(f"bvh built with cluster={bvh.cluster}, the kernels are "
                         f"compiled for CLUSTER={CLUSTER}")
    if bvh.num_faces > MAX_KERNEL_FACES:
        raise ValueError(f"mesh has {bvh.num_faces} faces > MAX_KERNEL_FACES="
                         f"{MAX_KERNEL_FACES}")


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


# The persistent blocks' batch counter, one int32 per (device, stream): the
# launcher zeroes it on the stream before each launch, so calls in order on
# one stream can share it.
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _batch_counter(dev: torch.device, stream: int) -> torch.Tensor:
    counter = _COUNTERS.get((dev, stream))
    if counter is None:
        counter = _COUNTERS[dev, stream] = torch.empty((1,), dtype=torch.int32, device=dev)
    return counter


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
    faces, *bounds = table_ptrs(bvh, dev)
    edges = packed_faces(bvh)
    out, mat = hit_buffers(n, dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        next_batch = _batch_counter(dev, stream)
        rc = lib.aptd_mesh_bvh_v2p(
            *(p.data_ptr() for p in planes), n, faces,
            table_ptr(edges, EDGE_COLS, dev), *bounds, bvh.num_faces,
            bvh.n_clusters_real, bvh.n_supers_real, bvh.n_hypers_real,
            out.data_ptr(), mat.data_ptr(), next_batch.data_ptr(), stream)
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
    return _traversal_bytes(bvh, n), face_tests, node_tests


def _traversal_bytes(bvh: MeshBVH, n: int) -> int:
    """Bytes a traversal of ``n`` rays must move: seven ray planes in, eight
    result planes out, the hierarchy's tables once."""
    tables = sum(t.numel() for t in (bvh.faces_packed, bvh.cluster_bounds,
                                     bvh.super_bounds, bvh.hyper_bounds))
    return 4 * (7 * n + 8 * n + tables)


def _live_per_group(table: torch.Tensor, real: int, o: Vec3, inv: Vec3,
                    t_cull: torch.Tensor, group: int, chunk: int) -> torch.Tensor:
    """(groups,) int64: for each ``group`` consecutive rays, the rows of
    ``table[:real]`` that any of them is live in at ``t_cull``."""
    n = t_cull.shape[0]
    n_groups = -(-n // group)
    counts = torch.zeros((n_groups,), dtype=torch.int64, device=t_cull.device)
    for lo in range(0, real, chunk):
        live = _slab_live(table[lo:min(lo + chunk, real)], o, inv, t_cull)
        tail = live.new_zeros((live.shape[0], n_groups * group - n))
        counts += torch.cat([live, tail], 1).reshape(live.shape[0], n_groups, group).any(2).sum(0)
    return counts


def warp_live_clusters(bvh: MeshBVH, o: Vec3, d: Vec3, t_cull: torch.Tensor,
                       group: int = 32, chunk: int = 64) -> torch.Tensor:
    """(groups,) int64: for each ``group`` consecutive rays, the clusters
    that any of them is live in at ``t_cull``; a thread-per-ray warp issues
    the 32 face tests of each."""
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    return _live_per_group(bvh.cluster_bounds, bvh.n_clusters_real, o, inv, t_cull,
                           group, chunk)


def traversal_warp_work(bvh: MeshBVH, o: Vec3, d: Vec3, t_cull: torch.Tensor,
                        group: int = 32, chunk: int = 64):
    """(bytes, face tests, node tests) that a thread-per-ray kernel issues
    when each ``group`` consecutive rays share a warp: a node or cluster
    that any ray of the group is live in costs all ``group`` lanes, live or
    masked off.  Liveness is counted level by level at ``t_cull``, as
    ``traversal_work`` counts it, which this equals at ``group=1``; the
    ratio of the two counts is such a kernel's SIMT efficiency."""
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    n = t_cull.shape[0]
    live_h, live_s, live_c = (
        int(_live_per_group(table, real, o, inv, t_cull, group, chunk).sum())
        for table, real in ((bvh.hyper_bounds, bvh.n_hypers_real),
                            (bvh.super_bounds, bvh.n_supers_real),
                            (bvh.cluster_bounds, bvh.n_clusters_real)))
    node_tests = group * (-(-n // group) * bvh.n_hypers_real + FANOUT * (live_h + live_s))
    face_tests = group * CLUSTER * live_c
    return _traversal_bytes(bvh, n), face_tests, node_tests
