"""Tile-gated traversal of the mesh's cluster hierarchy, impl "v2"
(counterpart of render/mesh_kernel.py).

``mesh_intersect_bvh`` has the JAX function's contract, which is also
``mesh_intersect_bvh_v2p``'s: the closest face hit with t strictly below
``t_cull`` per ray as (t, point, normal, material), with t = +inf, zero
vectors and material -1 where nothing beat ``t_cull``.  The rays are cut
into tiles of ``lanes``; the hierarchy is descended hyper -> super ->
cluster in index order and a node is entered iff ANY ray of the tile is
live in it (hits its box and enters it before the ray's running t); a live
cluster's 32 faces are then tested for the tile, first minimal face wins.
``lanes`` is the gating granule: pure work partitioning, the result is the
same bit for bit for any value.  What does depend on it is which clusters
a tile visits; ``visit_counter`` receives their number, (tile, cluster)
pairs summed over the tiles, and ``visited_clusters`` lists them.

On CUDA tensors it launches csrc/mesh_bvh_v2.cu: persistent blocks of
``lanes`` threads, one tile at a time, only the rays live in a visited
cluster testing its faces (ray by ray, spread over the block's warps),
faces read from the packed table ``mesh_kernel_v2p.packed_faces``.  On CPU
tensors it runs the plain version below, which walks the levels tile by
tile with the same votes and counts the same visits.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from ..ops.bvh import CLUSTER, FANOUT, MeshBVH
from ..ops.intersect import _triangle_t
from ..ops.vec3 import Vec3
from ..utils.cuda_build import CudaKernel, check
from .mesh_kernel_v2p import (EDGE_COLS, _check_bvh, _slab_live, hit_buffers, hit_planes,
                              packed_faces, ray_planes, table_ptr, table_ptrs)

LANES = 1024            # default rays per tile: the largest CUDA block
MAX_LANES = 1024
# The largest mesh the hierarchy kernels K4-K8 take (the JAX package's cap):
# it keeps face and pair indices well inside int32.
MAX_KERNEL_FACES = 1_000_000
_INF = float("inf")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_mesh_bvh_v2.restype = i
    lib.aptd_mesh_bvh_v2.argtypes = [p] * 7 + [i, i] + [p] * 5 + [i] * 4 + [p] * 5


KERNEL = CudaKernel("mesh_bvh_v2", "mesh_bvh_v2.cu", extra_flags=("-fmad=false",),
                    declare=_declare, headers=("mesh_common.cuh", "mesh_tile.cuh"))


def check_lanes(lanes: int) -> int:
    """``lanes`` is a CUDA block size here: a multiple of 128, at most 1024."""
    if lanes <= 0 or lanes % 128 or lanes > MAX_LANES:
        raise ValueError(f"mesh_kernel_lanes={lanes}: a multiple of 128, at most "
                         f"{MAX_LANES}")
    return lanes


class TileState:
    """Running closest hit of one tile of rays against a face table."""

    def __init__(self, bvh: MeshBVH, o: Vec3, d: Vec3, t_cull: torch.Tensor):
        self.bvh, self.o, self.d = bvh, o, d
        self.inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
        self.t = t_cull.clone()
        self.u = torch.zeros_like(self.t)
        self.w = torch.zeros_like(self.t)
        self.face = torch.full(self.t.shape, -1, dtype=torch.int64, device=self.t.device)

    def live(self, rows: torch.Tensor) -> torch.Tensor:
        """(K, N) bool: ray n is live in box k at its running t."""
        return _slab_live(rows, self.o, self.inv, self.t)

    def cluster_hit(self, k: int):
        """First minimal hit of every ray in cluster ``k``'s real faces:
        (t, u, w, face row), t = +inf on a miss."""
        lo = k * CLUSTER
        rows = self.bvh.faces_packed[lo:min(lo + CLUSTER, self.bvh.num_faces)]

        def corner(c):
            return Vec3(*(rows[:, 3 * c + a, None] for a in range(3)))

        o2, d2 = (Vec3(*(c[None] for c in v)) for v in (self.o, self.d))
        t, u, w, hit = _triangle_t(corner(0), corner(1), corner(2), o2, d2)
        t = torch.where(hit & (t > 0.0), t, _INF)
        t_c, j = torch.min(t, dim=0)
        jj = j[None]
        return (t_c, torch.gather(u, 0, jj)[0], torch.gather(w, 0, jj)[0], lo + j)

    def merge(self, better: torch.Tensor, t, u, w, face) -> None:
        self.t = torch.where(better, t, self.t)
        self.u = torch.where(better, u, self.u)
        self.w = torch.where(better, w, self.w)
        self.face = torch.where(better, face, self.face)

    def result(self):
        """(t, point, normal, material) planes of the tile."""
        found = self.face >= 0
        rows = self.bvh.faces_packed[self.face.clamp_min(0)]          # (N, 19)
        u, w = self.u, self.w
        v = 1.0 - u - w

        def corner(c):
            return Vec3(*(rows[:, 3 * c + a] for a in range(3)))

        # rotated barycentrics for the point, standard for the normal
        point = corner(0) * u + corner(1) * w + corner(2) * v
        normal = (corner(3) * v + corner(4) * u + corner(5) * w).normalized_safe()
        zero = torch.zeros_like(self.t)
        return (torch.where(found, self.t, _INF),
                Vec3(*(torch.where(found, c, zero) for c in point)),
                Vec3(*(torch.where(found, c, zero) for c in normal)),
                torch.where(found, rows[:, 18].to(torch.int32), -1))


def tile_states(bvh: MeshBVH, o: Vec3, d: Vec3, t_cull: torch.Tensor, lanes: int):
    """A ``TileState`` for each ``lanes`` consecutive rays."""
    for lo in range(0, t_cull.shape[0], lanes):
        sl = slice(lo, lo + lanes)
        yield TileState(bvh, Vec3(*(c[sl] for c in o)), Vec3(*(c[sl] for c in d)), t_cull[sl])


def _walk_tile(st: TileState) -> List[int]:
    """The index-order descent of one tile with ``.any()`` votes; returns
    the clusters it visited (ran face tests for), in order."""
    bvh = st.bvh
    visited = []
    for h in range(bvh.n_hypers_real):
        if not st.live(bvh.hyper_bounds[h:h + 1]).any():
            continue
        for s in range(h * FANOUT, min((h + 1) * FANOUT, bvh.n_supers_real)):
            if not st.live(bvh.super_bounds[s:s + 1]).any():
                continue
            for k in range(s * FANOUT, min((s + 1) * FANOUT, bvh.n_clusters_real)):
                if not st.live(bvh.cluster_bounds[k:k + 1]).any():
                    continue
                visited.append(k)
                t, u, w, face = st.cluster_hit(k)
                st.merge(t < st.t, t, u, w, face)   # strict: earlier face keeps ties
    return visited


def _full_cull(o: Vec3, t_cull: Optional[torch.Tensor]) -> torch.Tensor:
    if t_cull is None:
        return torch.full((o.x.shape[0],), _INF, dtype=torch.float32, device=o.x.device)
    return t_cull


def visited_clusters(bvh: MeshBVH, o: Vec3, d: Vec3, t_cull: Optional[torch.Tensor] = None,
                     lanes: Optional[int] = None) -> List[List[int]]:
    """Per tile of ``lanes`` rays (default 1024), the clusters the tile-gated
    walk visits, in visiting order (the plain version's walk)."""
    lanes = check_lanes(LANES if lanes is None else lanes)
    return [_walk_tile(st) for st in tile_states(bvh, o, d, _full_cull(o, t_cull), lanes)]


def _check_visit_counter(visit_counter: torch.Tensor, device) -> torch.Tensor:
    if (visit_counter.dtype != torch.int32 or visit_counter.numel() != 1
            or visit_counter.device != device):
        raise ValueError("visit_counter: one int32 on the rays' device")
    return visit_counter


def set_visits(visit_counter: Optional[torch.Tensor], visits: int, device) -> None:
    """A plain version's count into the caller's ``visit_counter``."""
    if visit_counter is not None:
        _check_visit_counter(visit_counter, device).fill_(visits)


def mesh_intersect_bvh_plain(bvh: MeshBVH, o: Vec3, d: Vec3,
                             t_cull: Optional[torch.Tensor] = None,
                             lanes: Optional[int] = None,
                             visit_counter: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """The kernel's plain PyTorch version: per tile of ``lanes`` rays the
    index-order descent with ``_slab_live(...).any()`` votes.
    ``visit_counter`` (one int32) receives the visits, summed over the
    tiles."""
    lanes = check_lanes(LANES if lanes is None else lanes)
    t_cull = _full_cull(o, t_cull)
    parts, visits = [], 0
    for st in tile_states(bvh, o, d, t_cull, lanes):
        visits += len(_walk_tile(st))
        parts.append(st.result())
    set_visits(visit_counter, visits, t_cull.device)
    return _concat_tiles(parts, o.x)


def _concat_tiles(parts, like: torch.Tensor):
    if not parts:
        empty = like.new_zeros((0,))
        return (empty, Vec3(empty, empty, empty), Vec3(empty, empty, empty),
                torch.zeros((0,), dtype=torch.int32, device=like.device))
    t, p, nrm, mat = zip(*parts)
    return (torch.cat(t), Vec3(*(torch.cat(c) for c in zip(*p))),
            Vec3(*(torch.cat(c) for c in zip(*nrm))), torch.cat(mat))


# Each persistent traversal's tile counter and default visit count, two
# int32 per (device, stream): the launcher zeroes both on the stream before
# each launch, so calls in order on one stream can share them.
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def tile_counters(dev: torch.device, stream: int,
                  visit_counter: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(tile counter, visit count) pointers for a launch on ``stream``; the
    visits go to ``visit_counter`` where one is given."""
    counters = _COUNTERS.get((dev, stream))
    if counters is None:
        counters = _COUNTERS[dev, stream] = torch.empty((2,), dtype=torch.int32, device=dev)
    visits = (counters[1:] if visit_counter is None
              else _check_visit_counter(visit_counter, dev))
    return counters.data_ptr(), visits.data_ptr()


def edges_ptr(bvh: MeshBVH, device) -> int:
    """Pointer of the hierarchy's packed (v0, e1, e2) face table, checked:
    the tile kernels copy it in 16-byte pieces."""
    ptr = table_ptr(packed_faces(bvh), EDGE_COLS, device)
    if ptr % 16:
        raise ValueError("the packed face table must start on a 16-byte boundary")
    return ptr


def mesh_intersect_bvh(bvh: MeshBVH, o: Vec3, d: Vec3,
                       t_cull: Optional[torch.Tensor] = None,
                       lanes: Optional[int] = None,
                       visit_counter: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """Closest-hit query through the hierarchy, gated per tile of ``lanes``
    rays (default 1024); ``visit_counter`` (one int32 on the rays' device)
    receives the (tile, cluster) visits.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check_bvh(bvh)
    lanes = check_lanes(LANES if lanes is None else lanes)
    n = o.x.shape[0]
    t_cull = _full_cull(o, t_cull)
    if t_cull.device.type == "cpu":
        return mesh_intersect_bvh_plain(bvh, o, d, t_cull, lanes, visit_counter)
    dev = t_cull.device
    planes = ray_planes(o, d, t_cull)
    faces, *bounds = table_ptrs(bvh, dev)
    edges = edges_ptr(bvh, dev)
    out, mat = hit_buffers(n, dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.aptd_mesh_bvh_v2(
            *(p.data_ptr() for p in planes), n, lanes, faces, edges, *bounds, bvh.num_faces,
            bvh.n_clusters_real, bvh.n_supers_real, bvh.n_hypers_real,
            out.data_ptr(), mat.data_ptr(), *tile_counters(dev, stream, visit_counter), stream)
    check(rc, "tile-gated mesh BVH kernel")
    KERNEL.launches += 1
    return hit_planes(out, mat)
