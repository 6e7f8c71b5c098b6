"""Front-to-back traversal of the mesh's cluster hierarchy by subtiles of
128 rays, impl "v3" (counterpart of render/mesh_kernel_v3.py).

``mesh_intersect_bvh_v3`` has the contract of ``mesh_intersect_bvh``: the
closest face hit with t strictly below ``t_cull`` per ray as (t, point,
normal, material), t = +inf / zeros / -1 on a miss.  What changes is the
walk.  The rays are cut into subtiles of 128.  A subtile first tests the
root box (the union of the real hyper boxes) and leaves if no ray is live.
On each level it slab-tests the 8 siblings at once, takes each sibling's
minimum entry distance over the subtile (+inf where no ray is live), sorts
the 8 with a 19-comparator network (``_NET8``) and visits them nearest
first, so that a near hit tightens the running t before the occluded
siblings are tested again.  A cluster is tested once more against the
running t right before its 32 face tests; a cluster that passes is
visited, and ``visit_counter`` receives the number of (subtile, cluster)
visits.

The visiting order is not the face order, so the merge carries the dense
scan's tie-break itself: a cluster's first minimal hit wins iff t < t_run,
or t == t_run, the cluster's index is below the winner's and t is finite.
"No winner yet" is cluster -1: a tie against the ``t_cull`` seed loses, as
the scene merge needs (it takes the mesh only on strictly smaller t).

On CUDA tensors it launches csrc/mesh_bvh_v3.cu (persistent blocks of 128
threads, one subtile at a time; only the rays live in a visited cluster
test its faces, ray by ray over the block's warps; faces from the packed
table ``mesh_kernel_v2p.packed_faces``; the root box from
``cached_root_box``).
On CPU tensors it runs the plain version below, the same walk subtile by
subtile with the same visits.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.bvh import FANOUT, MeshBVH
from ..ops.vec3 import Vec3
from ..utils.cuda_build import CudaKernel, check
from ..utils.derived_cache import DerivedCache
from .mesh_kernel import (TileState, _concat_tiles, _full_cull, edges_ptr, set_visits,
                          tile_counters, tile_states)
from .mesh_kernel_v2p import (_check_bvh, _slab_entry, hit_buffers, hit_planes, ray_planes,
                              table_ptrs)

LANES = 128             # rays per subtile
_INF = float("inf")

# Batcher's odd-even merge sort network for 8 elements (19 comparators).
_NET8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
         (2, 4), (3, 5), (3, 4))



def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aptd_mesh_bvh_v3.restype = i
    lib.aptd_mesh_bvh_v3.argtypes = [p] * 7 + [i] + [p] * 6 + [i] * 4 + [p] * 5


KERNEL = CudaKernel("mesh_bvh_v3", "mesh_bvh_v3.cu", extra_flags=("-fmad=false",),
                    declare=_declare, headers=("mesh_common.cuh", "mesh_tile.cuh"))


def sort8(vals: Sequence[float]) -> Tuple[List[float], List[int]]:
    """Sort 8 values ascending with the network; returns (values, original
    indices).  An exchange needs a strictly greater left value."""
    vals, idx = list(vals), list(range(FANOUT))
    for a, b in _NET8:
        if vals[a] > vals[b]:
            vals[a], vals[b] = vals[b], vals[a]
            idx[a], idx[b] = idx[b], idx[a]
    return vals, idx


def root_box(bvh: MeshBVH) -> torch.Tensor:
    """(8,) bounds row of the whole mesh: the union of the REAL hyper boxes.
    The padding rows are dead boxes (ops/bvh.py) and would blow the union up
    to the whole universe."""
    hr = bvh.hyper_bounds[:bvh.n_hypers_real]
    return torch.cat([hr[:, 0:3].min(dim=0).values, hr[:, 3:6].max(dim=0).values,
                      hr.new_zeros(2)])


_ROOTS = DerivedCache(8)


def cached_root_box(bvh: MeshBVH) -> torch.Tensor:
    """``root_box(bvh)`` on the tables' device, built once per hyper table
    (again after an in-place change to it)."""
    return _ROOTS.get(bvh.hyper_bounds, (bvh.n_hypers_real,), lambda: root_box(bvh))


def _front_to_back(st: TileState, table: torch.Tensor, base: int, n_rows: int):
    """Children base .. base + 7 of a level that have a live ray, nearest
    first by the subtile's minimum entry distance."""
    rows = table[base:min(base + FANOUT, n_rows)]
    ents = [_INF] * FANOUT
    if rows.shape[0]:
        tmin, tmax = _slab_entry(rows, st.o, st.inv)
        entry = torch.clamp_min(tmin, 0.0)
        live = (tmax >= tmin) & (tmax >= 0.0) & (entry < st.t)
        ents[:rows.shape[0]] = torch.where(live, entry, _INF).min(dim=1).values.tolist()
    vals, idx = sort8(ents)
    return [base + i for v, i in zip(vals, idx) if v < _INF]


def mesh_intersect_bvh_v3_plain(bvh: MeshBVH, o: Vec3, d: Vec3,
                                t_cull: Optional[torch.Tensor] = None,
                                visit_counter: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """The kernel's plain PyTorch version: per subtile of 128 rays the
    front-to-back walk with the cluster-index tie-break.  ``visit_counter``
    (one int32) receives the visits, summed over the subtiles."""
    t_cull = _full_cull(o, t_cull)
    root = cached_root_box(bvh)[None]
    parts, visits = [], 0
    for st in tile_states(bvh, o, d, t_cull, LANES):
        cluster = torch.full(st.t.shape, -1, dtype=torch.int64, device=st.t.device)
        if st.live(root).any():
            for hbase in range(0, bvh.n_hypers_real, FANOUT):
                for h in _front_to_back(st, bvh.hyper_bounds, hbase, bvh.n_hypers_real):
                    for s in _front_to_back(st, bvh.super_bounds, h * FANOUT,
                                            bvh.n_supers_real):
                        for k in _front_to_back(st, bvh.cluster_bounds, s * FANOUT,
                                                bvh.n_clusters_real):
                            # an earlier sibling's hit may have culled it since
                            if not st.live(bvh.cluster_bounds[k:k + 1]).any():
                                continue
                            visits += 1
                            t, u, w, face = st.cluster_hit(k)
                            better = (t < st.t) | ((t == st.t) & (k < cluster) & (t < _INF))
                            st.merge(better, t, u, w, face)
                            cluster = torch.where(better, k, cluster)
        parts.append(st.result())
    set_visits(visit_counter, visits, t_cull.device)
    return _concat_tiles(parts, o.x)


def mesh_intersect_bvh_v3(bvh: MeshBVH, o: Vec3, d: Vec3,
                          t_cull: Optional[torch.Tensor] = None,
                          visit_counter: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Vec3, Vec3, torch.Tensor]:
    """Closest-hit query through the hierarchy, front to back per subtile of
    128 rays; ``visit_counter`` (one int32 on the rays' device) receives the
    (subtile, cluster) visits.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _check_bvh(bvh)
    n = o.x.shape[0]
    t_cull = _full_cull(o, t_cull)
    if t_cull.device.type == "cpu":
        return mesh_intersect_bvh_v3_plain(bvh, o, d, t_cull, visit_counter)
    dev = t_cull.device
    planes = ray_planes(o, d, t_cull)
    faces, *bounds = table_ptrs(bvh, dev)
    edges = edges_ptr(bvh, dev)
    root = cached_root_box(bvh)
    out, mat = hit_buffers(n, dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.aptd_mesh_bvh_v3(
            *(p.data_ptr() for p in planes), n, faces, edges, *bounds, root.data_ptr(),
            bvh.num_faces, bvh.n_clusters_real, bvh.n_supers_real, bvh.n_hypers_real,
            out.data_ptr(), mat.data_ptr(), *tile_counters(dev, stream, visit_counter), stream)
    check(rc, "front-to-back mesh BVH kernel")
    KERNEL.launches += 1
    return hit_planes(out, mat)
