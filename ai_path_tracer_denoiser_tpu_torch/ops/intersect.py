"""Ray/primitive intersection over tensors (counterpart of ops/intersect.py).

Behavioral ports of intersections.h (box slab test :52-94, sphere
quadratic :106-148, glm one-sided Moller-Trumbore :159-172, ray/AABB slab
:175-200) as structure-of-arrays tensor math: every function evaluates a
whole ray batch, running minima pick the winner.  This is the plain
PyTorch version of the megakernel's intersection stage
(csrc/render_megakernel.cu), written in the same operation order.

Reference quirks kept on purpose (JAX ops/intersect.py:22-30):
  * the triangle test returns t with no epsilon backoff
    (intersections.h:170),
  * the triangle point uses the rotated barycentrics x*v0 + y*v1 +
    (1-x-y)*v2 (intersections.h:166), the normal the standard ones (:168).
``is_inside`` records the winner's side (the reference's last-tested quirk
is fixed, as in the JAX package).
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..scene.structs import CUBE, Geoms, MeshData
from ..utils.timers import host_read, span
from .vec3 import Vec3, where as vwhere, xform_dir, xform_point

_EPS_POINT = 1e-4       # getPointOnRay backoff (intersections.h:27-29)
_FLT_EPS = 1.1920929e-07
_BIG = 1e38


def box_intersect_v(transform, inverse_transform, o: Vec3, d: Vec3):
    """Ray planes vs one transformed unit cube.

    ``transform``/``inverse_transform``: (4,4) nested lists of 0-dim
    tensors (or of floats), so that a gradient can reach them.
    Returns (t, point, normal, outside); t is the world-space distance,
    -1 on miss.
    """
    qo = xform_point(inverse_transform, o)
    qd = xform_dir(inverse_transform, d).normalized()

    # IEEE inf on axis-parallel rays, like the reference's unguarded divides.
    axes = []
    for q_o, q_d in ((qo.x, qd.x), (qo.y, qd.y), (qo.z, qd.z)):
        t1 = (-0.5 - q_o) / q_d
        t2 = (0.5 - q_o) / q_d
        ta = torch.minimum(t1, t2)
        tb = torch.maximum(t1, t2)
        one = torch.ones_like(t1)
        sign = torch.where(t2 < t1, one, -one)
        axes.append((torch.where(ta > 0, ta, -_BIG), tb, sign))
    (ta0, tb0, s0), (ta1, tb1, s1), (ta2, tb2, s2) = axes
    tmin = torch.maximum(torch.maximum(ta0, ta1), ta2)
    tmax = torch.minimum(torch.minimum(tb0, tb1), tb2)

    # First-wins argmax/argmin over the 3 axes as selects.
    zero = torch.zeros_like(tmin)
    a0 = ta0 >= tmin
    a1 = (~a0) & (ta1 >= tmin)
    a2 = ~(a0 | a1)
    n_min = Vec3(torch.where(a0, s0, zero), torch.where(a1, s1, zero),
                 torch.where(a2, s2, zero))
    b0 = tb0 <= tmax
    b1 = (~b0) & (tb1 <= tmax)
    b2 = ~(b0 | b1)
    n_max = Vec3(torch.where(b0, s0, zero), torch.where(b1, s1, zero),
                 torch.where(b2, s2, zero))

    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = torch.where(inside, tmax, tmin)
    n_obj = vwhere(inside, n_max, n_min)

    obj_point = qo + qd * (t_obj - _EPS_POINT)
    point = xform_point(transform, obj_point)
    normal = xform_dir(transform, n_obj).normalized()
    t = torch.where(hit, (o - point).norm(), -1.0)
    return t, point, normal, ~inside


def sphere_intersect_v(transform, inverse_transform, inv_transpose,
                       o: Vec3, d: Vec3):
    """Ray planes vs one transformed radius-0.5 sphere (world-distance t)."""
    ro = xform_point(inverse_transform, o)
    rd = xform_dir(inverse_transform, d).normalized()

    v_dot_d = ro.dot(rd)
    radicand = v_dot_d * v_dot_d - (ro.dot(ro) - 0.25)
    sq = torch.sqrt(torch.clamp_min(radicand, 0.0))
    t1 = -v_dot_d + sq
    t2 = -v_dot_d - sq

    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    outside = both_pos
    hit = (radicand >= 0) & ~both_neg

    obj_point = ro + rd * (t_obj - _EPS_POINT)
    point = xform_point(transform, obj_point)
    normal = xform_dir(inv_transpose, obj_point).normalized()
    normal = vwhere(outside, normal, -normal)
    t = torch.where(hit, (o - point).norm(), -1.0)
    return t, point, normal, outside


def _matrix_entries(m: torch.Tensor):
    """(G, 4, 4) matrices as nested lists of 0-dim tensors: no host read,
    and a gradient reaches them; the float32 products and sums are those
    of python-float entries, bit for bit."""
    return [[row.unbind() for row in g.unbind()] for g in m.unbind()]


def intersect_geoms_v(geoms: Geoms, o: Vec3, d: Vec3):
    """All rays vs all analytic geoms; min-t with first-geom tie-break
    (computeIntersections' running ``t_min > t`` loop, pathtrace.cu:230-254).

    The matrices enter as tensors (a differentiable render of moved geoms,
    render/edge_grad.py, takes their gradient); the types and material ids
    are host values."""
    transforms = _matrix_entries(geoms.transform)
    inverses = _matrix_entries(geoms.inverse_transform)
    inv_ts = _matrix_entries(geoms.inv_transpose)
    with host_read("geom_materials"):
        mat_ids = geoms.material_id.tolist()
    types = geoms.type_tuple or tuple(geoms.type.tolist())

    t_best = torch.full_like(o.x, float("inf"))
    p_best = Vec3.full_like(o.x, 0.0)
    n_best = Vec3.full_like(o.x, 0.0)
    out_best = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    mat_best = torch.full(o.x.shape, -1, dtype=torch.int32, device=o.x.device)
    for i, ty in enumerate(types):
        if ty == CUBE:
            t, p, n, out = box_intersect_v(transforms[i], inverses[i], o, d)
        else:
            t, p, n, out = sphere_intersect_v(transforms[i], inverses[i],
                                              inv_ts[i], o, d)
        t = torch.where(t > 0.0, t, float("inf"))
        better = t < t_best            # strict: first geom wins ties
        t_best = torch.where(better, t, t_best)
        p_best = vwhere(better, p, p_best)
        n_best = vwhere(better, n, n_best)
        out_best = torch.where(better, out, out_best)
        mat_best = torch.where(better, mat_ids[i], mat_best)
    return t_best, p_best, n_best, out_best, mat_best


def _triangle_t(v0: Vec3, v1: Vec3, v2: Vec3, o: Vec3, d: Vec3):
    """Broadcast Moller-Trumbore (glm convention) -> (t, u, w, hit)."""
    return _triangle_t_edges(v0, v1 - v0, v2 - v0, o, d)


def _triangle_t_edges(v0: Vec3, e1: Vec3, e2: Vec3, o: Vec3, d: Vec3):
    """``_triangle_t`` on a face given as its corner v0 and its edges
    e1 = v1 - v0, e2 = v2 - v0 (the layout K4 reads)."""
    p = d.cross(e2)
    a = e1.dot(p)
    front = a >= _FLT_EPS                      # glm: a < eps -> miss
    f = 1.0 / a
    s = o - v0
    u = f * s.dot(p)
    q = s.cross(e1)
    w = f * d.dot(q)
    t = f * e2.dot(q)
    hit = front & (u >= 0) & (u <= 1) & (w >= 0) & (u + w <= 1) & (t >= 0)
    return t, u, w, hit


def scan_faces_v(vertices: torch.Tensor, normals: torch.Tensor,
                 material_id: torch.Tensor, o: Vec3, d: Vec3, chunk: int = 16):
    """Closest hit of every ray against every face of the tables given.

    ``vertices``/``normals``: (F, 3, 3) f32, ``material_id``: (F,) int32.
    Faces run in chunks of ``chunk`` broadcast against the ray planes
    ((chunk, N) tiles); within a chunk ``argmin`` picks the first minimal
    face, across chunks a strict ``<`` keeps the earlier one: overall the
    first minimal face for any ``chunk``, as in the JAX scan, the
    megakernel's loop and the BVH kernels.  The winner's point and normal
    are selected, not summed, so a ``-0.0`` stays ``-0.0``.
    """
    f_real = vertices.shape[0]
    dev = o.x.device
    t_min = torch.full_like(o.x, float("inf"))
    p_min = Vec3.full_like(o.x, 0.0)
    n_min = Vec3.full_like(o.x, 0.0)
    m_min = torch.full(o.x.shape, -1, dtype=torch.int32, device=dev)
    o2 = Vec3(o.x[None], o.y[None], o.z[None])
    d2 = Vec3(d.x[None], d.y[None], d.z[None])

    def planes(arr, corner):
        return Vec3(arr[:, corner, 0][:, None], arr[:, corner, 1][:, None],
                    arr[:, corner, 2][:, None])

    for lo in range(0, f_real, chunk):
        hi = min(lo + chunk, f_real)
        vs, ns = vertices[lo:hi], normals[lo:hi]
        v0, v1, v2 = (planes(vs, c) for c in range(3))
        t, u, w, hit = _triangle_t(v0, v1, v2, o2, d2)       # (chunk, N)
        t = torch.where(hit & (t > 0.0), t, float("inf"))
        t_c, j = torch.min(t, dim=0)
        jj = j[None]

        def sel(a):                                          # (chunk, N) -> (N,)
            return torch.gather(a.expand(t.shape), 0, jj)[0]

        n0, n1, n2 = (planes(ns, c) for c in range(3))
        v = 1.0 - u - w
        p_full = v0 * u + v1 * w + v2 * v
        n_full = n0 * v + n1 * u + n2 * w
        m_c = material_id[lo:hi][j]
        better = t_c < t_min
        t_min = torch.where(better, t_c, t_min)
        p_min = vwhere(better, Vec3(sel(p_full.x), sel(p_full.y), sel(p_full.z)), p_min)
        n_min = vwhere(better, Vec3(sel(n_full.x), sel(n_full.y), sel(n_full.z)), n_min)
        m_min = torch.where(better, m_c, m_min)
    normal = n_min.normalized_safe()
    mat = torch.where(torch.isfinite(t_min), m_min, -1)
    return t_min, p_min, normal, mat


def mesh_intersect_v(mesh: MeshData, o: Vec3, d: Vec3, chunk: int = 16):
    """Closest mesh hit by a dense scan over the mesh's real faces."""
    f = mesh.num_faces
    return scan_faces_v(mesh.vertices[:f], mesh.normals[:f],
                        mesh.material_id[:f], o, d, chunk)


def ray_aabb_intersect_v(o: Vec3, d: Vec3, lb, ub) -> torch.Tensor:
    """Slab AABB test (intersections.h:175-200) over ray planes -> bool.

    ``lb``/``ub``: 3-sequences of floats.  NaN-propagating min/max, as in
    the JAX package (see its docstring for why outcomes match the
    reference's fminf/fmaxf).
    """
    tmin = torch.full_like(o.x, -float("inf"))
    tmax = torch.full_like(o.x, float("inf"))
    for oc, dc, lo, hi in ((o.x, d.x, lb[0], ub[0]),
                           (o.y, d.y, lb[1], ub[1]),
                           (o.z, d.z, lb[2], ub[2])):
        inv = 1.0 / dc
        t1 = (lo - oc) * inv
        t2 = (hi - oc) * inv
        tmin = torch.maximum(tmin, torch.minimum(t1, t2))
        tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    return (tmax >= 0) & (tmin <= tmax)


def octant_cell_key(o: Vec3, d: Vec3, dead: torch.Tensor,
                    sort_cells: int = 8) -> torch.Tensor:
    """Coherence sort key: direction octant + origin-cell Morton index.

    ``sort_cells`` > 1: the cell is the major key (cells quantized over the
    batch's own origin bounds, dead lanes' origins included); < -1:
    octant-major.  Dead lanes get 2^30, so a stable sort packs live rays
    densely at the front.  Same order of operations as the JAX package's
    function, so the int32 keys are equal to its keys.
    """
    key = ((d.x < 0).to(torch.int32) * 4 + (d.y < 0).to(torch.int32) * 2
           + (d.z < 0).to(torch.int32))
    if sort_cells > 1 or sort_cells < -1:
        octant_major = sort_cells < 0
        # past 64 cells/axis the shifted key would pass the dead-lane value
        sort_cells = min(abs(sort_cells), 64)
        n_bits = max(1, math.ceil(math.log2(sort_cells)))
        cell = torch.zeros_like(key)
        for shift, c in ((2, o.x), (1, o.y), (0, o.z)):
            lo_ = c.min()
            ext = torch.clamp_min(c.max() - lo_, 1e-12)
            q = torch.clamp(((c - lo_) / ext * sort_cells).to(torch.int32),
                            0, sort_cells - 1)
            m = torch.zeros_like(q)
            for b in range(n_bits):               # Morton bit spread, stride 3
                m = m | (((q >> b) & 1) << (3 * b))
            cell = cell | (m << shift)
        key = (key << (3 * n_bits)) | cell if octant_major else (cell << 3) | key
    return torch.where(dead, 1 << 30, key)


BINNED_MIN_BINS = 64   # the JAX package's routing rule, kept as it is


def resolve_mesh_impl(mesh: MeshData, impl: str = "auto") -> str:
    """The BVH intersection a mesh takes: "auto" sends a mesh of
    ``BINNED_MIN_BINS`` bins (supers of 256 faces) or more to the binned
    pair pipeline and a smaller one to the per-ray traversal ("v2p").
    ``APTD_BINNED_MIN_BINS``, read at each call as in the JAX package,
    moves the threshold."""
    if impl != "auto":
        return impl
    if mesh is None or mesh.bvh is None:
        return "v2p"
    thresh = int(os.environ.get("APTD_BINNED_MIN_BINS", BINNED_MIN_BINS))
    return "binned" if mesh.bvh.n_supers_real >= thresh else "v2p"


def mesh_box(mesh: MeshData):
    """The mesh's bounding box as two host lists (lb, ub): two reads of the
    device, each counted as ``sync.mesh_box``."""
    with host_read("mesh_box"):
        lb = mesh.aabb_lb.tolist()
    with host_read("mesh_box"):
        ub = mesh.aabb_ub.tolist()
    return lb, ub


def mesh_t_cull(mesh: MeshData, o: Vec3, d: Vec3, t_g: torch.Tensor,
                ray_culling: bool = True,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-ray cull distance the BVH intersection starts from: the
    analytic-geom hit (the scene merge takes the mesh only on strictly
    smaller t), ``-inf`` for rays that miss the whole-mesh AABB (the scan
    path's unwidened gate, pathtrace.cu:258) and for inactive lanes."""
    t_cull = t_g
    neg_inf = float("-inf")
    if ray_culling:
        cull = ray_aabb_intersect_v(o, d, *mesh_box(mesh))
        t_cull = torch.where(cull, t_cull, neg_inf)
    if active is not None:
        t_cull = torch.where(active, t_cull, neg_inf)
    return t_cull


def _mesh_intersect_bvh(mesh: MeshData, o: Vec3, d: Vec3, t_cull, impl: str,
                        kernel_lanes: Optional[int]):
    # imported here: these modules build on this one (``_triangle_t``)
    from ..render import mesh_binned, mesh_kernel, mesh_kernel_v2p, mesh_kernel_v3
    if impl == "binned":
        return mesh_binned.mesh_intersect_binned(mesh.bvh, o, d, t_cull,
                                                 lanes=kernel_lanes)
    if impl in ("v2p", "v2s"):
        return mesh_kernel_v2p.mesh_intersect_bvh_v2p(
            mesh.bvh, o, d, t_cull, lanes=kernel_lanes, subtile=impl == "v2s")
    if impl == "v2":
        return mesh_kernel.mesh_intersect_bvh(mesh.bvh, o, d, t_cull,
                                              lanes=kernel_lanes)
    if impl == "v3":
        return mesh_kernel_v3.mesh_intersect_bvh_v3(mesh.bvh, o, d, t_cull)
    raise ValueError(f"mesh_kernel_impl={impl!r}")


def intersect_scene_v(geoms: Geoms, mesh: MeshData, o: Vec3, d: Vec3,
                      ray_culling: bool = True, face_chunk: int = 16,
                      use_bvh: Optional[bool] = None,
                      active: Optional[torch.Tensor] = None,
                      octant_sort: bool = False, sort_cells: int = 0,
                      kernel_lanes: Optional[int] = None,
                      kernel_impl: str = "auto"):
    """Closest-hit query (computeIntersections, pathtrace.cu:200-306).

    Analytic geoms first (first minimal t wins), then the mesh, which wins
    only on strictly smaller t.  Returns a dict of planes; t == -1 and
    material -1 on a miss.

    ``use_bvh``: send the mesh through its cluster hierarchy (default:
    whenever it carries one) instead of the dense scan behind the per-ray
    AABB gate.  ``kernel_impl`` picks the BVH intersection ("auto", "v2",
    "v2p", "v2s", "v3", "binned"; see ``resolve_mesh_impl``).  ``active``: per-ray
    liveness; dead lanes skip all BVH work.  ``octant_sort`` /
    ``sort_cells``: permute the rays by ``octant_cell_key`` before the
    traversal and back after it (a pure round trip; the binned pipeline
    packs rays itself and ignores it).  ``kernel_lanes`` is the rays per tile
    of the tile-gated traversal ("v2": its gating granule and CUDA block
    size, None = 1024); the other intersections accept and ignore it.
    """
    t_g, p_g, n_g, out_g, mat_g = intersect_geoms_v(geoms, o, d)
    if mesh.num_faces > 0:
        with span("render.intersect.mesh"):
            if use_bvh is None:
                use_bvh = mesh.bvh is not None
            if use_bvh and mesh.bvh is not None:
                impl = resolve_mesh_impl(mesh, kernel_impl)
                t_cull = mesh_t_cull(mesh, o, d, t_g, ray_culling, active)
                if octant_sort and impl != "binned":
                    key = octant_cell_key(o, d, t_cull == float("-inf"), sort_cells)
                    perm = torch.sort(key, stable=True).indices
                    t_s, p_s, n_s, mat_s = _mesh_intersect_bvh(
                        mesh, Vec3(o.x[perm], o.y[perm], o.z[perm]),
                        Vec3(d.x[perm], d.y[perm], d.z[perm]), t_cull[perm], impl,
                        kernel_lanes)
                    inv = torch.empty_like(perm)
                    inv[perm] = torch.arange(perm.numel(), device=perm.device)
                    t_m, mat_m = t_s[inv], mat_s[inv]
                    p_m = Vec3(p_s.x[inv], p_s.y[inv], p_s.z[inv])
                    n_m = Vec3(n_s.x[inv], n_s.y[inv], n_s.z[inv])
                else:
                    t_m, p_m, n_m, mat_m = _mesh_intersect_bvh(
                        mesh, o, d, t_cull, impl, kernel_lanes)
            else:
                t_m, p_m, n_m, mat_m = mesh_intersect_v(mesh, o, d, face_chunk)
                if ray_culling:
                    # per-ray AABB gate (pathtrace.cu:258)
                    cull = ray_aabb_intersect_v(o, d, *mesh_box(mesh))
                    t_m = torch.where(cull, t_m, float("inf"))
        mesh_wins = t_m < t_g
        t = torch.where(mesh_wins, t_m, t_g)
        point = vwhere(mesh_wins, p_m, p_g)
        normal = vwhere(mesh_wins, n_m, n_g)
        mat = torch.where(mesh_wins, mat_m, mat_g)
        # mesh hits count as outside (the triangle test leaves it untouched)
        outside = mesh_wins | out_g
    else:
        t, point, normal, mat, outside = t_g, p_g, n_g, mat_g, out_g

    miss = ~torch.isfinite(t)
    t = torch.where(miss, -1.0, t)
    mat = torch.where(miss, -1, mat)
    return dict(t=t, point=point, normal=normal.normalized_safe(),
                material_id=mat, is_inside=~outside & ~miss)


# ---------------------------------------------------------------------------
# AoS wrappers: the JAX package's (N, 3) API for tests and outside callers
# ---------------------------------------------------------------------------

def box_intersect(transform, inverse_transform, ray_o, ray_d):
    """(N, 3) wrapper over :func:`box_intersect_v`."""
    t, p, n, outside = box_intersect_v(transform, inverse_transform,
                                       Vec3.from_rows(ray_o), Vec3.from_rows(ray_d))
    return t, p.stack(), n.stack(), outside


def sphere_intersect(transform, inverse_transform, inv_transpose, ray_o, ray_d):
    """(N, 3) wrapper over :func:`sphere_intersect_v`."""
    t, p, n, outside = sphere_intersect_v(transform, inverse_transform, inv_transpose,
                                          Vec3.from_rows(ray_o), Vec3.from_rows(ray_d))
    return t, p.stack(), n.stack(), outside


def triangle_intersect(v, n, ray_o, ray_d):
    """Ray batch (N, 3) against face batch ``v``/``n`` (F, 3, 3) -> (N, F)
    t (-1 on a miss), (N, F, 3) points and unit normals, with the JAX
    function's barycentric weights."""
    o2 = Vec3(ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3])
    d2 = Vec3(ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3])
    v0, v1, v2 = (Vec3(v[None, :, c, 0], v[None, :, c, 1], v[None, :, c, 2])
                  for c in range(3))
    t, u, w, hit = _triangle_t(v0, v1, v2, o2, d2)
    u, w = u[..., None], w[..., None]
    point = u * v[None, :, 0] + w * v[None, :, 1] + (1 - u - w) * v[None, :, 2]
    nrm = (1 - u - w) * n[None, :, 0] + u * n[None, :, 1] + w * n[None, :, 2]
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    return torch.where(hit, t, -1.0), point, nrm


def ray_aabb_intersect(ray_o, ray_d, lb, ub):
    """(N, 3) wrapper over :func:`ray_aabb_intersect_v`."""
    return ray_aabb_intersect_v(Vec3.from_rows(ray_o), Vec3.from_rows(ray_d), lb, ub)


def intersect_scene(geoms: Geoms, mesh: MeshData, ray_o, ray_d,
                    ray_culling: bool = True, face_chunk: int = 16):
    """(N, 3) wrapper over :func:`intersect_scene_v`: dict(t, point, normal,
    material_id, is_inside) with (N, 3) vectors."""
    r = intersect_scene_v(geoms, mesh, Vec3.from_rows(ray_o), Vec3.from_rows(ray_d),
                          ray_culling, face_chunk)
    return dict(t=r["t"], point=r["point"].stack(), normal=r["normal"].stack(),
                material_id=r["material_id"], is_inside=r["is_inside"])
