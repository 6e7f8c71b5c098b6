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

import torch

from ..scene.structs import CUBE, Geoms, MeshData
from .vec3 import Vec3, where as vwhere, xform_dir, xform_point

_EPS_POINT = 1e-4       # getPointOnRay backoff (intersections.h:27-29)
_FLT_EPS = 1.1920929e-07
_BIG = 1e38


def box_intersect_v(transform, inverse_transform, o: Vec3, d: Vec3):
    """Ray planes vs one transformed unit cube.

    ``transform``/``inverse_transform``: (4,4) nested lists of floats.
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


def intersect_geoms_v(geoms: Geoms, o: Vec3, d: Vec3):
    """All rays vs all analytic geoms; min-t with first-geom tie-break
    (computeIntersections' running ``t_min > t`` loop, pathtrace.cu:230-254)."""
    transforms = geoms.transform.tolist()
    inverses = geoms.inverse_transform.tolist()
    inv_ts = geoms.inv_transpose.tolist()
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
    e1 = v1 - v0
    e2 = v2 - v0
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


def mesh_intersect_v(mesh: MeshData, o: Vec3, d: Vec3, chunk: int = 16):
    """Closest mesh hit by a dense scan over the real faces.

    Faces run in chunks of ``chunk`` broadcast against the ray planes
    ((chunk, N) tiles); within a chunk ``argmin`` picks the first minimal
    face, across chunks a strict ``<`` keeps the earlier one — overall the
    first minimal face, as in the JAX scan and the megakernel's loop.
    """
    f_real = mesh.num_faces
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
        vs, ns = mesh.vertices[lo:hi], mesh.normals[lo:hi]
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
        m_c = mesh.material_id[lo:hi][j]
        better = t_c < t_min
        t_min = torch.where(better, t_c, t_min)
        p_min = vwhere(better, Vec3(sel(p_full.x), sel(p_full.y), sel(p_full.z)), p_min)
        n_min = vwhere(better, Vec3(sel(n_full.x), sel(n_full.y), sel(n_full.z)), n_min)
        m_min = torch.where(better, m_c, m_min)
    normal = n_min.normalized_safe()
    mat = torch.where(torch.isfinite(t_min), m_min, -1)
    return t_min, p_min, normal, mat


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


def intersect_scene_v(geoms: Geoms, mesh: MeshData, o: Vec3, d: Vec3,
                      ray_culling: bool = True, face_chunk: int = 16):
    """Closest-hit query (computeIntersections, pathtrace.cu:200-306).

    Analytic geoms first (first minimal t wins), then the dense mesh scan
    gated by the per-ray AABB test, the mesh winning only on strictly
    smaller t.  Meshes that need the BVH raise (ROADMAP queue B).
    Returns a dict of planes; t == -1 and material -1 on a miss.
    """
    if mesh.needs_bvh:
        raise NotImplementedError(
            f"a mesh of {mesh.num_faces} faces needs the cluster BVH "
            "(ops/bvh.py), which the port does not have yet "
            "(ROADMAP queue B: ops/bvh.py and the mesh routing)")
    t_g, p_g, n_g, out_g, mat_g = intersect_geoms_v(geoms, o, d)
    if mesh.num_faces > 0:
        t_m, p_m, n_m, mat_m = mesh_intersect_v(mesh, o, d, face_chunk)
        if ray_culling:
            # per-ray AABB gate (pathtrace.cu:258)
            cull = ray_aabb_intersect_v(o, d, mesh.aabb_lb.tolist(),
                                        mesh.aabb_ub.tolist())
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
