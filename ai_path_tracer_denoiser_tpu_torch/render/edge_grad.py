"""Geometry gradients by silhouette edge sampling (counterpart of
render/edge_grad.py).

The renderer's radiance estimator is piecewise constant in geometry and
camera parameters: a path's contribution is a product of albedos times a
terminal emittance (wavefront._shade), so the geometric dependence is
*which* surfaces a path hits, a discrete event.  Autograd therefore gives
zero almost everywhere for d(image)/d(translation); the derivative of the
*expected* image lives on visibility boundaries.  This module estimates
that boundary term by sampling the object's silhouette curve explicitly
(edge sampling, applied to primary visibility):

    dJ/dtheta = interior term (autograd through the differentiable render)
              + (1/N_px) * oint_C (L_in - L_out) (v . n_out) ds

where C is the silhouette in image space, v = du/dtheta the image-space
velocity of the edge point, n_out the curve normal pointing out of the
object's image, and L_in/L_out the radiance just inside/outside the edge.

Scope, as in the JAX package: spheres of uniform scale (an exact circle
seen from a pinhole), cubes under any TRS (the closed polygon of edges
between front- and back-facing faces), triangle meshes (their silhouette
segments) and the camera's position.  The silhouette must not be
occluded; secondary visibility boundaries are not estimated.

How the JAX transforms map: ``jax.jacfwd`` over the parameter offset is
``torch.func.jacfwd``; the curve tangent (a map whose sample i depends on
parameter i alone) is one ``torch.func.jvp`` with a ones tangent;
``jax.grad`` of the interior term is ``torch.autograd.grad`` through
``trace_iteration(differentiable=True)``, whose Python bounce loop reads
live counts on the host and so cannot sit inside a ``torch.func``
transform.  Silhouette topology (which edges, which loop) is host numpy,
as in JAX.  No kernel runs here: the renders keep the plain wavefront and
the dense mesh scan.  Every gradient is a (3,) tensor on the scene's
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, jvp

from ..config import RenderOptions
from ..ops.intersect import intersect_scene_v
from ..ops.vec3 import Vec3
from ..scene.structs import CUBE, SPHERE, Camera, Geoms, MeshData, Scene
from .wavefront import _shade, init_render_state, trace_iteration

# Most lanes ``mean_radiance`` traces in one batch (iterations x rays).
MAX_BATCH_LANES = 1 << 21


# ---------------------------------------------------------------------------
# Ray-batch radiance (render arbitrary rays, not just pixels)
# ---------------------------------------------------------------------------

def _trace_lanes(scene: Scene, options: RenderOptions, ray_o: Vec3, ray_d: Vec3,
                 iteration, lane_ids: torch.Tensor) -> Vec3:
    """The bounce core of ``trace_iteration`` over arbitrary rays; lane i
    draws its noise as pixel ``lane_ids[i]`` of ``iteration`` (an int, or
    a tensor of one iteration per lane).  A bounce after every path has
    ended changes no colour, so the loop stops there."""
    n = ray_d.x.shape[0]
    color = Vec3.full_like(ray_d.x, 1.0)
    remaining = torch.full((n,), scene.trace_depth, dtype=torch.int32,
                           device=ray_d.x.device)
    o, d = ray_o, ray_d
    for _ in range(scene.trace_depth):
        isect = intersect_scene_v(scene.geoms, scene.mesh, o, d,
                                  ray_culling=options.ray_culling, use_bvh=False)
        o, d, color, remaining = _shade(scene, options, iteration, isect, d,
                                        color, remaining, lane_ids)
        if not bool((remaining > 0).any()):
            break
    return color


def trace_radiance(scene: Scene, options: RenderOptions,
                   ray_o: Vec3, ray_d: Vec3, iteration,
                   lane_offset: int = 0) -> Vec3:
    """Radiance along arbitrary rays: one 1-spp estimate per ray;
    ``iteration`` selects the RNG stream exactly like a frame iteration and
    ray i draws as pixel ``lane_offset + i``."""
    n = ray_d.x.shape[0]
    lane_ids = torch.arange(n, dtype=torch.int64, device=ray_d.x.device) + lane_offset
    return _trace_lanes(scene, options, ray_o, ray_d, iteration, lane_ids)


def mean_radiance(scene: Scene, options: RenderOptions,
                  ray_o: Vec3, ray_d: Vec3, spp: int,
                  lane_offset: int = 0) -> Vec3:
    """Monte-Carlo mean of ``trace_radiance`` over iterations 1 .. ``spp``.

    Traces up to ``MAX_BATCH_LANES`` lanes at once, each lane with its own
    iteration, then adds the iterations in order: every lane does the
    float32 operations of ``mean_radiance_loop``, so the two are equal bit
    for bit, and the device sees a few large launches in place of ``spp``
    times as many small ones.
    """
    n = ray_d.x.shape[0]
    dev = ray_d.x.device
    acc = Vec3.full_like(ray_d.x, 0.0)
    per = max(1, min(spp, MAX_BATCH_LANES // max(n, 1)))
    ids = torch.arange(n, dtype=torch.int64, device=dev) + lane_offset
    for first in range(1, spp + 1, per):
        k = min(per, spp + 1 - first)
        its = torch.arange(first, first + k, dtype=torch.int64,
                           device=dev).repeat_interleave(n)
        o, d = (Vec3(*(c.repeat(k) for c in v)) for v in (ray_o, ray_d))
        c = _trace_lanes(scene, options, o, d, its, ids.repeat(k))
        rows = [ch.reshape(k, n) for ch in c]
        for j in range(k):
            acc = acc + Vec3(rows[0][j], rows[1][j], rows[2][j])
    return Vec3(acc.x / float(spp), acc.y / float(spp), acc.z / float(spp))


def mean_radiance_loop(scene: Scene, options: RenderOptions,
                       ray_o: Vec3, ray_d: Vec3, spp: int,
                       lane_offset: int = 0) -> Vec3:
    """The plain version of ``mean_radiance`` (JAX's scan over iterations):
    one ``trace_radiance`` per iteration, added in order.  The reference
    the batch is held to; nothing else calls it."""
    acc = Vec3.full_like(ray_d.x, 0.0)
    for it in range(1, spp + 1):
        acc = acc + trace_radiance(scene, options, ray_o, ray_d, it, lane_offset)
    return Vec3(acc.x / float(spp), acc.y / float(spp), acc.z / float(spp))


# ---------------------------------------------------------------------------
# Differentiable moves of one geom / the mesh
# ---------------------------------------------------------------------------

def _at_add(a: torch.Tensor, key, value) -> torch.Tensor:
    """JAX's ``a.at[key].add(value)``: a new tensor, ``a`` is not written."""
    out = a.clone()
    out[key] = out[key] + value
    return out


def _at_set(a: torch.Tensor, key, value) -> torch.Tensor:
    """JAX's ``a.at[key].set(value)``: a new tensor, ``a`` is not written."""
    out = a.clone()
    out[key] = value
    return out


def translate_geom(geoms: Geoms, index: int, delta: torch.Tensor) -> Geoms:
    """Shift geom ``index`` by world-space ``delta`` (3,), differentiably.

    T' = Translate(delta) @ T, so transform[:3,3] += delta and the inverse
    picks up  T'^{-1} = T^{-1} @ Translate(-delta).
    """
    t = _at_add(geoms.transform, (index, slice(0, 3), 3), delta)
    shift = -geoms.inverse_transform[index, :, :3] @ delta       # (4,)
    inv = _at_add(geoms.inverse_transform, (index, slice(None), 3), shift)
    invt = _at_add(geoms.inv_transpose, (index, 3, slice(None)), shift)
    return dataclasses.replace(
        geoms, translation=_at_add(geoms.translation, index, delta),
        transform=t, inverse_transform=inv, inv_transpose=invt)


# ---------------------------------------------------------------------------
# Sphere silhouette geometry
# ---------------------------------------------------------------------------

def _orthobasis(dn: torch.Tensor):
    """Two unit vectors orthogonal to unit dn (smooth away from the flip)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dn.dtype, device=dn.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dn.dtype, device=dn.device)
    a = torch.where(dn[0].abs() < 0.9, ex, ey)
    e1 = torch.linalg.cross(dn, a)
    e1 = e1 / torch.linalg.vector_norm(e1)
    return e1, torch.linalg.cross(dn, e1)


def silhouette_points_sphere(center: torch.Tensor, radius, cam_pos: torch.Tensor,
                             phis: torch.Tensor) -> torch.Tensor:
    """(N, 3) points on the sphere's silhouette circle as seen from cam_pos.

    The set {x : (x-c).(x-o) = 0, |x-c| = r} is a circle of radius
    r*sqrt(1-(r/D)^2) centered at c - dn*r^2/D, D = |c-o|.
    """
    d = center - cam_pos
    dist = torch.linalg.vector_norm(d)
    dn = d / dist
    e1, e2 = _orthobasis(dn)
    cc = center - dn * (radius ** 2 / dist)
    rs = radius * torch.sqrt(1.0 - (radius / dist) ** 2)
    circ = (e1[None, :] * torch.cos(phis)[:, None]
            + e2[None, :] * torch.sin(phis)[:, None])
    return cc[None, :] + rs * circ


def project_to_pixels(x: torch.Tensor, camera: Camera,
                      position: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World points (N,3) -> continuous pixel coords (N,2), inverting the
    ray-gen mapping dir = view - right*plx*(px - w/2) - up*ply*(py - h/2)
    (generate_camera_rays_v; pathtrace.cu:168-173).

    Solves q = k*view - kX*right - kY*up exactly, so the scene file's
    ``up`` that is not orthogonalized against ``view`` (derive_camera) is
    handled.  ``position`` overrides the camera origin (camera moves).
    """
    w, h = camera.resolution
    dev = x.device
    pos = camera.position.to(dev) if position is None else position
    basis = torch.stack([camera.view, camera.right, camera.up], dim=1).to(dev)
    pl = camera.pixel_length.to(dev)
    q = x - pos[None, :]
    a = torch.linalg.solve(basis, q.T).T                          # (N, 3)
    px = w * 0.5 - a[:, 1] / (a[:, 0] * pl[0])
    py = h * 0.5 - a[:, 2] / (a[:, 0] * pl[1])
    return torch.stack([px, py], dim=-1)


def rays_through_pixels(camera: Camera, uv: torch.Tensor) -> Tuple[Vec3, Vec3]:
    """Camera rays through continuous pixel coords (N,2), no AA jitter."""
    dev = uv.device
    pos, view, right, up = (v.to(dev) for v in (camera.position, camera.view,
                                                 camera.right, camera.up))
    pl = camera.pixel_length.to(dev)
    w, h = camera.resolution
    X = pl[0] * (uv[:, 0] - w * 0.5)
    Y = pl[1] * (uv[:, 1] - h * 0.5)
    d = (view[None, :] - right[None, :] * X[:, None]
         - up[None, :] * Y[:, None])
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    n = uv.shape[0]
    o = Vec3(pos[0].expand(n), pos[1].expand(n), pos[2].expand(n))
    return o, Vec3(d[:, 0], d[:, 1], d[:, 2])


# ---------------------------------------------------------------------------
# Box silhouette geometry
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def box_silhouette_loop(geoms: Geoms, index: int,
                        cam_pos, object_space: bool = False) -> np.ndarray:
    """Ordered world-space vertices (m, 3) of a unit-cube geom's silhouette
    polygon as seen from ``cam_pos`` (object-space vertices when
    ``object_space``: the TRS-differentiable path applies the transform
    itself).

    A cube face (axis a, sign s) is front-facing iff the object-space
    camera satisfies s*oc[a] > 0.5; an edge of the cube lies on the
    silhouette iff its two adjacent faces differ in front-facing-ness.
    For any viewpoint outside the cube those edges form one closed loop of
    4 or 6 edges.  The loop is static topology for a fixed scene, built on
    the host in numpy and returned as ordered, non-repeating vertices.
    """
    inv = _host(geoms.inverse_transform[index]).astype(np.float64)
    m = _host(geoms.transform[index]).astype(np.float64)
    oc = (inv @ np.append(_host(cam_pos).astype(np.float64), 1.0))[:3]
    front = {(a, s): s * oc[a] > 0.5 for a in range(3) for s in (1, -1)}
    if not any(front.values()):
        raise ValueError("camera is inside the box; no silhouette")

    edges = []                   # [(p_obj, q_obj)] silhouette edges
    for a1 in range(3):
        for a2 in range(a1 + 1, 3):
            free = 3 - a1 - a2
            for s1 in (1, -1):
                for s2 in (1, -1):
                    if front[(a1, s1)] == front[(a2, s2)]:
                        continue
                    p = np.zeros(3)
                    p[a1], p[a2] = s1 * 0.5, s2 * 0.5
                    q = p.copy()
                    p[free], q[free] = -0.5, 0.5
                    edges.append((p, q))

    # Chain edges into the loop by matching endpoints.
    def key(v):
        return tuple(np.round(v * 2).astype(int))

    adj: dict = {}
    for i, (p, q) in enumerate(edges):
        adj.setdefault(key(p), []).append(i)
        adj.setdefault(key(q), []).append(i)
    loop = [edges[0][0], edges[0][1]]
    used = {0}
    while len(used) < len(edges):
        k = key(loop[-1])
        nxt = [i for i in adj[k] if i not in used]
        if not nxt:
            raise ValueError("silhouette edges do not form a closed loop")
        i = nxt[0]
        used.add(i)
        p, q = edges[i]
        loop.append(q if key(p) == k else p)
    verts_obj = np.stack(loop[:-1])            # closed: drop repeated start
    if object_space:
        return verts_obj.astype(np.float32)
    h = np.concatenate([verts_obj, np.ones((len(verts_obj), 1))], axis=1)
    return (h @ m.T)[:, :3].astype(np.float32)


def polygon_points(verts: torch.Tensor, phis: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear closed-polygon points for curve params phi in
    [0, 2pi), the box analogue of ``silhouette_points_sphere``.  Any
    piecewise-smooth parameterization integrates exactly (ds uses
    |du/dphi|); corners are measure-zero and never sampled (phis use
    half-offset midpoints)."""
    m = verts.shape[0]
    u = phis * (m / (2.0 * math.pi))
    k = torch.floor(u)
    f = u - k
    ki = torch.clamp(k.to(torch.int64), 0, m - 1)
    a = verts[ki % m]
    b = verts[(ki + 1) % m]
    return a + (b - a) * f[:, None]


# ---------------------------------------------------------------------------
# Mesh silhouette geometry
# ---------------------------------------------------------------------------

def mesh_silhouette_segments(mesh: MeshData, cam_pos):
    """Silhouette edge segments of a triangle mesh seen from ``cam_pos``.

    Returns numpy arrays (P, Q, W): segment endpoints (E, 3) and, per
    segment, the front-facing adjacent triangle's third vertex (E, 3), an
    'inward witness' whose projection marks the object side of the edge,
    used to orient the image-space outward normal per edge (a mesh
    silhouette need not be one convex loop).

    An interior edge (two adjacent faces) is on the silhouette iff its
    faces differ in front-facing-ness (geometric normals); a boundary
    edge of an open mesh is on it iff its single face is front-facing.
    """
    V = _host(mesh.vertices)[:mesh.num_faces].astype(np.float64)
    cam = _host(cam_pos).astype(np.float64)
    n = np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])
    cent = V.mean(axis=1)
    front = np.einsum("fk,fk->f", n, cam[None] - cent) > 0

    def vkey(v):
        return tuple(np.round(v * 4096.0).astype(np.int64))

    edges: dict = {}
    for f in range(V.shape[0]):
        for i in range(3):
            a, b = V[f, i], V[f, (i + 1) % 3]
            k = tuple(sorted((vkey(a), vkey(b))))
            edges.setdefault(k, []).append((f, i))
    P, Q, W = [], [], []

    def emit(f, i):
        P.append(V[f, i])
        Q.append(V[f, (i + 1) % 3])
        W.append(V[f, (i + 2) % 3])

    for faces in edges.values():
        if len(faces) == 1:
            f, i = faces[0]
            if front[f]:
                emit(f, i)
        else:
            (f1, i1), (f2, i2) = faces[0], faces[1]
            if front[f1] != front[f2]:
                emit(*(faces[0] if front[f1] else faces[1]))
    if not P:
        raise ValueError("mesh has no visible silhouette from this viewpoint")
    return (np.stack(P).astype(np.float32), np.stack(Q).astype(np.float32),
            np.stack(W).astype(np.float32))


def _edge_radiance_weight(scene: Scene, options: RenderOptions, uv: torch.Tensor,
                          n_img: torch.Tensor, ds: torch.Tensor, spp: int,
                          eps_px: float, lane_salt: int) -> torch.Tensor:
    """(L_in - L_out) * ds per sample, the mean radiance ``eps_px`` pixels
    inside and outside the edge; zero for samples outside the frame."""
    cam = scene.camera
    w, h = cam.resolution
    with torch.no_grad():
        o_in, d_in = rays_through_pixels(cam, uv - eps_px * n_img)
        o_out, d_out = rays_through_pixels(cam, uv + eps_px * n_img)
        l_in = mean_radiance(scene, options, o_in, d_in, spp,
                             lane_offset=lane_salt)
        l_out = mean_radiance(scene, options, o_out, d_out, spp,
                              lane_offset=lane_salt + (1 << 20))
    ldiff = (l_in.x + l_in.y + l_in.z - l_out.x - l_out.y - l_out.z) / 3.0
    inside = ((uv[:, 0] >= 0) & (uv[:, 0] <= w)
              & (uv[:, 1] >= 0) & (uv[:, 1] <= h))
    return torch.where(inside, ldiff * ds, 0.0)


def _unit_normals(tang: torch.Tensor) -> torch.Tensor:
    """The perpendicular (t_y, -t_x) of each image-space tangent, unit."""
    n_img = torch.stack([tang[:, 1], -tang[:, 0]], dim=-1)
    return n_img / torch.clamp_min(torch.linalg.vector_norm(n_img, dim=-1,
                                                            keepdim=True), 1e-12)


def _segment_boundary_term(scene: Scene, options: RenderOptions,
                           uv_fn, inward_uv: torch.Tensor,
                           n_edges: int, samples_per_edge: int,
                           spp: int, eps_px: float,
                           lane_salt: int = 0) -> torch.Tensor:
    """Boundary integral over E straight silhouette segments:
    sum_e  int_0^1 (L_in - L_out)(v . n_out) |du/dt| dt.

    ``uv_fn(delta, t)`` maps a (3,) parameter offset and per-sample
    fractions t (E*S,) to image points (E*S, 2); sample i lies on segment
    i // S at fraction t[i].  ``inward_uv`` (E*S, 2) are projected witness
    points on the object side of each edge; the outward normal is the
    tangent perpendicular oriented away from them.
    """
    w, h = scene.camera.resolution
    dev = scene.device
    s = samples_per_edge
    ts = ((torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s).repeat(n_edges)
    zero = torch.zeros(3, device=dev)

    uv = uv_fn(zero, ts)                                         # (E*S, 2)
    vel = jacfwd(lambda d: uv_fn(d, ts))(zero)                   # (E*S, 2, 3)
    # sample i depends only on t[i]: the jacobian's diagonal is one jvp
    tang = jvp(lambda t: uv_fn(zero, t), (ts,), (torch.ones_like(ts),))[1]
    ds = torch.linalg.vector_norm(tang, dim=-1)
    n_img = _unit_normals(tang)
    toward_obj = torch.sum((inward_uv - uv) * n_img, dim=-1)
    n_img = torch.where(toward_obj[:, None] > 0, -n_img, n_img)

    weight = _edge_radiance_weight(scene, options, uv, n_img, ds, spp, eps_px,
                                   lane_salt)
    vn = torch.einsum("nkd,nk->nd", vel, n_img)
    return (weight[:, None] * vn).sum(0) / (s * w * h)


def translate_mesh(mesh: MeshData, delta: torch.Tensor) -> MeshData:
    """MeshData with every vertex (and the AABB) moved by ``delta``.

    A pure translation is rigid, so an attached BVH shifts exactly: vertex
    columns of ``faces_packed`` and the lb/ub columns of every bounds level
    move by ``delta`` (normals and the tree topology are unchanged; padding
    nodes keep their dead-row can't-hit boxes).  No rebuild needed.  The
    tables are new tensors, so the kernels' derived caches (packed faces,
    root boxes) miss for them.
    """
    delta = torch.as_tensor(delta, dtype=torch.float32, device=mesh.vertices.device)
    bvh = mesh.bvh
    if bvh is not None:
        d9 = delta.repeat(3)                  # v0 v1 v2 xyz columns 0-8
        d6 = torch.cat([delta, delta])        # lb xyz | ub xyz columns 0-5
        cols9, cols6 = (slice(None), slice(0, 9)), (slice(None), slice(0, 6))
        bvh = dataclasses.replace(
            bvh,
            faces_packed=_at_add(bvh.faces_packed, cols9, d9[None, :]),
            cluster_bounds=_at_add(bvh.cluster_bounds, cols6, d6[None, :]),
            super_bounds=_at_add(bvh.super_bounds, cols6, d6[None, :]),
            hyper_bounds=_at_add(bvh.hyper_bounds, cols6, d6[None, :]))
    return dataclasses.replace(
        mesh, vertices=mesh.vertices + delta[None, None, :],
        aabb_lb=mesh.aabb_lb + delta, aabb_ub=mesh.aabb_ub + delta, bvh=bvh)


def _interior_gradient(scene: Scene, options: RenderOptions, moved) -> torch.Tensor:
    """d J / d delta at delta = 0 by autograd through one differentiable
    1-spp iteration of ``moved(delta)``, J the mean of its radiance.  Where
    the radiance does not depend on delta (diffuse shading: a product of
    albedos and an emittance) the gradient is zero, as ``jax.grad`` gives."""
    delta = torch.zeros(3, device=scene.device, requires_grad=True)
    sc = moved(delta)
    state = trace_iteration(sc, options, init_render_state(sc), differentiable=True)
    j = state.accum.mean()
    if not j.requires_grad:
        return torch.zeros(3, device=scene.device)
    (g,) = torch.autograd.grad(j, delta, allow_unused=True, materialize_grads=True)
    return g


def mesh_translation_gradient(scene: Scene, options: RenderOptions, *,
                              samples_per_edge: int = 8, spp: int = 128,
                              eps_px: float = 0.75,
                              include_interior: bool = True) -> torch.Tensor:
    """d(mean image)/d(translation of the scene's mesh), a (3,) tensor.

    Mesh vertices are pre-transformed world space (scene.cpp:266-318), so
    a mesh translation adds delta to every vertex; the silhouette segments
    ride along rigidly.
    """
    cam = scene.camera
    dev = scene.device
    p_np, q_np, w_np = mesh_silhouette_segments(scene.mesh, cam.position)
    P, Q = torch.from_numpy(p_np).to(dev), torch.from_numpy(q_np).to(dev)
    n_edges = P.shape[0]
    s = samples_per_edge
    wit = torch.from_numpy(w_np).to(dev).repeat_interleave(s, dim=0)
    a = P.repeat_interleave(s, dim=0)
    b = Q.repeat_interleave(s, dim=0)

    def uv_fn(delta, t):
        x = a + (b - a) * t[:, None] + delta
        return project_to_pixels(x, cam)

    inward_uv = project_to_pixels(wit, cam)
    boundary = _segment_boundary_term(scene, options, uv_fn, inward_uv,
                                      n_edges, s, spp, eps_px)
    if not include_interior:
        return boundary
    return boundary + _interior_gradient(scene, options, lambda d: dataclasses.replace(
        scene, mesh=translate_mesh(scene.mesh, d)))


def sphere_world_radius(geoms: Geoms, index: int) -> float:
    """Reference spheres are radius-0.5 unit spheres scaled by SCALE
    (intersections.h:112); uniform scale required for an exact circle."""
    s = _host(geoms.scale[index])
    if not (abs(s[0] - s[1]) < 1e-5 and abs(s[0] - s[2]) < 1e-5):
        raise ValueError(f"edge gradients need uniform sphere scale, got {s}")
    return 0.5 * float(s[0])


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

def _silhouette_boundary_term(scene: Scene, options: RenderOptions,
                              uv_fn, n_edge: int, spp: int, eps_px: float,
                              lane_salt: int = 0) -> torch.Tensor:
    """Edge integral (1/N_px) * oint (L_in - L_out)(v . n_out) ds for one
    closed silhouette curve.

    ``uv_fn(delta, phis)`` maps a (3,) parameter offset and curve
    parameters to image-space points (N, 2); the curve at delta=0 is the
    silhouette, and d(uv)/d(delta) is the edge velocity.  Point i depends
    on phis[i] alone, so the curve tangent is one jvp with a ones tangent
    (the JAX package maps a jacfwd over the points instead).
    """
    w, h = scene.camera.resolution
    dev = scene.device
    phis = (torch.arange(n_edge, dtype=torch.float32, device=dev) + 0.5) * (
        2.0 * math.pi / n_edge)
    zero = torch.zeros(3, device=dev)

    uv = uv_fn(zero, phis)                                       # (N, 2)
    vel = jacfwd(lambda d: uv_fn(d, phis))(zero)                 # (N, 2, 3)
    tang = jvp(lambda p: uv_fn(zero, p), (phis,), (torch.ones_like(phis),))[1]
    ds = torch.linalg.vector_norm(tang, dim=-1)                  # |du/dphi|
    # outward normal: perpendicular of the tangent, oriented away from the
    # projected-silhouette centroid
    n_img = _unit_normals(tang)
    outward = torch.sum((uv - uv.mean(dim=0, keepdim=True)) * n_img, dim=-1)
    n_img = torch.where(outward[:, None] < 0, -n_img, n_img)

    weight = _edge_radiance_weight(scene, options, uv, n_img, ds, spp, eps_px,
                                   lane_salt)
    vn = torch.einsum("nkd,nk->nd", vel, n_img)                  # (N, 3)
    return (2.0 * math.pi / n_edge) * (weight[:, None] * vn).sum(0) / (w * h)


def _geom_type(geoms: Geoms, index: int) -> int:
    return (geoms.type_tuple[index] if geoms.type_tuple
            else int(_host(geoms.type[index])))


def _unsupported(index: int, gtype: int):
    return ValueError("edge gradients support sphere and cube geoms; "
                      f"geom {index} has type {gtype}")


def translation_gradient(scene: Scene, options: RenderOptions,
                         geom_index: int, *,
                         n_edge: int = 512, spp: int = 128,
                         eps_px: float = 0.75,
                         include_interior: bool = True) -> torch.Tensor:
    """d(mean image)/d(translation of geom ``geom_index``), a (3,) tensor.

    J = mean over pixels and RGB of the expected radiance image.  The
    boundary term samples ``n_edge`` silhouette points, shoots ``spp``
    paths just inside and outside each (``eps_px`` pixels across the
    edge), and integrates (L_in - L_out)(v . n) ds in image space.
    """
    cam = scene.camera
    geoms = scene.geoms
    dev = scene.device
    cam_pos = cam.position.to(dev)
    gtype = _geom_type(geoms, geom_index)
    if gtype == SPHERE:
        radius = sphere_world_radius(geoms, geom_index)

        def uv_fn(delta, phis):
            center = geoms.translation[geom_index] + delta
            x = silhouette_points_sphere(center, radius, cam_pos, phis)
            return project_to_pixels(x, cam)
    elif gtype == CUBE:
        # Translating a TRS geom adds delta directly in world space
        # (world = T + R*S*x_obj), so the silhouette polygon rides along.
        verts = torch.from_numpy(box_silhouette_loop(geoms, geom_index, cam.position)).to(dev)

        def uv_fn(delta, phis):
            x = polygon_points(verts, phis) + delta
            return project_to_pixels(x, cam)
    else:
        raise _unsupported(geom_index, gtype)

    boundary = _silhouette_boundary_term(scene, options, uv_fn,
                                         n_edge, spp, eps_px)
    if not include_interior:
        return boundary
    return boundary + _interior_gradient(scene, options, lambda d: dataclasses.replace(
        scene, geoms=translate_geom(geoms, geom_index, d)))


def rotation_matrix_xyz_deg(rot: torch.Tensor) -> torch.Tensor:
    """Differentiable 3x3 R = Rx @ Ry @ Rz, angles in DEGREES XYZ order:
    the rotation block of build_transformation_matrix (utilities.cpp:44-51,
    scene/structs.py)."""
    r = rot * (math.pi / 180.0)
    cx, sx = torch.cos(r[0]), torch.sin(r[0])
    cy, sy = torch.cos(r[1]), torch.sin(r[1])
    cz, sz = torch.cos(r[2]), torch.sin(r[2])
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(*rows):
        return torch.stack([torch.stack(row) for row in rows])

    rx = mat((one, zero, zero), (zero, cx, -sx), (zero, sx, cx))
    ry = mat((cy, zero, sy), (zero, one, zero), (-sy, zero, cy))
    rz = mat((cz, -sz, zero), (sz, cz, zero), (zero, zero, one))
    return rx @ ry @ rz


def retrs_geom(geoms: Geoms, index: int, drot: torch.Tensor,
               dscale: torch.Tensor) -> Geoms:
    """Geoms with geom ``index``'s transform rebuilt at (rotation + drot,
    scale + dscale), differentiably (4x4 compose, float32 inverse).

    The translation path keeps :func:`translate_geom` (exact sparse
    update); rotation/scale need the full rebuild because they change the
    3x3 block and its inverse non-trivially.
    """
    rot = geoms.rotation[index] + drot
    scl = geoms.scale[index] + dscale
    r3 = rotation_matrix_xyz_deg(rot)
    m3 = r3 * scl[None, :]                       # R @ diag(s)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=m3.device)
    m = torch.cat([torch.cat([m3, geoms.translation[index][:, None]], dim=1), bottom])
    inv = torch.linalg.inv(m)
    return dataclasses.replace(
        geoms,
        rotation=_at_set(geoms.rotation, index, rot),
        scale=_at_set(geoms.scale, index, scl),
        transform=_at_set(geoms.transform, index, m),
        inverse_transform=_at_set(geoms.inverse_transform, index, inv),
        inv_transpose=_at_set(geoms.inv_transpose, index, inv.T))


def trs_gradient(scene: Scene, options: RenderOptions, geom_index: int,
                 param: str, *, n_edge: int = 512, spp: int = 128,
                 eps_px: float = 0.75,
                 include_interior: bool = True) -> torch.Tensor:
    """d(mean image)/d(ROTAT or SCALE of geom ``geom_index``), (3,).

    Translations are :func:`translation_gradient`; rotations and scales
    take the same boundary machinery with another edge-point velocity:

      world(delta) = T + R(rot + drot) ((scale + dscale) .* x_obj)

    with the object-space silhouette held fixed for cubes (the active edge
    set is piecewise constant; flips are measure-zero) and re-derived
    inside the differentiable map for spheres (the unit sphere's
    silhouette circle depends on the object-space camera, which moves
    under rotation/scale).  The interior term is autograd through the
    differentiable render with :func:`retrs_geom`: rotating or scaling
    changes shading normals and hit points continuously.
    """
    if param not in ("rotate", "scale"):
        raise ValueError(f"param must be 'rotate' or 'scale', got {param!r}")
    cam = scene.camera
    geoms = scene.geoms
    dev = scene.device
    cam_pos = cam.position.to(dev)
    gtype = _geom_type(geoms, geom_index)
    T = geoms.translation[geom_index]
    rot0 = geoms.rotation[geom_index]
    scl0 = geoms.scale[geom_index]

    def split(delta):
        """(drot, dscale) of a parameter offset."""
        zero = torch.zeros(3, device=dev)
        return (delta, zero) if param == "rotate" else (zero, delta)

    def world_map(delta, x_obj):
        drot, dscl = split(delta)
        r3 = rotation_matrix_xyz_deg(rot0 + drot)
        return T[None, :] + (x_obj * (scl0 + dscl)[None, :]) @ r3.T

    if gtype == SPHERE:
        def uv_fn(delta, phis):
            drot, dscl = split(delta)
            r3 = rotation_matrix_xyz_deg(rot0 + drot)
            # object-space camera of the TRS'd unit sphere (radius 0.5,
            # intersections.h:112): oc = S^-1 R^T (cam - T)
            oc = (r3.T @ (cam_pos - T)) / (scl0 + dscl)
            c = silhouette_points_sphere(torch.zeros(3, device=dev), 0.5, oc, phis)
            return project_to_pixels(world_map(delta, c), cam)
    elif gtype == CUBE:
        verts_obj = torch.from_numpy(box_silhouette_loop(
            geoms, geom_index, cam.position, object_space=True)).to(dev)

        def uv_fn(delta, phis):
            x_obj = polygon_points(verts_obj, phis)
            return project_to_pixels(world_map(delta, x_obj), cam)
    else:
        raise _unsupported(geom_index, gtype)

    boundary = _silhouette_boundary_term(scene, options, uv_fn,
                                         n_edge, spp, eps_px)
    if not include_interior:
        return boundary
    return boundary + _interior_gradient(scene, options, lambda d: dataclasses.replace(
        scene, geoms=retrs_geom(geoms, geom_index, *split(d))))


def rotation_gradient(scene, options, geom_index: int, **kw) -> torch.Tensor:
    """d(mean image)/d(ROTAT degrees of geom ``geom_index``), (3,)."""
    return trs_gradient(scene, options, geom_index, "rotate", **kw)


def scale_gradient(scene, options, geom_index: int, **kw) -> torch.Tensor:
    """d(mean image)/d(SCALE of geom ``geom_index``), (3,)."""
    return trs_gradient(scene, options, geom_index, "scale", **kw)


def camera_translation_gradient(scene: Scene, options: RenderOptions, *,
                                geom_indices: Optional[Tuple[int, ...]] = None,
                                n_edge: int = 512, spp: int = 128,
                                eps_px: float = 0.75) -> torch.Tensor:
    """d(mean image)/d(camera position), a (3,) tensor.

    Every visibility silhouette moves when the camera moves; this sums the
    boundary terms of the silhouettes of the given geoms (default: every
    uniform-scale sphere plus every cube whose silhouette is visible).
    Sphere silhouettes slide on the surface as the camera moves; a cube's
    silhouette edges are fixed on the cube (the active edge set is
    piecewise constant in camera position), so only the projection
    varies.  Material-boundary curves are not sampled: exact only when
    those curves separate regions of equal radiance.
    """
    cam = scene.camera
    geoms = scene.geoms
    dev = scene.device
    if geom_indices is None:
        types = _host(geoms.type)
        scales = _host(geoms.scale)
        geom_indices = []
        for i in range(len(types)):
            if types[i] == SPHERE and float(np.ptp(scales[i])) < 1e-6:
                geom_indices.append(int(i))
            elif types[i] == CUBE:
                try:
                    box_silhouette_loop(geoms, i, cam.position)
                    geom_indices.append(int(i))
                except ValueError:
                    pass                      # camera inside -> no silhouette
        geom_indices = tuple(geom_indices)
    base_pos = cam.position.to(dev)
    total = torch.zeros(3, device=dev)
    for k, gi in enumerate(geom_indices):
        if _geom_type(geoms, gi) == SPHERE:
            radius = sphere_world_radius(geoms, gi)
            center = geoms.translation[gi]

            def uv_fn(delta, phis, center=center, radius=radius):
                pos = base_pos + delta
                x = silhouette_points_sphere(center, radius, pos, phis)
                return project_to_pixels(x, cam, position=pos)
        else:
            verts = torch.from_numpy(box_silhouette_loop(geoms, gi, cam.position)).to(dev)

            def uv_fn(delta, phis, verts=verts):
                pos = base_pos + delta
                x = polygon_points(verts, phis)
                return project_to_pixels(x, cam, position=pos)

        total = total + _silhouette_boundary_term(
            scene, options, uv_fn, n_edge, spp, eps_px,
            lane_salt=k * (1 << 21))
    return total
