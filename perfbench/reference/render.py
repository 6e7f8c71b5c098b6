"""Plain reference of one 1-spp G-buffer frame, in float32 PyTorch.

A frozen, self-contained statement of what the path tracer computes for a
frame of the interactive loop: the scene text and its OBJ mesh parsed
again, the orbit camera rebuilt from the frame's angle, and for a chosen
set of pixels the camera ray (with its anti-aliasing jitter), the closest
hit against the analytic geoms and every face of the mesh (a dense scan,
no hierarchy), the BSDF scatter with the minstd noise keyed on (iteration,
pixel, remaining bounces), and the 10 G-buffer channels: radiance, the
first hit's normal and distance, and the throughput after the first shade.

It imports nothing of the program.  Pixels are independent (the noise is
keyed per pixel), so any subset of a frame can be traced on its own.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple

import numpy as np
import torch

SPHERE, CUBE = 0, 1
_EPS_POINT = 1e-4
_FLT_EPS = 1.1920929e-07
_BIG = 1e38
_MASK = 0xFFFFFFFF
_LCG_M = 2147483647
_SQRT_ONE_THIRD = 0.5773502691896258
_TWO_PI = 6.283185307179586


# ---------------------------------------------------------------- vectors

class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V3(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def normalized(self):
        inv = torch.rsqrt(self.dot(self))
        return V3(self.x * inv, self.y * inv, self.z * inv)

    def normalized_safe(self):
        n2 = self.dot(self)
        pos = n2 > 0
        inv = torch.where(pos, torch.rsqrt(torch.where(pos, n2, 1.0)), 1.0)
        return V3(self.x * inv, self.y * inv, self.z * inv)


def _full(like, value):
    f = torch.full_like(like, value)
    return V3(f, f, f)


def _sel(c, a: V3, b: V3) -> V3:
    return V3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y),
              torch.where(c, a.z, b.z))


def _xp(m, p: V3) -> V3:
    return V3(m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
              m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
              m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3])


def _xd(m, d: V3) -> V3:
    return V3(m[0][0] * d.x + m[0][1] * d.y + m[0][2] * d.z,
              m[1][0] * d.x + m[1][1] * d.y + m[1][2] * d.z,
              m[2][0] * d.x + m[2][1] * d.y + m[2][2] * d.z)


# ---------------------------------------------------------------- scene

def _trs_matrix(t, r, s) -> np.ndarray:
    """T * Rx * Ry * Rz * S, rotations in degrees, float64 then float32."""
    r = np.radians(np.asarray(r, np.float64))
    cx, sx = math.cos(r[0]), math.sin(r[0])
    cy, sy = math.cos(r[1]), math.sin(r[1])
    cz, sz = math.cos(r[2]), math.sin(r[2])
    rx = np.array([[1, 0, 0, 0], [0, cx, -sx, 0], [0, sx, cx, 0], [0, 0, 0, 1]], np.float64)
    ry = np.array([[cy, 0, sy, 0], [0, 1, 0, 0], [-sy, 0, cy, 0], [0, 0, 0, 1]], np.float64)
    rz = np.array([[cz, -sz, 0, 0], [sz, cz, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    tm = np.eye(4)
    tm[:3, 3] = t
    sm = np.diag(list(s) + [1.0])
    return (tm @ rx @ ry @ rz @ sm).astype(np.float32)


def parse_obj(path: str, transform: np.ndarray):
    """Triangles of an OBJ file (polygons fanned) in world space:
    (vertices (F,3,3), normals (F,3,3)) float32; file normals normalised,
    geometric ones where a face gives none."""
    pos, nrm, fp, fn = [], [], [], []
    with open(path) as f:
        for raw in f:
            parts = raw.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                pos.append([float(v) for v in parts[1:4]])
            elif parts[0] == "vn":
                nrm.append([float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                refs = []
                for ref in parts[1:]:
                    c = ref.split("/")
                    refs.append((int(c[0]), int(c[2]) if len(c) == 3 and c[2] else None))
                for k in range(1, len(refs) - 1):
                    tri = (refs[0], refs[k], refs[k + 1])
                    fp.append([r[0] for r in tri])
                    fn.append([r[1] for r in tri] if all(r[1] is not None for r in tri)
                              else [0, 0, 0])
    pos = np.asarray(pos, np.float64)
    nrm = np.asarray(nrm, np.float64).reshape(-1, 3)
    fp = np.asarray(fp, np.int64)
    fn = np.asarray(fn, np.int64)
    fp = np.where(fp > 0, fp - 1, len(pos) + fp)
    p = pos[fp]                                               # (F, 3, 3)
    ph = np.concatenate([p, np.ones(p.shape[:2] + (1,))], axis=2) @ \
        np.asarray(transform, np.float64).T
    verts = ph[..., :3]
    has_n = (fn != 0).all(axis=1) & (len(nrm) > 0)
    normals = np.zeros_like(verts)
    if has_n.any():
        idx = np.where(fn > 0, fn - 1, len(nrm) + fn)[has_n]
        n = nrm[idx]
        lens = np.linalg.norm(n, axis=2, keepdims=True)
        normals[has_n] = n / np.where(lens == 0, 1.0, lens)
    if (~has_n).any():
        v = verts[~has_n]
        g = np.cross(v[:, 2] - v[:, 0], v[:, 1] - v[:, 0])
        ln = np.linalg.norm(g, axis=1, keepdims=True)
        g = np.where(ln > 0, g / np.where(ln > 0, ln, 1.0), g)
        normals[~has_n] = g[:, None, :]
    return verts.astype(np.float32), normals.astype(np.float32)


def derive_camera(res, fovy, eye, look_at, up):
    """Camera vectors as scene.cpp derives them, float32 numpy."""
    w, h = res
    yscaled = math.tan(fovy * (math.pi / 180.0))
    xscaled = (yscaled * w) / h
    eye, look_at, up = (np.asarray(v, np.float32) for v in (eye, look_at, up))
    view = look_at - eye
    view = view / np.linalg.norm(view)
    right = np.cross(view, up)
    right = right / np.linalg.norm(right)
    return {"position": eye, "look_at": look_at, "view": view, "up": up,
            "right": right, "resolution": (int(w), int(h)), "fovy": fovy,
            "pixel_length": np.array([2 * xscaled / w, 2 * yscaled / h], np.float32)}


def parse_scene(path: str) -> Dict:
    """The scene file's materials, geoms, mesh and camera."""
    lines = open(path).read().replace("\r\n", "\n").replace("\r", "\n").split("\n")
    base = os.path.dirname(os.path.abspath(path))
    mats, geoms, meshes, cam, depth = [], [], [], None, 8
    i = 0

    def block(i):
        out = []
        while i < len(lines) and lines[i].strip():
            out.append(lines[i].split())
            i += 1
        return out, i

    keys = {"REFL": "refl", "REFR": "refr", "REFRIOR": "ior", "EMITTANCE": "emit"}
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("//"):
            continue
        head = line.split()[0]
        if head == "MATERIAL":
            rec = {"color": (0, 0, 0), "spec": (0, 0, 0), "refl": 0.0, "refr": 0.0,
                   "ior": 0.0, "emit": 0.0}
            for t in (lines[i + k].split() for k in range(7)):
                if t and t[0] == "RGB":
                    rec["color"] = tuple(map(float, t[1:4]))
                elif t and t[0] == "SPECRGB":
                    rec["spec"] = tuple(map(float, t[1:4]))
                elif t and t[0] in keys:
                    rec[keys[t[0]]] = float(t[1])
            i += 7
            mats.append(rec)
        elif head in ("OBJECT", "MESH"):
            rec = {"t": (0, 0, 0), "r": (0, 0, 0), "s": (1, 1, 1)}
            first, second = lines[i].split(), lines[i + 1].split()
            i += 2
            if head == "OBJECT":
                rec["type"] = SPHERE if first[0] == "sphere" else CUBE
            else:
                rec["path"] = first[1]
            rec["mat"] = int(second[1])
            body, i = block(i)
            for t in body:
                k = {"TRANS": "t", "ROTAT": "r", "SCALE": "s"}.get(t[0])
                if k:
                    rec[k] = tuple(map(float, t[1:4]))
            (geoms if head == "OBJECT" else meshes).append(rec)
        elif head == "CAMERA":
            res, fovy = (800, 800), 45.0
            for t in (lines[i + k].split() for k in range(5)):
                if t and t[0] == "RES":
                    res = (int(t[1]), int(t[2]))
                elif t and t[0] == "FOVY":
                    fovy = float(t[1])
                elif t and t[0] == "DEPTH":
                    depth = int(t[1])
            i += 5
            body, i = block(i)
            v = {t[0]: tuple(map(float, t[1:4])) for t in body}
            cam = (res, fovy, v.get("EYE", (0, 0, 0)), v.get("LOOKAT", (0, 0, 0)),
                   v.get("UP", (0, 1, 0)))
    g_m = [_trs_matrix(g["t"], g["r"], g["s"]) for g in geoms]
    g_inv = [np.linalg.inv(m.astype(np.float64)) for m in g_m]
    vs, ns, ms = [], [], []
    for m in meshes:
        p = m["path"] if os.path.isabs(m["path"]) else os.path.join(base, m["path"])
        v, n = parse_obj(p, _trs_matrix(m["t"], m["r"], m["s"]))
        vs.append(v)
        ns.append(n)
        ms.append(np.full(len(v), m["mat"], np.int32))
    mesh = None
    if vs:
        v = np.concatenate(vs)
        mesh = {"vertices": v, "normals": np.concatenate(ns),
                "material": np.concatenate(ms),
                "lb": v.reshape(-1, 3).min(0), "ub": v.reshape(-1, 3).max(0)}
    return {
        "materials": {k: np.asarray([mm[k] for mm in mats], np.float32)
                      for k in ("color", "spec", "refl", "refr", "ior", "emit")},
        "geoms": [{"type": g["type"], "mat": g["mat"], "m": m,
                   "inv": inv.astype(np.float32), "inv_t": inv.T.astype(np.float32)}
                  for g, m, inv in zip(geoms, g_m, g_inv)],
        "mesh": mesh, "camera": derive_camera(*cam), "depth": depth}


def orbit_start(camera) -> tuple:
    """(phi, theta, zoom) of the scene's camera (main.cpp:66-78)."""
    view = camera["view"]
    xz = np.array([view[0], 0.0, view[2]])
    zy = np.array([0.0, view[1], view[2]])
    phi = math.acos(float(np.dot(xz / np.linalg.norm(xz), [0, 0, -1])))
    theta = math.acos(float(np.dot(zy / np.linalg.norm(zy), [0, 1, 0])))
    zoom = float(np.linalg.norm(camera["position"] - camera["look_at"]))
    return phi, theta, zoom


def orbit(camera, phi: float, theta: float, zoom: float) -> Dict:
    """The orbit camera (main.cpp:126-138): right and up unnormalised."""
    look_at = torch.from_numpy(camera["look_at"].copy())
    offset = torch.tensor([zoom * math.sin(phi) * math.sin(theta), zoom * math.cos(theta),
                           zoom * math.cos(phi) * math.sin(theta)], dtype=torch.float32)
    view = -offset / torch.linalg.vector_norm(offset)
    right = torch.linalg.cross(view, torch.tensor([0.0, 1.0, 0.0]))
    up = torch.linalg.cross(right, view)
    return dict(camera, position=offset + look_at, view=view, right=right, up=up,
                pixel_length=torch.from_numpy(camera["pixel_length"].copy()))


# ---------------------------------------------------------------- noise

def _hash(a):
    a = a & _MASK
    a = ((a + 0x7ED55D16) + (a << 12)) & _MASK
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & _MASK
    a = ((a + 0x165667B1) + (a << 5)) & _MASK
    a = ((a + 0xD3A2646C) ^ (a << 9)) & _MASK
    a = ((a + 0xFD7046C5) + (a << 3)) & _MASK
    return ((a ^ 0xB55A4F09) ^ (a >> 16)) & _MASK


def uniforms(iteration: int, pixel: torch.Tensor, depth, n: int):
    """n minstd uniforms per pixel from the engine seeded by
    hash((1<<31) | depth<<22 | iteration) ^ hash(pixel)."""
    pixel = pixel.to(torch.int64) & _MASK
    if not isinstance(depth, torch.Tensor):
        depth = torch.full_like(pixel, int(depth))
    depth = depth.to(torch.int64) & _MASK
    h = _hash((1 << 31) | ((depth << 22) & _MASK) | (iteration & _MASK)) ^ _hash(pixel)
    state = h % _LCG_M
    state = torch.where(state == 0, torch.ones_like(state), state)
    inv_m = torch.tensor(1.0 / _LCG_M, dtype=torch.float32, device=pixel.device)
    out = []
    for _ in range(n):
        state = (state * 48271) % _LCG_M
        out.append(state.to(torch.float32) * inv_m)
    return out


# ---------------------------------------------------------------- hits

def _entries(m: np.ndarray):
    t = torch.from_numpy(np.ascontiguousarray(m))
    return [list(row.unbind()) for row in t.unbind()]


def _box(m, inv, o: V3, d: V3):
    qo, qd = _xp(inv, o), _xd(inv, d).normalized()
    axes = []
    for a, b in ((qo.x, qd.x), (qo.y, qd.y), (qo.z, qd.z)):
        t1, t2 = (-0.5 - a) / b, (0.5 - a) / b
        ta, tb = torch.minimum(t1, t2), torch.maximum(t1, t2)
        one = torch.ones_like(t1)
        axes.append((torch.where(ta > 0, ta, -_BIG), tb, torch.where(t2 < t1, one, -one)))
    (ta0, tb0, s0), (ta1, tb1, s1), (ta2, tb2, s2) = axes
    tmin = torch.maximum(torch.maximum(ta0, ta1), ta2)
    tmax = torch.minimum(torch.minimum(tb0, tb1), tb2)
    z = torch.zeros_like(tmin)
    a0 = ta0 >= tmin
    a1 = ~a0 & (ta1 >= tmin)
    a2 = ~(a0 | a1)
    b0 = tb0 <= tmax
    b1 = ~b0 & (tb1 <= tmax)
    b2 = ~(b0 | b1)
    n_min = V3(torch.where(a0, s0, z), torch.where(a1, s1, z), torch.where(a2, s2, z))
    n_max = V3(torch.where(b0, s0, z), torch.where(b1, s1, z), torch.where(b2, s2, z))
    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = torch.where(inside, tmax, tmin)
    point = _xp(m, qo + qd * (t_obj - _EPS_POINT))
    normal = _xd(m, _sel(inside, n_max, n_min)).normalized()
    diff = o - point
    return torch.where(hit, torch.sqrt(diff.dot(diff)), -1.0), point, normal


def _sphere(m, inv, inv_t, o: V3, d: V3):
    ro, rd = _xp(inv, o), _xd(inv, d).normalized()
    vd = ro.dot(rd)
    rad = vd * vd - (ro.dot(ro) - 0.25)
    sq = torch.sqrt(torch.clamp_min(rad, 0.0))
    t1, t2 = -vd + sq, -vd - sq
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    hit = (rad >= 0) & ~((t1 < 0) & (t2 < 0))
    obj_point = ro + rd * (t_obj - _EPS_POINT)
    point = _xp(m, obj_point)
    normal = _xd(inv_t, obj_point).normalized()
    normal = _sel(both_pos, normal, -normal)
    diff = o - point
    return torch.where(hit, torch.sqrt(diff.dot(diff)), -1.0), point, normal


def _mesh_scan(mesh, o: V3, d: V3):
    """First minimal face over the whole mesh (Moller-Trumbore, glm's
    one-sided test) for every ray, faces in chunks of about 16M tests."""
    dev = o.x.device
    chunk = max(16, (1 << 24) // max(o.x.numel(), 1))
    t_min = torch.full_like(o.x, float("inf"))
    p_min, n_min = _full(o.x, 0.0), _full(o.x, 0.0)
    m_min = torch.full(o.x.shape, -1, dtype=torch.int32, device=dev)
    o2, d2 = V3(*(c[None] for c in o)), V3(*(c[None] for c in d))
    for lo in range(0, mesh["vertices"].shape[0], chunk):
        vs, ns = mesh["vertices"][lo:lo + chunk], mesh["normals"][lo:lo + chunk]
        v0, v1, v2 = (V3(*(vs[:, c, k][:, None] for k in range(3))) for c in range(3))
        e1, e2 = v1 - v0, v2 - v0
        p = d2.cross(e2)
        a = e1.dot(p)
        f = 1.0 / a
        s = o2 - v0
        u = f * s.dot(p)
        q = s.cross(e1)
        w = f * d2.dot(q)
        t = f * e2.dot(q)
        hit = (a >= _FLT_EPS) & (u >= 0) & (u <= 1) & (w >= 0) & (u + w <= 1) & (t >= 0)
        t = torch.where(hit & (t > 0.0), t, float("inf"))
        t_c, j = torch.min(t, dim=0)
        jj = j[None]

        def pick(a_):
            return torch.gather(a_.expand(t.shape), 0, jj)[0]

        n0, n1, n2 = (V3(*(ns[:, c, k][:, None] for k in range(3))) for c in range(3))
        v = 1.0 - u - w
        pf = v0 * u + v1 * w + v2 * v
        nf = n0 * v + n1 * u + n2 * w
        better = t_c < t_min
        t_min = torch.where(better, t_c, t_min)
        p_min = _sel(better, V3(pick(pf.x), pick(pf.y), pick(pf.z)), p_min)
        n_min = _sel(better, V3(pick(nf.x), pick(nf.y), pick(nf.z)), n_min)
        m_min = torch.where(better, mesh["material"][lo:lo + chunk][j], m_min)
    return t_min, p_min, n_min.normalized_safe(), m_min


def _aabb(o: V3, d: V3, lb, ub):
    tmin = torch.full_like(o.x, -float("inf"))
    tmax = torch.full_like(o.x, float("inf"))
    for oc, dc, lo, hi in zip(o, d, lb, ub):
        inv = 1.0 / dc
        t1, t2 = (lo - oc) * inv, (hi - oc) * inv
        tmin = torch.maximum(tmin, torch.minimum(t1, t2))
        tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    return (tmax >= 0) & (tmin <= tmax)


def intersect(scene, dev_mesh, o: V3, d: V3, active=None):
    """Closest hit: the analytic geoms in order (first minimal t wins),
    then the mesh, which wins only on a strictly smaller t.  The mesh is
    scanned for the rays that meet its bounding box (the scan's own gate)
    and are still ``active``; the others keep the geoms' hit."""
    t_b = torch.full_like(o.x, float("inf"))
    p_b, n_b = _full(o.x, 0.0), _full(o.x, 0.0)
    m_b = torch.full(o.x.shape, -1, dtype=torch.int32, device=o.x.device)
    for g in scene["geoms"]:
        m, inv = _entries(g["m"]), _entries(g["inv"])
        if g["type"] == CUBE:
            t, p, n = _box(m, inv, o, d)
        else:
            t, p, n = _sphere(m, inv, _entries(g["inv_t"]), o, d)
        t = torch.where(t > 0.0, t, float("inf"))
        better = t < t_b
        t_b = torch.where(better, t, t_b)
        p_b, n_b = _sel(better, p, p_b), _sel(better, n, n_b)
        m_b = torch.where(better, g["mat"], m_b)
    if dev_mesh is not None:
        gate = _aabb(o, d, dev_mesh["lb"], dev_mesh["ub"])
        if active is not None:
            gate = gate & active
        idx = torch.nonzero(gate).flatten()
        if idx.numel():
            t_m, p_m, n_m, m_m = _mesh_scan(dev_mesh, V3(*(c[idx] for c in o)),
                                            V3(*(c[idx] for c in d)))
            wins = t_m < t_b[idx]
            t_b[idx] = torch.where(wins, t_m, t_b[idx])
            p_b = V3(*(c.index_put((idx,), torch.where(wins, cm, c[idx]))
                       for c, cm in zip(p_b, p_m)))
            n_b = V3(*(c.index_put((idx,), torch.where(wins, cm, c[idx]))
                       for c, cm in zip(n_b, n_m)))
            m_b[idx] = torch.where(wins, m_m, m_b[idx])
    miss = ~torch.isfinite(t_b)
    return (torch.where(miss, -1.0, t_b), p_b, n_b.normalized_safe(),
            torch.where(miss, -1, m_b))


# ---------------------------------------------------------------- shading

def _scatter(d: V3, point: V3, normal: V3, mat, u1, u2):
    """Schlick-Fresnel specular/refractive or cosine-weighted diffuse
    scatter (interactions.h:194-258)."""
    spec = (mat["refl"] != 0.0) | (mat["refr"] != 0.0)
    cosine = d.normalized().dot(normal)
    entering = cosine <= 0
    n_ref = _sel(entering, normal, -normal)
    ratio = torch.where(entering, 1.0 / mat["ior"], mat["ior"])
    dn = d.normalized().dot(n_ref)
    can_refract = 1.0 - ratio * ratio * (1.0 - dn * dn) > 0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    om = 1.0 - cosine.abs()
    p5 = om * om
    p5 = p5 * p5 * om
    prob = torch.where(can_refract, r0 + (1.0 - r0) * p5, torch.ones_like(ratio))
    do_reflect = u1 < prob
    refl = (d - normal * (2.0 * normal.dot(d))).normalized()
    dt = n_ref.dot(d)
    k = 1.0 - ratio * ratio * (1.0 - dt * dt)
    ok = k >= 0
    raw = d * ratio - n_ref * (ratio * dt + torch.sqrt(torch.clamp_min(k, 0.0)))
    raw = _sel(ok, raw, _full(k, 0.0))
    refr = _sel(ok, _sel(ok, raw, refl).normalized_safe(), refl)
    spec_dir = _sel(do_reflect, refl, refr)
    spec_col = _sel(do_reflect | ~ok, mat["spec"], mat["color"])
    up = torch.sqrt(u1)
    over = torch.sqrt(torch.clamp_min(1.0 - up * up, 0.0))
    around = u2 * _TWO_PI
    ax = normal.x.abs() < _SQRT_ONE_THIRD
    ay = normal.y.abs() < _SQRT_ONE_THIRD
    one, zero = torch.ones_like(normal.x), torch.zeros_like(normal.x)
    nn = V3(torch.where(ax, one, zero), torch.where(~ax & ay, one, zero),
            torch.where(~ax & ~ay, one, zero))
    p1 = normal.cross(nn).normalized()
    p2 = normal.cross(p1).normalized()
    diff = (normal * up + p1 * (torch.cos(around) * over)
            + p2 * (torch.sin(around) * over)).normalized()
    new_dir = _sel(spec, spec_dir, diff)
    return new_dir, point + new_dir * 0.01, _sel(spec, spec_col, mat["color"])


def _shade(mats, it, pixel, hit_t, point, normal, mat_id, d, color, remaining):
    u1, u2 = uniforms(it, pixel, remaining, 2)
    alive = remaining != 0
    hit = hit_t > 0.0
    safe = torch.clamp_min(mat_id, 0).long()
    mat = {k: v[safe] for k, v in mats.items()}
    mat["color"] = V3(*mat["color"].unbind(1))
    mat["spec"] = V3(*mat["spec"].unbind(1))
    emissive = mat["emit"] > 0.0
    new_dir, new_o, mult = _scatter(d, point, normal, mat, u1, u2)
    upd = alive & hit
    col = _sel(upd & emissive, color * mat["color"] * mat["emit"],
               _sel(upd, color * mult, color))
    col = _sel(alive & ~hit, _full(col.x, 0.0), col)
    rem = torch.where(alive & hit & ~emissive, remaining - 1,
                      torch.where(alive, torch.zeros_like(remaining), remaining))
    scat = upd & ~emissive
    return (_sel(scat, new_o, _full(new_o.x, 0.0)), _sel(scat, new_dir, d), col, rem)


def to_device(scene, device):
    """The scene's tables on ``device`` (built once per run)."""
    mats = {k: torch.from_numpy(v).to(device) for k, v in scene["materials"].items()}
    mesh = scene["mesh"]
    if mesh is not None:
        mesh = {"vertices": torch.from_numpy(mesh["vertices"]).to(device),
                "normals": torch.from_numpy(mesh["normals"]).to(device),
                "material": torch.from_numpy(mesh["material"]).to(device),
                "lb": [float(v) for v in mesh["lb"]], "ub": [float(v) for v in mesh["ub"]]}
    return {"materials": mats, "mesh": mesh}


def gbuffer_pixels(scene, tables, camera, pixel: torch.Tensor) -> torch.Tensor:
    """The (10, n) G-buffer values of the pixels ``pixel`` (row-major ids
    of the unmirrored image) of a 1-spp frame: radiance, first-hit normal,
    first-hit distance, throughput after the first shade; zeros where the
    primary ray misses."""
    w, h = camera["resolution"]
    it = 1
    pixel = pixel.to(torch.int64)
    x = (pixel % w).to(torch.float32)
    y = torch.div(pixel, w, rounding_mode="floor").to(torch.float32)
    jx, jy = uniforms(it, pixel, 0, 2)
    plx, ply = camera["pixel_length"].unbind()
    px = plx * (x - w * 0.5 + (jx - 0.5))
    py = ply * (y - h * 0.5 + (jy - 0.5))
    vx, vy, vz = camera["view"].unbind()
    rx, ry, rz = camera["right"].unbind()
    ux, uy, uz = camera["up"].unbind()
    d = V3(vx - rx * px - ux * py, vy - ry * px - uy * py,
           vz - rz * px - uz * py).normalized()
    one = torch.ones_like(x)
    cx, cy, cz = camera["position"].unbind()
    o = V3(one * cx, one * cy, one * cz)
    color = _full(d.x, 1.0)
    remaining = torch.full(pixel.shape, scene["depth"], dtype=torch.int32, device=pixel.device)
    t0, p0, n0, m0 = intersect(scene, tables["mesh"], o, d)
    write = t0 >= 0.0
    o, d, color, remaining = _shade(tables["materials"], it, pixel, t0, p0, n0, m0, d,
                                    color, remaining)
    zero = torch.zeros_like(t0)
    g = [torch.where(write, c, zero) for c in (*n0, t0, *color)]
    for _ in range(scene["depth"] - 1):
        if not bool((remaining > 0).any()):
            break
        t, p, n, m = intersect(scene, tables["mesh"], o, d, remaining != 0)
        o, d, color, remaining = _shade(tables["materials"], it, pixel, t, p, n, m, d,
                                        color, remaining)
    return torch.stack([*color, *g])


def frame_phis(phi0: float, dphi: float, frames: List[int]) -> Dict[int, float]:
    """The orbit angle of each frame as the loop reaches it: ``dphi`` added
    once per frame after the first, in float64, as the loop adds it."""
    out, phi, want = {}, phi0, set(frames)
    for k in range(max(frames) + 1):
        if k:
            phi += dphi
        if k in want:
            out[k] = phi
    return out
