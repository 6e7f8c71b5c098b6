"""BSDF scatter over tensors (counterpart of ops/bsdf.py).

Branch-free port of interactions.h: every branch is evaluated for every
ray and ``torch.where`` picks the result, in the same operation order as
the JAX package and as the megakernel's scalar code
(csrc/render_megakernel.cu, ``scatter``).  Specular/refractive
materials consume one uniform, diffuse ones two, both from the same
freshly seeded engine, so the renderer draws (u1, u2) once and passes
them in.  Both shading variants are here: the default Schlick path
(``fresnels=True``, interactions.h:194-258) and the PBRT-style dielectric
path (``dielectric=True``, interactions.h:121-192).
"""
from __future__ import annotations

import torch

from .vec3 import Vec3, reflect as v_reflect, where as vwhere

_SQRT_ONE_THIRD = 0.5773502691896258
_TWO_PI = 6.283185307179586


def glm_refract_v(incident: Vec3, normal: Vec3, eta):
    """glm::refract semantics: returns 0-vector on total internal reflection."""
    dt = normal.dot(incident)
    k = 1.0 - eta * eta * (1.0 - dt * dt)
    coef = eta * dt + torch.sqrt(torch.clamp_min(k, 0.0))
    refr = incident * eta - normal * coef
    ok = k >= 0
    return vwhere(ok, refr, Vec3.full_like(k, 0.0)), ok


def refract_possible_v(v: Vec3, n: Vec3, ni_over_nt):
    """The custom refract() feasibility test (interactions.h:75-85)."""
    dt = v.normalized().dot(n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    return disc > 0


def schlick(cosine, ref_idx):
    """Schlick's reflectance approximation (interactions.h:116-120)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    p5 = one_minus * one_minus
    p5 = p5 * p5 * one_minus
    return r0 + (1.0 - r0) * p5


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Exact dielectric Fresnel (interactions.h:88-115)."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = cos_theta_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    cos_i = cos_theta_i.abs()
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    r_parl = (et * cos_i - ei * cos_t) / (et * cos_i + ei * cos_t)
    r_perp = (ei * cos_i - et * cos_t) / (ei * cos_i + et * cos_t)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(fr), fr)


def cosine_hemisphere_direction_v(normal: Vec3, u1, u2) -> Vec3:
    """Cosine-weighted hemisphere sample (interactions.h:13-44).

    ``normal`` must be unit.  Draw order: up = sqrt(u1), around = u2 * 2pi.
    """
    up = torch.sqrt(u1)
    over = torch.sqrt(torch.clamp_min(1.0 - up * up, 0.0))
    around = u2 * _TWO_PI

    ax = normal.x.abs() < _SQRT_ONE_THIRD
    ay = normal.y.abs() < _SQRT_ONE_THIRD
    one = torch.ones_like(normal.x)
    zero = torch.zeros_like(normal.x)
    # not_normal = ex if |nx| small else ey if |ny| small else ez
    not_normal = Vec3(torch.where(ax, one, zero),
                      torch.where(~ax & ay, one, zero),
                      torch.where(~ax & ~ay, one, zero))
    perp1 = normal.cross(not_normal).normalized()
    perp2 = normal.cross(perp1).normalized()
    return (normal * up
            + perp1 * (torch.cos(around) * over)
            + perp2 * (torch.sin(around) * over))


def scatter_ray_v(ray_dir: Vec3, point: Vec3, surface_normal: Vec3, mat,
                  u1, u2, fresnels: bool = True, dielectric: bool = False,
                  mesh_normal_view: bool = False):
    """One scatter event for a ray batch (scatterRay, interactions.h:170-259).

    ``mat``: dict of per-ray material planes — color and specular_color
    (Vec3), has_reflective, has_refractive, index_of_refraction.  Returns
    (new_dir, new_origin, color_multiplier); the origin offset is 0.01 on
    the default path (interactions.h:253), 0.001 on the dielectric one.
    """
    if dielectric:
        return _scatter_dielectric_v(ray_dir, point, surface_normal, mat, u1, u2)
    return _scatter_default_v(ray_dir, point, surface_normal, mat, u1, u2,
                              fresnels, mesh_normal_view)


def _scatter_default_v(ray_dir: Vec3, point: Vec3, normal: Vec3, mat,
                       u1, u2, fresnels: bool, mesh_normal_view: bool):
    spec_branch = (mat["has_reflective"] != 0.0) | (mat["has_refractive"] != 0.0)

    # --- specular / refractive branch (interactions.h:195-243) ---
    pdf = u1
    cosine = ray_dir.normalized().dot(normal)
    entering = cosine <= 0
    n_ref = vwhere(entering, normal, -normal)
    ior = mat["index_of_refraction"]
    ratio = torch.where(entering, 1.0 / ior, ior)
    cos_abs = cosine.abs()

    reflective_prob = mat["has_reflective"]
    if fresnels:
        can_refract = refract_possible_v(ray_dir, n_ref, ratio)
        reflective_prob = torch.where(can_refract, schlick(cos_abs, ratio),
                                      torch.ones_like(ratio))

    do_reflect = pdf < reflective_prob
    refl_dir = v_reflect(ray_dir, normal).normalized()
    refr_dir_raw, refr_ok = glm_refract_v(ray_dir, n_ref, ratio)
    refr_dir = vwhere(refr_ok,
                      vwhere(refr_ok, refr_dir_raw, refl_dir).normalized_safe(),
                      refl_dir)
    spec_dir = vwhere(do_reflect, refl_dir, refr_dir)
    spec_color = vwhere(do_reflect | ~refr_ok, mat["specular_color"], mat["color"])

    # --- diffuse branch (interactions.h:245-251) ---
    diff_dir = cosine_hemisphere_direction_v(normal, u1, u2).normalized()

    new_dir = vwhere(spec_branch, spec_dir, diff_dir)
    color = vwhere(spec_branch, spec_color, mat["color"])
    if mesh_normal_view:
        color = normal.abs()
    new_origin = point + new_dir * 0.01
    return new_dir, new_origin, color


def _scatter_dielectric_v(ray_dir: Vec3, point: Vec3, normal: Vec3, mat, u1, u2):
    """PBRT-style path (interactions.h:121-192): Glass/Reflect/Refract/Lambert."""
    refl = mat["has_reflective"] > 1e-5
    refr = mat["has_refractive"] > 1e-5
    ior = mat["index_of_refraction"]

    # SpecularReflection_BxDF (interactions.h:121-125)
    refl_dir = v_reflect(ray_dir, normal)
    refl_color = mat["specular_color"]

    # SpecularRefraction_BxDF (interactions.h:127-146)
    wo = ray_dir
    leaving = wo.dot(normal) > 0.0
    n_r = vwhere(leaving, -normal, normal)
    eta = torch.where(leaving, ior, 1.0 / ior)
    refr_dir_raw, refr_valid = glm_refract_v(wo.normalized(), n_r, eta)
    tir = ~refr_valid
    refr_dir = vwhere(tir, v_reflect(wo, normal), refr_dir_raw)
    refr_color = vwhere(tir, Vec3.full_like(u1, 0.0), Vec3.full_like(u1, 1.0)) \
        * mat["specular_color"]

    # Glass_BxDF (interactions.h:148-163)
    v_dot_n = (-ray_dir).dot(normal)
    g_leaving = v_dot_n < 0.0
    one = torch.ones_like(ior)
    e_i = torch.where(g_leaving, ior, one)
    e_t = torch.where(g_leaving, one, ior)
    fresnel = fresnel_dielectric(v_dot_n, e_i, e_t) / v_dot_n.abs()
    glass_reflect = u1 < fresnel
    glass_dir = vwhere(glass_reflect, refl_dir, refr_dir)
    glass_color = vwhere(glass_reflect, refl_color, refr_color)

    # Lambert_BxDF (interactions.h:164-168)
    diff_dir = cosine_hemisphere_direction_v(normal.normalized(), u1, u2)
    diff_color = mat["color"]

    is_glass = refl & refr
    is_refl = refl & ~refr
    is_refr = ~refl & refr
    new_dir = vwhere(is_glass, glass_dir,
                     vwhere(is_refl, refl_dir,
                            vwhere(is_refr, refr_dir, diff_dir)))
    color = vwhere(is_glass, glass_color,
                   vwhere(is_refl, refl_color,
                          vwhere(is_refr, refr_color, diff_color)))
    new_origin = point + new_dir * 0.001
    return new_dir, new_origin, color


# ---------------------------------------------------------------------------
# AoS wrappers: the JAX package's (N, 3) API for tests and outside callers
# ---------------------------------------------------------------------------

def reflect(incident, normal):
    """glm::reflect, I - 2 dot(N, I) N, on (N, 3) tensors."""
    return v_reflect(Vec3.from_rows(incident), Vec3.from_rows(normal)).stack()


def glm_refract(incident, normal, eta):
    refr, ok = glm_refract_v(Vec3.from_rows(incident), Vec3.from_rows(normal), eta)
    return refr.stack(), ok


def refract_possible(v, n, ni_over_nt):
    return refract_possible_v(Vec3.from_rows(v), Vec3.from_rows(n), ni_over_nt)


def cosine_hemisphere_direction(normal, u1, u2):
    return cosine_hemisphere_direction_v(Vec3.from_rows(normal), u1, u2).stack()


def scatter_ray(ray_dir, point, surface_normal, mat, u1, u2,
                fresnels: bool = True, dielectric: bool = False,
                mesh_normal_view: bool = False):
    """(N, 3) wrapper over :func:`scatter_ray_v`; ``mat``'s ``color`` and
    ``specular_color`` are (N, 3) too."""
    planes = dict(mat)
    for key in ("color", "specular_color"):
        planes[key] = Vec3.from_rows(mat[key])
    d, o, c = scatter_ray_v(Vec3.from_rows(ray_dir), Vec3.from_rows(point),
                            Vec3.from_rows(surface_normal), planes, u1, u2,
                            fresnels=fresnels, dielectric=dielectric,
                            mesh_normal_view=mesh_normal_view)
    return d.stack(), o.stack(), c.stack()
