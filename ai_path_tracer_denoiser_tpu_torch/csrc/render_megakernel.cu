// Whole-render megakernel K1: N 1-spp path-trace iterations in one launch.
//
// Replaces the TPU kernel of the JAX package's render/pallas_backend.py:
// the pallas_call in _compiled_call (:588) of the body _build_kernel (:298)
// (`kernel` and `kernel_operand`, launched by render_pallas).  Same
// contract: per pixel, `niter` iterations of anti-aliased ray generation
// from the parity RNG, up to `depth` bounces of analytic-geom + small-mesh
// intersection and scatterRay shading, RGB summed into `acc`, and the
// depth-0 normal/depth/albedo G-buffer written on iteration 1.  The
// arithmetic follows the plain PyTorch version (render/wavefront.py,
// ops/intersect.py, ops/bsdf.py, ops/rng.py of this package) operation by
// operation.
//
// What bounds it on the H100: float32 issue (about a thousand operations
// per ray segment, most of them the geom tests, which every lane runs
// alike); the bytes moved are 80 per pixel per launch.  The first version
// ran one pixel per thread with the iteration and bounce loops nested in
// the thread, so every warp ran, iteration by iteration, as long as its
// longest path: 58% of its lane-steps traced a segment on the cornell
// frame, 55% at 512x512 x 64 iterations (tools/k1_sweep.py).  And every
// geom test transformed and normalised its world normal, of which all but
// the winner's were thrown away.
//
// Design.
// * Persistent warps with path regeneration.  About (SMs x resident blocks)
//   blocks are launched.  A warp takes `chunk` pixel ids at a time from a
//   global counter (a one-int scratch the wrapper zeroes) and hands them to
//   its lanes that have none, by ballot and popcount.  The loop is flat: one
//   step traces one segment for every lane that has a live path.  A lane
//   whose path ends adds its colour to its pixel's sums (in the same order
//   as before), starts the pixel's next iteration from a new camera ray,
//   and after `niter` iterations writes the pixel's 10 planes once and takes
//   the next pixel.  Pixels stay in order within a lane; each pixel's own
//   sequence of operations is the first version's, so are its bits.
// * The world normal of the winning geom only.  The geom loop keeps t, the
//   world point (t is |o - point|) and what the winner's normal needs: the
//   object-space normal of a box, the object-space point and root signs of
//   a sphere.  The transform and normalisation run once per segment after
//   the loop, on the same operands, so the normal has the same bits.
// * NaN-propagating min/max as Hopper's min.NaN / max.NaN, one instruction
//   each (a box test makes ten).  With the normal, a box test falls from
//   298 to 269 SASS instructions, a sphere test from 199 to 180.
// * The scene (geom transforms, material table, mesh of at most 64 faces and
//   its box) arrives as one packed device buffer that each persistent block
//   copies into shared memory once; the geom type is a run-time branch
//   (uniform across a warp), so one compiled kernel serves every scene.
// * The pixel id splits into (x, y) with integer division, which gives the
//   exact (x, y) of the TPU kernel's float-reciprocal split plus fix-up.
//
// What is left: lanes still idle at the end of the launch (each warp waits
// for its last paths once the counter is spent: 87% of lane-steps trace a
// segment on the cornell frame, 89% at 512x512 x 64 iterations), and a
// step now runs the union of several lanes' code (ray generation, pixels
// taken and written, shading of paths at different depths).
//
// Built with -DK1_ONE_PIXEL_PER_THREAD the same source is the first
// version's schedule and arithmetic: one pixel per thread, nested loops,
// every geom's world normal, min/max by compare and select.  That build is
// the witness the shipped kernel is held to bit for bit (chip_smoke.py,
// tests/test_torch_cuda.py).
//
// Floating point: built with -fmad=false (see render/cuda_backend.py), so
// no multiply-add is contracted and every operation rounds as the separate
// PyTorch kernels of the plain version do; IEEE division and sqrt (no fast
// math); Vec3 normalisation uses rsqrtf, as torch.rsqrt does on the card.
// Remaining differences against the plain version are last-bit ones in
// library transcendentals, which can only flip near-tie decisions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGeomRow = 48;   // transform, inverse, inverse-transpose (4x4 each)
constexpr int kMatRow = 10;    // color3, specular3, refl, refr, ior, emittance
constexpr int kFaceRow = 18;   // v0, v1, v2, n0, n1, n2
constexpr int kCube = 1;

constexpr int kAntialias = 1;
constexpr int kRngFast = 2;
constexpr int kDenoise = 4;
constexpr int kFresnels = 8;
constexpr int kDielectric = 16;
constexpr int kNormalView = 32;
constexpr int kRayCulling = 64;

constexpr float kEpsPoint = 1e-4f;
constexpr float kFltEps = 1.1920929e-07f;
constexpr float kBig = 1e38f;
constexpr float kInvM = (float)(1.0 / 2147483647.0);
constexpr float kTwoM32 = 2.3283064365386963e-10f;   // 2^-32
constexpr float kSqrtOneThird = 0.5773502691896258f;
constexpr float kTwoPi = 6.283185307179586f;

struct Cam {
  float pos[3], view[3], up[3], right[3], pl[2];
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 normalized(V3 a) { return scale(a, rsqrtf(dot(a, a))); }
__device__ __forceinline__ V3 normalized_safe(V3 a) {
  float n2 = dot(a, a);
  return scale(a, n2 > 0.0f ? rsqrtf(n2) : 1.0f);
}
__device__ __forceinline__ V3 vabs(V3 a) { return v3(fabsf(a.x), fabsf(a.y), fabsf(a.z)); }
__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return sub(i, scale(n, 2.0f * dot(n, i))); }

// NaN-propagating min/max (torch.minimum/maximum semantics).  Hopper's
// min.NaN / max.NaN do it in one instruction; the witness keeps the first
// version's compare-and-select.  Either way a NaN operand gives a NaN and
// other operands the IEEE min/max; only the NaN's payload may differ, and a
// NaN here never reaches an output (it only fails the hit comparisons).
__device__ __forceinline__ float jmin(float a, float b) {
#ifdef K1_ONE_PIXEL_PER_THREAD
  return (a != a || b != b) ? a + b : fminf(a, b);
#else
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#endif
}
__device__ __forceinline__ float jmax(float a, float b) {
#ifdef K1_ONE_PIXEL_PER_THREAD
  return (a != a || b != b) ? a + b : fmaxf(a, b);
#else
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#endif
}

__device__ __forceinline__ V3 xform_point(const float* m, V3 p) {
  return v3(m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
            m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
            m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]);
}
__device__ __forceinline__ V3 xform_dir(const float* m, V3 d) {
  return v3(m[0] * d.x + m[1] * d.y + m[2] * d.z,
            m[4] * d.x + m[5] * d.y + m[6] * d.z,
            m[8] * d.x + m[9] * d.y + m[10] * d.z);
}

// ---------------------------------------------------------------- RNG --
__device__ __forceinline__ uint32_t utilhash(uint32_t a) {
  a = (a + 0x7ED55D16u) + (a << 12);
  a = (a ^ 0xC761C23Cu) ^ (a >> 19);
  a = (a + 0x165667B1u) + (a << 5);
  a = (a + 0xD3A2646Cu) ^ (a << 9);
  a = (a + 0xFD7046C5u) + (a << 3);
  a = (a ^ 0xB55A4F09u) ^ (a >> 16);
  return a;
}

__device__ __forceinline__ uint32_t lcg_next(uint32_t s) {
  return (uint32_t)(((uint64_t)s * 48271ull) % 2147483647ull);
}

// draw_uniforms(iteration, index, depth, 2, mode) of ops/rng.py.
__device__ __forceinline__ void draw2(uint32_t iter, uint32_t index, uint32_t depth,
                                      bool fast, float* u0, float* u1) {
  if (!fast) {
    uint32_t h = utilhash(0x80000000u | (depth << 22) | iter) ^ utilhash(index);
    uint32_t s = h % 2147483647u;
    if (s == 0) s = 1;
    s = lcg_next(s);
    *u0 = (float)(int)s * kInvM;
    s = lcg_next(s);
    *u1 = (float)(int)s * kInvM;
  } else {
    uint32_t mixed = utilhash((depth << 22) ^ iter) ^ utilhash(index);
    *u0 = (float)utilhash(mixed + 0x9E3779B9u) * kTwoM32;
    *u1 = (float)utilhash(mixed + 0x9E3779B9u * 2u) * kTwoM32;
  }
}

// ------------------------------------------------------- intersection --
// Unit cube slab test (ops/intersect.py:box_intersect_v): t, the world
// point and the object-space normal.
__device__ __forceinline__ float box_test(const float* M, const float* inv, V3 o, V3 d,
                                          V3* point, V3* n_obj) {
  V3 qo = xform_point(inv, o);
  V3 qd = normalized(xform_dir(inv, d));
  float qos[3] = {qo.x, qo.y, qo.z};
  float qds[3] = {qd.x, qd.y, qd.z};
  float ta[3], tb[3], sg[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (-0.5f - qos[a]) / qds[a];
    float t2 = (0.5f - qos[a]) / qds[a];
    float lo = jmin(t1, t2);
    tb[a] = jmax(t1, t2);
    sg[a] = t2 < t1 ? 1.0f : -1.0f;
    ta[a] = lo > 0.0f ? lo : -kBig;
  }
  float tmin = jmax(jmax(ta[0], ta[1]), ta[2]);
  float tmax = jmin(jmin(tb[0], tb[1]), tb[2]);
  bool a0 = ta[0] >= tmin;
  bool a1 = !a0 && (ta[1] >= tmin);
  bool a2 = !(a0 || a1);
  bool b0 = tb[0] <= tmax;
  bool b1 = !b0 && (tb[1] <= tmax);
  bool b2 = !(b0 || b1);
  bool hit = (tmax >= tmin) && (tmax > 0.0f);
  bool inside = tmin <= 0.0f;
  float t_obj = inside ? tmax : tmin;
  *n_obj = inside ? v3(b0 ? sg[0] : 0.0f, b1 ? sg[1] : 0.0f, b2 ? sg[2] : 0.0f)
                  : v3(a0 ? sg[0] : 0.0f, a1 ? sg[1] : 0.0f, a2 ? sg[2] : 0.0f);
  V3 obj_point = add(qo, scale(qd, t_obj - kEpsPoint));
  *point = xform_point(M, obj_point);
  return hit ? norm(sub(o, *point)) : -1.0f;
}

// Radius-0.5 sphere (ops/intersect.py:sphere_intersect_v): t, the world
// point, the object-space point and whether both roots are positive.
__device__ __forceinline__ float sphere_test(const float* M, const float* inv, V3 o, V3 d,
                                             V3* point, V3* obj_point, bool* both_pos) {
  V3 ro = xform_point(inv, o);
  V3 rd = normalized(xform_dir(inv, d));
  float v_dot_d = dot(ro, rd);
  float radicand = v_dot_d * v_dot_d - (dot(ro, ro) - 0.25f);
  float sq = sqrtf(jmax(radicand, 0.0f));
  float t1 = -v_dot_d + sq;
  float t2 = -v_dot_d - sq;
  bool both_neg = (t1 < 0.0f) && (t2 < 0.0f);
  *both_pos = (t1 > 0.0f) && (t2 > 0.0f);
  float t_obj = *both_pos ? jmin(t1, t2) : jmax(t1, t2);
  bool hit = (radicand >= 0.0f) && !both_neg;
  *obj_point = add(ro, scale(rd, t_obj - kEpsPoint));
  *point = xform_point(M, *obj_point);
  return hit ? norm(sub(o, *point)) : -1.0f;
}

// World-space normal of a geom hit from what its test kept: a box's
// object-space normal through the transform, a sphere's object-space point
// through the inverse transpose, flipped where the ray starts inside.
__device__ __forceinline__ V3 geom_normal(const float* row, bool cube, V3 q, bool both_pos) {
  if (cube) return normalized(xform_dir(row, q));
  V3 n = normalized(xform_dir(row + 32, q));
  return both_pos ? n : neg(n);
}

// Slab AABB gate (ops/intersect.py:ray_aabb_intersect_v).
__device__ bool aabb_test(V3 o, V3 d, const float* lb, const float* ub) {
  float os[3] = {o.x, o.y, o.z};
  float ds[3] = {d.x, d.y, d.z};
  float tmin = -INFINITY, tmax = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float inv = 1.0f / ds[a];
    float t1 = (lb[a] - os[a]) * inv;
    float t2 = (ub[a] - os[a]) * inv;
    tmin = jmax(tmin, jmin(t1, t2));
    tmax = jmin(tmax, jmax(t1, t2));
  }
  return (tmax >= 0.0f) && (tmin <= tmax);
}

struct Hit {
  float t;
  V3 point, normal;
  int mat;
};

// intersect_scene_v: geoms first (first minimal t wins), then the mesh
// behind its AABB gate, winning only on strictly smaller t.
__device__ Hit intersect(const float* geo, const int* gtype, const int* gmat, int n_geoms,
                         const float* faces, const int* fmat, int n_faces, const float* box,
                         bool culling, V3 o, V3 d) {
  Hit h;
  h.t = INFINITY;
  h.point = v3(0.0f, 0.0f, 0.0f);
  h.normal = v3(0.0f, 0.0f, 0.0f);
  h.mat = -1;
  int win = -1;                      // the winning geom, and what its normal needs
  V3 win_q = v3(0.0f, 0.0f, 0.0f);
  bool win_pos = false;
#pragma unroll 1
  for (int g = 0; g < n_geoms; ++g) {
    const float* row = geo + g * kGeomRow;
    V3 p, q;
    bool pos = false;
    float t = gtype[g] == kCube ? box_test(row, row + 16, o, d, &p, &q)
                                : sphere_test(row, row + 16, o, d, &p, &q, &pos);
    t = t > 0.0f ? t : INFINITY;
#ifdef K1_ONE_PIXEL_PER_THREAD
    V3 n = geom_normal(row, gtype[g] == kCube, q, pos);   // every geom's, as the first version
#endif
    if (t < h.t) {
      h.t = t;
      h.point = p;
      h.mat = gmat[g];
#ifdef K1_ONE_PIXEL_PER_THREAD
      h.normal = n;
#else
      win = g;
      win_q = q;
      win_pos = pos;
#endif
    }
  }
  if (win >= 0) h.normal = geom_normal(geo + win * kGeomRow, gtype[win] == kCube, win_q, win_pos);
  if (n_faces > 0 && (!culling || aabb_test(o, d, box, box + 3))) {
    for (int f = 0; f < n_faces; ++f) {
      const float* fr = faces + f * kFaceRow;
      V3 v0 = v3(fr[0], fr[1], fr[2]), v1 = v3(fr[3], fr[4], fr[5]), v2 = v3(fr[6], fr[7], fr[8]);
      // glm one-sided Moller-Trumbore (ops/intersect.py:_triangle_t)
      V3 e1 = sub(v1, v0), e2 = sub(v2, v0);
      V3 p = cross(d, e2);
      float a = dot(e1, p);
      bool front = a >= kFltEps;
      float fi = 1.0f / a;
      V3 s = sub(o, v0);
      float u = fi * dot(s, p);
      V3 q = cross(s, e1);
      float w = fi * dot(d, q);
      float t = fi * dot(e2, q);
      bool hit = front && u >= 0.0f && u <= 1.0f && w >= 0.0f && u + w <= 1.0f && t >= 0.0f;
      t = (hit && t > 0.0f) ? t : INFINITY;
      if (t < h.t) {
        float v = 1.0f - u - w;
        V3 n0 = v3(fr[9], fr[10], fr[11]), n1 = v3(fr[12], fr[13], fr[14]),
           n2 = v3(fr[15], fr[16], fr[17]);
        h.t = t;
        // rotated barycentrics for the point, standard for the normal
        // (intersections.h:166-168)
        h.point = add(add(scale(v0, u), scale(v1, w)), scale(v2, v));
        h.normal = normalized_safe(add(add(scale(n0, v), scale(n1, u)), scale(n2, w)));
        h.mat = fmat[f];
      }
    }
  }
  if (!isfinite(h.t)) {
    h.t = -1.0f;
    h.mat = -1;
  }
  h.normal = normalized_safe(h.normal);
  return h;
}

// ------------------------------------------------------------ shading --
__device__ __forceinline__ V3 cosine_hemisphere(V3 n, float u1, float u2) {
  float up = sqrtf(u1);
  float over = sqrtf(jmax(1.0f - up * up, 0.0f));
  float around = u2 * kTwoPi;
  bool ax = fabsf(n.x) < kSqrtOneThird;
  bool ay = fabsf(n.y) < kSqrtOneThird;
  V3 not_normal = v3(ax ? 1.0f : 0.0f, (!ax && ay) ? 1.0f : 0.0f, (!ax && !ay) ? 1.0f : 0.0f);
  V3 perp1 = normalized(cross(n, not_normal));
  V3 perp2 = normalized(cross(n, perp1));
  return add(add(scale(n, up), scale(perp1, cosf(around) * over)),
             scale(perp2, sinf(around) * over));
}

// glm::refract; *ok false on total internal reflection (then returns 0).
__device__ __forceinline__ V3 glm_refract(V3 i, V3 n, float eta, bool* ok) {
  float dt = dot(n, i);
  float k = 1.0f - eta * eta * (1.0f - dt * dt);
  float coef = eta * dt + sqrtf(jmax(k, 0.0f));
  *ok = k >= 0.0f;
  return *ok ? sub(scale(i, eta), scale(n, coef)) : v3(0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float schlick(float cosine, float ref_idx) {
  float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
  r0 = r0 * r0;
  float om = 1.0f - cosine;
  float p5 = om * om;
  p5 = p5 * p5 * om;
  return r0 + (1.0f - r0) * p5;
}

__device__ __forceinline__ float fresnel_dielectric(float cos_theta_i, float eta_i, float eta_t) {
  cos_theta_i = fminf(fmaxf(cos_theta_i, -1.0f), 1.0f);
  bool entering = cos_theta_i > 0.0f;
  float ei = entering ? eta_i : eta_t;
  float et = entering ? eta_t : eta_i;
  float cos_i = fabsf(cos_theta_i);
  float sin_i = sqrtf(jmax(1.0f - cos_i * cos_i, 0.0f));
  float sin_t = ei / et * sin_i;
  bool tir = sin_t >= 1.0f;
  float cos_t = sqrtf(jmax(1.0f - sin_t * sin_t, 0.0f));
  float r_parl = (et * cos_i - ei * cos_t) / (et * cos_i + ei * cos_t);
  float r_perp = (ei * cos_i - et * cos_t) / (ei * cos_i + et * cos_t);
  float fr = 0.5f * (r_parl * r_parl + r_perp * r_perp);
  return tir ? 1.0f : fr;
}

// scatterRay (ops/bsdf.py:scatter_ray_v) for one ray that hit a
// non-emissive surface.
__device__ void scatter(V3 ray_dir, V3 point, V3 normal, const float* m, float u1, float u2,
                        int flags, V3* new_dir, V3* new_origin, V3* mult) {
  V3 mcolor = v3(m[0], m[1], m[2]);
  V3 mspec = v3(m[3], m[4], m[5]);
  float has_refl = m[6], has_refr = m[7], ior = m[8];
  if (flags & kDielectric) {
    bool refl = has_refl > 1e-5f;
    bool refr = has_refr > 1e-5f;
    V3 refl_dir = reflect(ray_dir, normal);
    bool leaving = dot(ray_dir, normal) > 0.0f;
    V3 n_r = leaving ? neg(normal) : normal;
    float eta = leaving ? ior : 1.0f / ior;
    bool valid;
    V3 refr_raw = glm_refract(normalized(ray_dir), n_r, eta, &valid);
    V3 refr_dir = valid ? refr_raw : reflect(ray_dir, normal);
    V3 refr_color = mul(valid ? v3(1.0f, 1.0f, 1.0f) : v3(0.0f, 0.0f, 0.0f), mspec);
    V3 dir, color;
    if (refl && refr) {
      float v_dot_n = dot(neg(ray_dir), normal);
      bool g_leaving = v_dot_n < 0.0f;
      float e_i = g_leaving ? ior : 1.0f;
      float e_t = g_leaving ? 1.0f : ior;
      float fresnel = fresnel_dielectric(v_dot_n, e_i, e_t) / fabsf(v_dot_n);
      bool glass_reflect = u1 < fresnel;
      dir = glass_reflect ? refl_dir : refr_dir;
      color = glass_reflect ? mspec : refr_color;
    } else if (refl) {
      dir = refl_dir;
      color = mspec;
    } else if (refr) {
      dir = refr_dir;
      color = refr_color;
    } else {
      dir = cosine_hemisphere(normalized(normal), u1, u2);
      color = mcolor;
    }
    *new_dir = dir;
    *mult = color;
    *new_origin = add(point, scale(dir, 0.001f));
    return;
  }
  V3 dir, color;
  if (has_refl != 0.0f || has_refr != 0.0f) {
    float cosine = dot(normalized(ray_dir), normal);
    bool entering = cosine <= 0.0f;
    V3 n_ref = entering ? normal : neg(normal);
    float ratio = entering ? 1.0f / ior : ior;
    float reflective_prob = has_refl;
    if (flags & kFresnels) {
      float dt = dot(normalized(ray_dir), n_ref);
      float disc = 1.0f - ratio * ratio * (1.0f - dt * dt);
      reflective_prob = disc > 0.0f ? schlick(fabsf(cosine), ratio) : 1.0f;
    }
    bool do_reflect = u1 < reflective_prob;
    V3 refl_dir = normalized(reflect(ray_dir, normal));
    bool refr_ok;
    V3 refr_raw = glm_refract(ray_dir, n_ref, ratio, &refr_ok);
    V3 refr_dir = refr_ok ? normalized_safe(refr_raw) : refl_dir;
    dir = do_reflect ? refl_dir : refr_dir;
    color = (do_reflect || !refr_ok) ? mspec : mcolor;
  } else {
    dir = normalized(cosine_hemisphere(normal, u1, u2));
    color = mcolor;
  }
  if (flags & kNormalView) color = vabs(normal);
  *new_dir = dir;
  *mult = color;
  *new_origin = add(point, scale(dir, 0.01f));
}

// ------------------------------------------------------------- kernel --
struct Args {
  const float* scene_f;
  const int* scene_i;
  int n_geoms, n_mats, n_faces;
  Cam cam;
  int width, height, n, pixel_offset, start, niter, rng_offset, depth, flags;
  float* acc;                  // (3, n) running sums
  float* gbuf;                 // (7, n) G-buffer
  int* counter;                // next unclaimed pixel id (zeroed by the wrapper)
  int chunk;                   // pixel ids a warp claims at a time
  unsigned long long* stats;   // null, or {32 x warp steps, segments traced}
};

__host__ __device__ __forceinline__ size_t scene_smem_bytes(int n_geoms, int n_mats,
                                                            int n_faces) {
  return sizeof(float) * (n_geoms * kGeomRow + n_mats * kMatRow + n_faces * kFaceRow + 6) +
         sizeof(int) * (2 * n_geoms + n_faces);
}

struct SceneView {
  const float *geo, *mats, *faces, *box;
  const int *gtype, *gmat, *fmat;
};

// The block's copy of the packed scene in shared memory.
__device__ __forceinline__ SceneView stage_scene(const Args& a, float* smem) {
  const int n_f = a.n_geoms * kGeomRow + a.n_mats * kMatRow + a.n_faces * kFaceRow + 6;
  const int n_i = 2 * a.n_geoms + a.n_faces;
  int* smem_i = reinterpret_cast<int*>(smem + n_f);
  for (int k = threadIdx.x; k < n_f; k += blockDim.x) smem[k] = a.scene_f[k];
  for (int k = threadIdx.x; k < n_i; k += blockDim.x) smem_i[k] = a.scene_i[k];
  __syncthreads();
  SceneView s;
  s.geo = smem;
  s.mats = s.geo + a.n_geoms * kGeomRow;
  s.faces = s.mats + a.n_mats * kMatRow;
  s.box = s.faces + a.n_faces * kFaceRow;
  s.gtype = smem_i;
  s.gmat = s.gtype + a.n_geoms;
  s.fmat = s.gmat + a.n_geoms;
  return s;
}

struct Path {
  V3 o, d, color;
  int remaining;      // bounces left; the path has ended at 0
  int iteration;      // the true iteration (accumulation, G-buffer gate)
  uint32_t riter;     // the iteration the RNG draws from
};

// Iteration k's camera ray for pixel `pid` at (xf, yf).
__device__ __forceinline__ Path start_path(const Args& a, uint32_t pid, float xf, float yf,
                                           int k) {
  Path p;
  p.iteration = a.start + 1 + k;
  // RNG draws from iteration + rng_offset; the accumulation and the
  // iteration-1 G-buffer gate use the true iteration.
  p.riter = (uint32_t)(p.iteration + a.rng_offset);
  float jx = 0.0f, jy = 0.0f;
  if (a.flags & kAntialias) {
    draw2(p.riter, pid, 0u, a.flags & kRngFast, &jx, &jy);
    jx = jx - 0.5f;
    jy = jy - 0.5f;
  }
  const float half_w = (float)(a.width * 0.5);
  const float half_h = (float)(a.height * 0.5);
  const Cam& cam = a.cam;
  const float px = cam.pl[0] * (xf - half_w + jx);
  const float py = cam.pl[1] * (yf - half_h + jy);
  p.d = normalized(v3(cam.view[0] - cam.right[0] * px - cam.up[0] * py,
                      cam.view[1] - cam.right[1] * px - cam.up[1] * py,
                      cam.view[2] - cam.right[2] * px - cam.up[2] * py));
  p.o = v3(cam.pos[0], cam.pos[1], cam.pos[2]);
  p.color = v3(1.0f, 1.0f, 1.0f);
  p.remaining = a.depth;
  return p;
}

// One bounce of a live path: intersect, the depth-0 G-buffer, shadeMaterial
// (render/wavefront.py:_shade).
__device__ __forceinline__ void trace_segment(const Args& a, const SceneView& s, uint32_t pid,
                                              Path* p, float* g) {
  Hit h = intersect(s.geo, s.gtype, s.gmat, a.n_geoms, s.faces, s.fmat, a.n_faces, s.box,
                    a.flags & kRayCulling, p->o, p->d);
  const bool write = p->remaining == a.depth && (a.flags & kDenoise) && p->iteration == 1 &&
                     h.t >= 0.0f;
  if (write) {
    g[0] = h.normal.x;
    g[1] = h.normal.y;
    g[2] = h.normal.z;
    g[3] = h.t;
  }
  if (!(h.t > 0.0f)) {
    p->color = v3(0.0f, 0.0f, 0.0f);
    p->remaining = 0;
  } else {
    const float* m = s.mats + (h.mat > 0 ? h.mat : 0) * kMatRow;
    if (m[9] > 0.0f) {
      p->color = scale(mul(p->color, v3(m[0], m[1], m[2])), m[9]);
      p->remaining = 0;
    } else {
      float u1, u2;
      draw2(p->riter, pid, (uint32_t)p->remaining, a.flags & kRngFast, &u1, &u2);
      V3 nd, no, mult;
      scatter(p->d, h.point, h.normal, m, u1, u2, a.flags, &nd, &no, &mult);
      p->color = mul(p->color, mult);
      p->d = nd;
      p->o = no;
      p->remaining -= 1;
    }
  }
  if (write) {
    g[4] = p->color.x;
    g[5] = p->color.y;
    g[6] = p->color.z;
  }
}

__device__ __forceinline__ void load_pixel(const Args& a, int i, float* sums, float* g) {
#pragma unroll
  for (int c = 0; c < 3; ++c) sums[c] = a.acc[c * a.n + i];
#pragma unroll
  for (int c = 0; c < 7; ++c) g[c] = a.gbuf[c * a.n + i];
}

__device__ __forceinline__ void store_pixel(const Args& a, int i, const float* sums,
                                            const float* g) {
#pragma unroll
  for (int c = 0; c < 3; ++c) a.acc[c * a.n + i] = sums[c];
#pragma unroll
  for (int c = 0; c < 7; ++c) a.gbuf[c * a.n + i] = g[c];
}

#ifdef K1_ONE_PIXEL_PER_THREAD
constexpr int kWitnessThreads = 128;

// The first version's schedule: one pixel per thread, every iteration and
// bounce inside the thread.
__global__ void __launch_bounds__(kWitnessThreads) render_kernel(Args a) {
  extern __shared__ float smem[];
  const SceneView s = stage_scene(a, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int pid_i = a.pixel_offset + i;
  const uint32_t pid = (uint32_t)pid_i;
  const float xf = (float)(pid_i % a.width);
  const float yf = (float)(pid_i / a.width);
  float sums[3], g[7];
  load_pixel(a, i, sums, g);
  for (int k = 0; k < a.niter; ++k) {
    Path p = start_path(a, pid, xf, yf, k);
    while (p.remaining > 0) trace_segment(a, s, pid, &p, g);
    sums[0] = sums[0] + p.color.x;
    sums[1] = sums[1] + p.color.y;
    sums[2] = sums[2] + p.color.z;
  }
  store_pixel(a, i, sums, g);
}
#else
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Persistent warps with path regeneration (see the note at the top).
__global__ void __launch_bounds__(kMaxThreads) render_kernel(Args a) {
  extern __shared__ float smem[];
  const SceneView s = stage_scene(a, smem);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int next = 0, end = 0;         // warp-uniform: the chunk's ids not yet handed out
  bool more = true;              // warp-uniform: the counter may hold pixels still
  int i = -1;                    // this lane's pixel (local id), -1: none
  int k = 0;                     // its iteration within the launch
  uint32_t pid = 0;
  float xf = 0.0f, yf = 0.0f;
  float sums[3], g[7];
  Path p;
  p.remaining = 0;
  unsigned long long steps = 0, segments = 0;
  for (;;) {
    bool fresh = false;
    // A path that has ended: its colour into the sums, then the pixel's next
    // iteration, or its planes out after the last one.
    if (i >= 0 && p.remaining <= 0) {
      sums[0] = sums[0] + p.color.x;
      sums[1] = sums[1] + p.color.y;
      sums[2] = sums[2] + p.color.z;
      if (++k < a.niter) {
        fresh = true;
      } else {
        store_pixel(a, i, sums, g);
        i = -1;
      }
    }
    // Lanes without a pixel take the next ids of the warp's chunk, in lane
    // order; an exhausted chunk is replaced from the counter.
    for (;;) {
      const unsigned need = __ballot_sync(kFull, i < 0);
      if (need == 0 || !more) break;
      if (next >= end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(a.counter, a.chunk);
        base = __shfl_sync(kFull, base, 0);
        if (base >= a.n) {
          more = false;
          break;
        }
        next = base;
        end = min(base + a.chunk, a.n);
      }
      const int avail = end - next;
      const int rank = __popc(need & below);
      if (i < 0 && rank < avail) {
        i = next + rank;
        k = 0;
        const int pid_i = a.pixel_offset + i;
        pid = (uint32_t)pid_i;
        xf = (float)(pid_i % a.width);
        yf = (float)(pid_i / a.width);
        load_pixel(a, i, sums, g);
        if (a.niter > 0) {
          fresh = true;
        } else {                 // no iteration: the planes go back unchanged
          store_pixel(a, i, sums, g);
          i = -1;
        }
      }
      next += min(__popc(need), avail);
    }
    if (fresh) p = start_path(a, pid, xf, yf, k);
    if (__ballot_sync(kFull, i >= 0) == 0) break;
    const bool live = i >= 0 && p.remaining > 0;
    const unsigned live_mask = __ballot_sync(kFull, live);
    steps += live_mask != 0;
    segments += __popc(live_mask);
    if (live) trace_segment(a, s, pid, &p, g);
  }
  if (a.stats != nullptr && lane == 0) {
    atomicAdd(a.stats, 32ull * steps);
    atomicAdd(a.stats + 1, segments);
  }
}
#endif

}  // namespace

// Blocks of `threads` threads that fit on one SM with `smem_bytes` of scene.
extern "C" int aptd_render_blocks_per_sm(int threads, int smem_bytes, int* blocks) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(render_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, render_kernel, threads,
                                                            (size_t)smem_bytes);
}

// One launch over pixels [0, n) of the state (global ids pixel_offset + i).
// `blocks`, `threads`, `chunk`, `counter` and `stats` are the persistent
// schedule's; the one-pixel-per-thread build takes 128-thread blocks over n.
extern "C" int aptd_render_megakernel(const float* scene_f, const int* scene_i, int n_geoms,
                                      int n_mats, int n_faces, const float* cam_host, int width,
                                      int height, int n, int pixel_offset, int start, int niter,
                                      int rng_offset, int depth, int flags, float* acc,
                                      float* gbuf, int* counter, int blocks, int threads,
                                      int chunk, unsigned long long* stats, void* stream) {
  Args a;
  a.scene_f = scene_f;
  a.scene_i = scene_i;
  a.n_geoms = n_geoms;
  a.n_mats = n_mats;
  a.n_faces = n_faces;
  const float* c = cam_host;
  for (int k = 0; k < 3; ++k) {
    a.cam.pos[k] = c[k];
    a.cam.view[k] = c[3 + k];
    a.cam.up[k] = c[6 + k];
    a.cam.right[k] = c[9 + k];
  }
  a.cam.pl[0] = c[12];
  a.cam.pl[1] = c[13];
  a.width = width;
  a.height = height;
  a.n = n;
  a.pixel_offset = pixel_offset;
  a.start = start;
  a.niter = niter;
  a.rng_offset = rng_offset;
  a.depth = depth;
  a.flags = flags;
  a.acc = acc;
  a.gbuf = gbuf;
  a.counter = counter;
  a.chunk = chunk;
  a.stats = stats;
  const size_t smem = scene_smem_bytes(n_geoms, n_mats, n_faces);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(render_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
#ifdef K1_ONE_PIXEL_PER_THREAD
  threads = kWitnessThreads;
  blocks = (n + threads - 1) / threads;
#endif
  if (n > 0 && blocks > 0) {
    render_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
