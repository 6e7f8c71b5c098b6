// Shared device code of the analytic-geom tests: the render megakernel K1
// (render_megakernel.cu) and the wavefront's geom intersection K10
// (geom_intersect.cu).  The unit-cube slab test, the radius-0.5 sphere test
// and the winner's world normal, with the Vec3 operations, NaN-propagating
// min/max and transforms they use, written in the operation order of their
// plain PyTorch versions (ops/intersect.py:box_intersect_v,
// sphere_intersect_v; ops/vec3.py).
// The sources are built with -fmad=false and without fast math, so every
// operation rounds as the separate PyTorch kernels of the plain versions do;
// Vec3 normalisation uses rsqrtf, as torch.rsqrt does on the card.
// A geom is a row of kGeomRow floats: its transform, inverse and inverse
// transpose, each 4x4 row-major.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace aptd_geom {

constexpr int kGeomRow = 48;   // transform, inverse, inverse-transpose (4x4 each)
constexpr int kCube = 1;

constexpr float kEpsPoint = 1e-4f;
constexpr float kBig = 1e38f;

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

// NaN-propagating min/max (torch.minimum/maximum semantics).  Hopper's
// min.NaN / max.NaN do it in one instruction; K1's witness build
// (-DK1_ONE_PIXEL_PER_THREAD) keeps the first version's compare-and-select.
// Either way a NaN operand gives a NaN and other operands the IEEE min/max;
// only the NaN's payload may differ, and a NaN here never reaches an output
// (it only fails the hit comparisons).
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

// Unit cube slab test (ops/intersect.py:box_intersect_v): t, the world
// point, the object-space normal and whether the ray starts outside.
__device__ __forceinline__ float box_test(const float* M, const float* inv, V3 o, V3 d,
                                          V3* point, V3* n_obj, bool* outside) {
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
  *outside = !inside;
  float t_obj = inside ? tmax : tmin;
  *n_obj = inside ? v3(b0 ? sg[0] : 0.0f, b1 ? sg[1] : 0.0f, b2 ? sg[2] : 0.0f)
                  : v3(a0 ? sg[0] : 0.0f, a1 ? sg[1] : 0.0f, a2 ? sg[2] : 0.0f);
  V3 obj_point = add(qo, scale(qd, t_obj - kEpsPoint));
  *point = xform_point(M, obj_point);
  return hit ? norm(sub(o, *point)) : -1.0f;
}

// The same test where the side is not needed (K1).
__device__ __forceinline__ float box_test(const float* M, const float* inv, V3 o, V3 d,
                                          V3* point, V3* n_obj) {
  bool outside;
  return box_test(M, inv, o, d, point, n_obj, &outside);
}

// Radius-0.5 sphere (ops/intersect.py:sphere_intersect_v): t, the world
// point, the object-space point and whether both roots are positive (the
// ray starts outside).
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
// `row`: the geom's kGeomRow floats.
__device__ __forceinline__ V3 geom_normal(const float* row, bool cube, V3 q, bool both_pos) {
  if (cube) return normalized(xform_dir(row, q));
  V3 n = normalized(xform_dir(row + 32, q));
  return both_pos ? n : neg(n);
}

}  // namespace aptd_geom
