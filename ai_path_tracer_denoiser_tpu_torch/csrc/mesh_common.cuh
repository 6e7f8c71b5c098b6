// Shared device code of the mesh kernels (mesh_bvh_v2p.cu, mesh_bvh_v2.cu,
// mesh_bvh_v3.cu, mesh_binned_phase1.cu, mesh_binned_pair.cu) and the
// visit-cost probe's (mm_visit_vpu.cu, mm_visit_mma.cu): the slab test that
// gates a hierarchy node and the one-sided Moller-Trumbore test, both
// written in the operation order of their plain PyTorch versions
// (render/mesh_kernel_v2p.py:_slab_live, ops/intersect.py:_triangle_t),
// what the traversals do with a winner, and the merge of the probe's
// partial states.
// The sources are built with -fmad=false and without fast math, so every
// operation rounds as the separate PyTorch kernels of the plain versions do.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aptd {

constexpr int kCluster = 32;            // faces per cluster
constexpr int kFanout = 8;              // clusters per super, supers per hyper
constexpr int kBin = kFanout * kCluster;  // faces per bin (one super)
constexpr int kFaceRow = 19;            // v0 v1 v2 | n0 n1 n2 | material id
constexpr int kBoundsRow = 8;           // lb3 ub3 0 0
constexpr float kFltEps = 1.1920929e-07f;

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
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 normalized_safe(V3 a) {
  float n2 = dot(a, a);
  return scale(a, n2 > 0.0f ? rsqrtf(n2) : 1.0f);
}

// A ray against one AABB row: the interval [tmin, tmax] in which it overlaps
// the box.  The NaN rule is written out, because it decides the result: a
// NaN plane distance (0 * inf: the origin on a box face with a zero
// direction component) makes that axis unbounded, lo = -inf and hi = +inf,
// where fminf/fmaxf alone would drop the NaN and keep the other plane's
// distance.
__device__ __forceinline__ void slab_overlap(const float* row, V3 o, V3 inv, float* tmin_out,
                                             float* tmax_out) {
  const float os[3] = {o.x, o.y, o.z};
  const float is[3] = {inv.x, inv.y, inv.z};
  float tmin = -INFINITY, tmax = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (row[a] - os[a]) * is[a];
    float t2 = (row[a + 3] - os[a]) * is[a];
    bool nan = (t1 != t1) || (t2 != t2);
    float lo = nan ? -INFINITY : fminf(t1, t2);
    float hi = nan ? INFINITY : fmaxf(t1, t2);
    tmin = fmaxf(tmin, lo);
    tmax = fminf(tmax, hi);
  }
  *tmin_out = tmin;
  *tmax_out = tmax;
}

// Does the ray hit the box, and is the entry closer than t_run?
__device__ __forceinline__ bool slab_live(const float* row, V3 o, V3 inv, float t_run) {
  float tmin, tmax;
  slab_overlap(row, o, inv, &tmin, &tmax);
  return (tmax >= tmin) && (tmax >= 0.0f) && (fmaxf(tmin, 0.0f) < t_run);
}

// slab_live for operands under which no plane distance can be NaN: a finite
// row, a finite origin and finite, nonzero inverse direction components.
// Then (row - o) is finite or infinite and its product with inv is never
// 0 * inf, so the NaN rule's selects never fire and are left out; the
// result is slab_live's, bit for bit.
__device__ __forceinline__ bool slab_live_no_nan(const float* row, V3 o, V3 inv, float t_run) {
  const float os[3] = {o.x, o.y, o.z};
  const float is[3] = {inv.x, inv.y, inv.z};
  // x starts the interval: fmaxf(-inf, lo) = lo and fminf(inf, hi) = hi
  // for lo, hi that are not NaN
  float t1 = (row[0] - os[0]) * is[0];
  float t2 = (row[3] - os[0]) * is[0];
  float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
#pragma unroll
  for (int a = 1; a < 3; ++a) {
    t1 = (row[a] - os[a]) * is[a];
    t2 = (row[a + 3] - os[a]) * is[a];
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
  }
  return (tmax >= tmin) && (tmax >= 0.0f) && (fmaxf(tmin, 0.0f) < t_run);
}

// The distance at which a live ray enters the box (clamped at 0); +inf for a
// ray that is not live.
__device__ __forceinline__ float slab_entry(const float* row, V3 o, V3 inv, float t_run) {
  float tmin, tmax;
  slab_overlap(row, o, inv, &tmin, &tmax);
  float entry = fmaxf(tmin, 0.0f);
  return ((tmax >= tmin) && (tmax >= 0.0f) && (entry < t_run)) ? entry : INFINITY;
}

// The triangle test below in two halves, for a caller that takes the
// reciprocal of the determinant itself (mesh_binned_pair.cu).  First half:
// p = d x e2 and the determinant a = e1 . p; only a face with a >= kFltEps
// can be hit (the test is one-sided).
__device__ __forceinline__ float triangle_det(V3 e1, V3 e2, V3 d, V3* p_out) {
  V3 p = cross(d, e2);
  *p_out = p;
  return dot(e1, p);
}

// Second half, from p, whether the face is front (a >= kFltEps) and
// fi = 1 / a (read only where front): is it a hit at t > 0 (t, u, w out)?
// The reference's hit also asks t >= 0, which t > 0 implies.
__device__ __forceinline__ bool triangle_hit(V3 v0, V3 e1, V3 e2, V3 o, V3 d, V3 p, bool front,
                                             float fi, float* t_out, float* u_out,
                                             float* w_out) {
  V3 s = sub(o, v0);
  float u = fi * dot(s, p);
  V3 q = cross(s, e1);
  float w = fi * dot(d, q);
  float t = fi * dot(e2, q);
  *t_out = t;
  *u_out = u;
  *w_out = w;
  return front && u >= 0.0f && u <= 1.0f && w >= 0.0f && u + w <= 1.0f && t > 0.0f;
}

// glm one-sided Moller-Trumbore against the face with corner v0 and edges
// e1 = v1 - v0, e2 = v2 - v0: the hit distance, or +inf on a miss or a hit
// at t <= 0 (so the result is never NaN and always > 0); u and w are the
// barycentrics.
__device__ __forceinline__ float triangle_t_edges(V3 v0, V3 e1, V3 e2, V3 o, V3 d,
                                                  float* u_out, float* w_out) {
  V3 p;
  const float a = triangle_det(e1, e2, d, &p);
  float t;
  return triangle_hit(v0, e1, e2, o, d, p, a >= kFltEps, 1.0f / a, &t, u_out, w_out) ? t
                                                                                      : INFINITY;
}

// The same test against face row `fr` (v0 v1 v2 ...), its edges subtracted
// here.
__device__ __forceinline__ float triangle_t(const float* fr, V3 o, V3 d, float* u_out,
                                            float* w_out) {
  V3 v0 = v3(fr[0], fr[1], fr[2]), v1 = v3(fr[3], fr[4], fr[5]), v2 = v3(fr[6], fr[7], fr[8]);
  return triangle_t_edges(v0, sub(v1, v0), sub(v2, v0), o, d, u_out, w_out);
}

// Point (rotated barycentrics), unit normal (standard barycentrics) and
// material of the hit (u, w) on face row `fr` (intersections.h:166-168).
__device__ __forceinline__ void winner_attributes(const float* fr, float u, float w, V3* point,
                                                  V3* normal, int* mat) {
  V3 v0 = v3(fr[0], fr[1], fr[2]), v1 = v3(fr[3], fr[4], fr[5]), v2 = v3(fr[6], fr[7], fr[8]);
  V3 n0 = v3(fr[9], fr[10], fr[11]), n1 = v3(fr[12], fr[13], fr[14]),
     n2 = v3(fr[15], fr[16], fr[17]);
  float v = 1.0f - u - w;
  *point = add(add(scale(v0, u), scale(v1, w)), scale(v2, v));
  *normal = normalized_safe(add(add(scale(n0, v), scale(n1, u)), scale(n2, w)));
  *mat = (int)fr[18];
}

// A traversal's result for ray i: seven float planes of n rays and the
// material plane.
__device__ __forceinline__ void store_hit(float* out, int* mat_out, size_t n, int i, float t,
                                          V3 point, V3 normal, int mat) {
  out[i] = t;
  out[n + i] = point.x;
  out[2 * n + i] = point.y;
  out[3 * n + i] = point.z;
  out[4 * n + i] = normal.x;
  out[5 * n + i] = normal.y;
  out[6 * n + i] = normal.z;
  mat_out[i] = mat;
}

// The last step of the probe's split visit schedule: block s of `splits`
// ran the visits [s n_visits / splits, (s + 1) n_visits / splits) of the
// whole tile into its partial state, rows (kRows, n) at partial + s kRows n,
// row 0 its t.  The states are merged as the visits themselves update the
// state: in range order, a later range replacing the state only where its
// t is strictly smaller, so that a tie keeps the earlier range's winner.
// Taken as a tree: one warp per ray, each lane the first smallest t of the
// ranges lane, lane + 32, ..., then the smallest (t, range) pair of the
// warp, equal to the sequential merge.  Rows of out past kRows are 0.
template <int kRows, int kOutRows>
__global__ void __launch_bounds__(256)
    merge_visit_states(const float* __restrict__ partial, int splits, int n,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= n) return;   // a whole warp
  float best_t = INFINITY;
  int best_s = 0x7fffffff;
#pragma unroll 4
  for (int s = lane; s < splits; s += 32) {
    const float t = partial[(size_t)s * kRows * n + ray];
    if (t < best_t) {
      best_t = t;
      best_s = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, best_t, off);
    const int os = __shfl_xor_sync(0xffffffffu, best_s, off);
    if (ot < best_t || (ot == best_t && os < best_s)) {
      best_t = ot;
      best_s = os;
    }
  }
  if (lane < kOutRows)
    out[(size_t)lane * n + ray] =
        lane < kRows ? partial[((size_t)best_s * kRows + lane) * n + ray] : 0.0f;
}

// Blocks of 256 threads for merge_visit_states over n rays.
inline int merge_blocks(int n) { return (n * 32 + 255) / 256; }

}  // namespace aptd
