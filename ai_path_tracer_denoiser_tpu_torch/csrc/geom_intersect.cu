// Analytic-geom closest hit K10: every ray against every geom in one launch.
//
// Replaces no TPU kernel.  The JAX package's ops/intersect.py:
// intersect_geoms_v is plain array code, which XLA fuses into a few loops on
// the TPU.  The port's plain version (ops/intersect.py:intersect_geoms_plain)
// runs it operation by operation: about 60 tensor operations per geom, some
// 1,220 ATen operations per call on a scene of six cubes, at every bounce of
// the plain wavefront (render/wavefront.py:trace_iteration).  The card sat
// idle while the host dispatched them.  K10 computes the same query in one
// launch, with the same contract: per ray, every geom tested in order, t
// kept where it is > 0, a strict `<` so that the first geom wins a tie, and
// the winner's t, world point, world normal, outside flag and material id;
// t = +inf, zero vectors, false and -1 where no geom is hit.
//
// What bounds it on the H100: float32 issue.  A box test is about 115
// operations and 269 SASS instructions (K1's count, PERF.md), a sphere test
// 95 and 180, the winner's normal 25; the bytes are 24 in and 33 out per
// ray (render/cuda_backend.py:geoms_work).  At 640,000 rays and six boxes
// that is 36.5 MB (10.9 us at 3.35 TB/s) and about 0.46 GFLOP (6.8 us at
// 67 TFLOP/s); built with -fmad=false the card issues one
// operation per lane and cycle where the peak counts two, and the divides and
// square roots take several instructions, so the issue limit is near 30 us.
//
// Design.
// * One thread per ray, every lane: dead lanes are tested too, as in the
//   plain version, so that every output plane matches it bit for bit.
// * The geom table in shared memory.  Each block stages the geoms' three
//   (G, 4, 4) matrices, straight from the device tensors of Geoms, into
//   K1's 48-float rows (geom_common.cuh), with the types and material ids,
//   kChunk geoms at a time, so any number of geoms fits.  Every thread then
//   reads each geom as a broadcast.  Nothing is read back to the host.
// * The winner's normal only, as K1: the geom loop keeps t, the world point
//   and what the winner's normal needs; the transform and normalisation run
//   once per chunk that changed the winner (once per ray for a scene of up
//   to kChunk geoms), on the same operands, so the normal has the same bits.
// * Outputs as planes, written once, coalesced: a (7, N) float32 buffer of
//   t, point xyz and normal xyz, a bool plane and an int32 plane.
//
// Floating point: built with -fmad=false (render/cuda_backend.py's flags),
// IEEE division and sqrt (no fast math), rsqrtf as torch.rsqrt: the box
// and sphere tests are K1's, held bit for bit against the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "geom_common.cuh"

namespace {
using namespace aptd_geom;

constexpr int kThreads = 256;
constexpr int kChunk = 64;     // geoms staged at a time: 12 KB of matrices

__global__ void __launch_bounds__(kThreads)
    geom_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz, int n,
                const float* __restrict__ xform, const float* __restrict__ inverse,
                const float* __restrict__ inv_t, const int* __restrict__ gtype,
                const int* __restrict__ gmat, int n_geoms, float* __restrict__ out,
                bool* __restrict__ outside, int* __restrict__ mat) {
  __shared__ float s_geo[kChunk * kGeomRow];
  __shared__ int s_type[kChunk];
  __shared__ int s_mat[kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = v3(0.0f, 0.0f, 0.0f);
  if (live) {
    o = v3(ox[i], oy[i], oz[i]);
    d = v3(dx[i], dy[i], dz[i]);
  }
  float t_best = INFINITY;
  V3 p_best = v3(0.0f, 0.0f, 0.0f), n_best = v3(0.0f, 0.0f, 0.0f);
  bool out_best = false;
  int mat_best = -1;
  for (int base = 0; base < n_geoms; base += kChunk) {
    const int m = min(kChunk, n_geoms - base);
    __syncthreads();                 // the previous chunk is read
    for (int k = threadIdx.x; k < m * kGeomRow; k += kThreads) {
      const int g = k / kGeomRow, c = k - g * kGeomRow;
      const float* src = c < 16 ? xform : (c < 32 ? inverse : inv_t);
      s_geo[k] = src[(size_t)(base + g) * 16 + (c & 15)];
    }
    for (int g = threadIdx.x; g < m; g += kThreads) {
      s_type[g] = gtype[base + g];
      s_mat[g] = gmat[base + g];
    }
    __syncthreads();
    if (!live) continue;
    int win = -1;                    // this chunk's winner, and what its normal needs
    V3 win_q = v3(0.0f, 0.0f, 0.0f);
    bool win_pos = false;
#pragma unroll 1
    for (int g = 0; g < m; ++g) {
      const float* row = s_geo + g * kGeomRow;
      V3 p, q;
      bool pos = false, outs;
      float t;
      if (s_type[g] == kCube) {
        t = box_test(row, row + 16, o, d, &p, &q, &outs);
      } else {
        t = sphere_test(row, row + 16, o, d, &p, &q, &pos);
        outs = pos;
      }
      t = t > 0.0f ? t : INFINITY;
      if (t < t_best) {              // strict: the first geom wins a tie
        t_best = t;
        p_best = p;
        out_best = outs;
        mat_best = s_mat[g];
        win = g;
        win_q = q;
        win_pos = pos;
      }
    }
    if (win >= 0)
      n_best = geom_normal(s_geo + win * kGeomRow, s_type[win] == kCube, win_q, win_pos);
  }
  if (!live) return;
  const size_t stride = (size_t)n;
  out[i] = t_best;
  out[stride + i] = p_best.x;
  out[2 * stride + i] = p_best.y;
  out[3 * stride + i] = p_best.z;
  out[4 * stride + i] = n_best.x;
  out[5 * stride + i] = n_best.y;
  out[6 * stride + i] = n_best.z;
  outside[i] = out_best;
  mat[i] = mat_best;
}

}  // namespace

// Rays [0, n) given as six float32 planes against n_geoms geoms ((G, 4, 4)
// float32 matrices, int32 types and material ids).  Writes out (7, n):
// t | point xyz | normal xyz, outside (n,) bool, mat (n,) int32.
extern "C" int aptd_geom_intersect(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz, int n,
                                   const float* xform, const float* inverse,
                                   const float* inv_t, const int* gtype, const int* gmat,
                                   int n_geoms, float* out, bool* outside, int* mat,
                                   void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    geom_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, n, xform, inverse, inv_t, gtype, gmat, n_geoms, out, outside,
        mat);
  }
  return (int)cudaGetLastError();
}
