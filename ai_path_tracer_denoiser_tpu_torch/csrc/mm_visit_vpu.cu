// The cluster visit of a mesh traversal, repeated: what one visit costs a
// tile of 1024 rays when the 32 face tests run as scalar float32 arithmetic.
//
// Replaces the TPU kernel tools/exp_mm_feasibility.py:build_vpu_kernel
// (pl.pallas_call in run_visit_bench) of the JAX repo.  Same function: the
// state (t, point, normal, material) of each of 1024 rays starts at
// (3e38, 0...), and visit k = 0 .. n_visits - 1 fetches cluster k % 64 (32
// rows of a (2048, 128) face table, 19 columns used), runs the 32
// Moller-Trumbore tests with 3e38 as the miss value, takes the first minimal
// face and replaces the state where its t is strictly smaller.  The normal
// is the interpolated one, not normalised, and the material the row's
// column 18 as a float, as in the probe.  Out: the (8, 1024) state.
//
// Design.  One block of 1024 threads, one thread per ray, the state in
// registers: the probe asks what a visit costs ONE tile, so the launch
// fills one SM and leaves the other 131 idle.  Per visit the block stages
// the cluster's 32 x 19 floats in shared memory between two barriers (the
// probe's start + wait of one copy) and every thread tests the 32 rows from
// there, a broadcast read.  Built with -fmad=false, so the result equals
// the plain PyTorch version's bit for bit.
//
// Bound: FP32 ALU work, 32 face tests of about 60 operations per ray and
// visit; the bytes (the 1 MB table once, 64 KB of rays and state) are
// nothing beside it.
#include "mesh_common.cuh"

namespace {
using namespace aptd;

constexpr int kTile = 1024;       // rays
constexpr int kTableRow = 128;    // floats per row of the probe's face table
constexpr int kClusters = 64;     // clusters the visits cycle through
constexpr float kMiss = 3e38f;

__global__ void __launch_bounds__(kTile)
    visit_vpu_kernel(const float* __restrict__ rays, const float* __restrict__ faces,
                     int n_visits, float* __restrict__ out) {
  __shared__ float slab[kCluster * kFaceRow];
  const int i = threadIdx.x;
  const V3 o = v3(rays[i], rays[kTile + i], rays[2 * kTile + i]);
  const V3 d = v3(rays[3 * kTile + i], rays[4 * kTile + i], rays[5 * kTile + i]);
  float t_run = kMiss, mat = 0.0f;
  V3 point = v3(0.0f, 0.0f, 0.0f), normal = v3(0.0f, 0.0f, 0.0f);
  for (int visit = 0; visit < n_visits; ++visit) {
    const float* src = faces + (size_t)(visit % kClusters) * kCluster * kTableRow;
    if (i < kCluster * kFaceRow) slab[i] = src[(i / kFaceRow) * kTableRow + i % kFaceRow];
    __syncthreads();
    float t_c = INFINITY, u_c = 0.0f, w_c = 0.0f;
    int f_c = 0;
    for (int f = 0; f < kCluster; ++f) {
      float u, w;
      float t = triangle_t(slab + f * kFaceRow, o, d, &u, &w);
      t = t < INFINITY ? t : kMiss;
      if (t < t_c) {   // strict: the first minimal row
        t_c = t;
        u_c = u;
        w_c = w;
        f_c = f;
      }
    }
    if (t_c < t_run) {
      const float* fr = slab + f_c * kFaceRow;
      V3 v0 = v3(fr[0], fr[1], fr[2]), v1 = v3(fr[3], fr[4], fr[5]), v2 = v3(fr[6], fr[7], fr[8]);
      V3 n0 = v3(fr[9], fr[10], fr[11]), n1 = v3(fr[12], fr[13], fr[14]),
         n2 = v3(fr[15], fr[16], fr[17]);
      float v = 1.0f - u_c - w_c;
      t_run = t_c;
      point = add(add(scale(v0, u_c), scale(v1, w_c)), scale(v2, v));
      normal = add(add(scale(n0, v), scale(n1, u_c)), scale(n2, w_c));
      mat = fr[18];
    }
    __syncthreads();   // the slab is staged again
  }
  out[i] = t_run;
  out[kTile + i] = point.x;
  out[2 * kTile + i] = point.y;
  out[3 * kTile + i] = point.z;
  out[4 * kTile + i] = normal.x;
  out[5 * kTile + i] = normal.y;
  out[6 * kTile + i] = normal.z;
  out[7 * kTile + i] = mat;
}

}  // namespace

extern "C" int aptd_mm_visit_vpu(const float* rays, const float* faces, int n_visits, float* out,
                                 void* stream) {
  visit_vpu_kernel<<<1, kTile, 0, (cudaStream_t)stream>>>(rays, faces, n_visits, out);
  return (int)cudaGetLastError();
}
