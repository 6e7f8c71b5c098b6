// Closest hit of N rays against the mesh's 3-level cluster hierarchy.
//
// Replaces the TPU kernel render/mesh_kernel_v2p.py:_build_kernel (launched
// by _mesh_bvh_call_v2p, for both its "v2p" and its "v2s" mode) of the JAX
// package.  Same contract: per ray the first minimal face hit with
// t < t_cull, found by descending hypers -> supers -> clusters in index
// order, each node gated on the slab test against the running t, each
// visited cluster's 32 faces tested in ascending order with a strict `<`;
// out t, point (rotated barycentrics), normal (normalized_safe) and
// material, or t = +inf, zeros and material -1 where nothing beat t_cull.
// A lane with t_cull = -inf leaves at once.
//
// Design.  One thread per ray, the running t and the winner's (u, w, face)
// in registers; the loops run over the real node counts, and a node is
// gated on this ray's own slab test (the TPU kernel gates on "any ray of
// the 1024-lane tile", which is only less strict, so results are equal).
// The winner's point and normal are computed once, after the descent, from
// its face row.  Bounds and face rows are read from global memory through
// the caches: the largest shipped face table (81,920 x 19 floats, 6.2 MB)
// stays in the 50 MB L2.  Nothing is staged in shared memory, and
// neighbouring rays that diverge in the tree serialise within their warp;
// that is what a faster version would attack.
//
// Bound on the H100: FP32 ALU work (about 60 operations per face test and
// 27 per node test, only for the nodes a ray is live in); the bytes are 28
// in and 32 out per ray plus the tables once.
#include "mesh_common.cuh"

namespace {
using namespace aptd;

__global__ void __launch_bounds__(128)
    bvh_v2p_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ t_cull, int n, const float* __restrict__ faces,
                   const float* __restrict__ cb, const float* __restrict__ sb,
                   const float* __restrict__ hb, int n_faces, int n_clusters, int n_supers,
                   int n_hypers, float* __restrict__ out, int* __restrict__ mat_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V3 o = v3(ox[i], oy[i], oz[i]);
  V3 d = v3(dx[i], dy[i], dz[i]);
  float t_run = t_cull[i];
  float best_u = 0.0f, best_w = 0.0f;
  int best_f = -1;
  if (t_run > -INFINITY) {   // false for -inf (and NaN): nothing can be live
    V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    for (int h = 0; h < n_hypers; ++h) {
      if (!slab_live(hb + h * kBoundsRow, o, inv, t_run)) continue;
      int s_end = min(h * kFanout + kFanout, n_supers);
      for (int s = h * kFanout; s < s_end; ++s) {
        if (!slab_live(sb + s * kBoundsRow, o, inv, t_run)) continue;
        int c_end = min(s * kFanout + kFanout, n_clusters);
        for (int c = s * kFanout; c < c_end; ++c) {
          if (!slab_live(cb + c * kBoundsRow, o, inv, t_run)) continue;
          int f_end = min(c * kCluster + kCluster, n_faces);
          for (int f = c * kCluster; f < f_end; ++f) {
            float u, w;
            float t = triangle_t(faces + (size_t)f * kFaceRow, o, d, &u, &w);
            if (t < t_run) {   // strict: the earlier face keeps ties
              t_run = t;
              best_u = u;
              best_w = w;
              best_f = f;
            }
          }
        }
      }
    }
  }
  float t_out = INFINITY;
  V3 point = v3(0.0f, 0.0f, 0.0f), normal = v3(0.0f, 0.0f, 0.0f);
  int mat = -1;
  if (best_f >= 0) {
    t_out = t_run;
    winner_attributes(faces + (size_t)best_f * kFaceRow, best_u, best_w, &point, &normal, &mat);
  }
  store_hit(out, mat_out, (size_t)n, i, t_out, point, normal, mat);
}

}  // namespace

extern "C" int aptd_mesh_bvh_v2p(const float* ox, const float* oy, const float* oz,
                                 const float* dx, const float* dy, const float* dz,
                                 const float* t_cull, int n, const float* faces, const float* cb,
                                 const float* sb, const float* hb, int n_faces, int n_clusters,
                                 int n_supers, int n_hypers, float* out, int* mat_out,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    bvh_v2p_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, t_cull, n, faces, cb, sb, hb, n_faces, n_clusters, n_supers,
        n_hypers, out, mat_out);
  }
  return (int)cudaGetLastError();
}
