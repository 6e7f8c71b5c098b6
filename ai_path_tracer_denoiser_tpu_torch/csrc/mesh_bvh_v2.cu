// Closest hit of N rays against the mesh's 3-level cluster hierarchy, with
// the descent gated per TILE of rays and each visited cluster staged once
// for the whole tile.
//
// Replaces the TPU kernel render/mesh_kernel.py:_build_kernel (launched by
// _mesh_bvh_call, impl "v2") of the JAX package.  Same contract as
// mesh_bvh_v2p.cu: per ray the first minimal face hit with t < t_cull, found
// by descending hypers -> supers -> clusters in index order; out t, point
// (rotated barycentrics), normal (normalized_safe) and material, or
// t = +inf, zeros and material -1 where nothing beat t_cull.  What differs
// from the per-ray kernel is what the TPU kernel differs in: a node is
// descended iff ANY ray of the tile is live in it, and a live cluster's 32
// face rows are fetched once and tested by every ray of the tile.
//
// Design.  One block per tile; the block size IS the tile (`lanes`, 128 to
// 1024 threads), so the gating granule is a launch parameter.  The vote is
// __syncthreads_or, so control flow is uniform in the block and no warp
// diverges in the tree.  At a live cluster the block copies the cluster's
// 32 x 19 floats to shared memory (the TPU kernel's serial start + wait),
// and every thread runs the 32 face tests from there: all threads read the
// same address, a broadcast.  Rays that are not live in a visited cluster
// test it all the same, which cannot change their result (every cull is
// conservative, the merge is a strict `<`).  A thread past n, or with
// t_cull = -inf, votes "not live" and stays in the loops: every thread must
// reach every barrier.  The winner's point and normal are computed once,
// after the descent.
//
// Bound on the H100: FP32 ALU work, as for mesh_bvh_v2p.cu; against the
// per-ray kernel this one trades divergence for redundant tests, since a
// tile visits the union of its rays' nodes.
#include "mesh_common.cuh"

namespace {
using namespace aptd;

__global__ void __launch_bounds__(1024)
    bvh_v2_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cull, int n, const float* __restrict__ faces,
                  const float* __restrict__ cb, const float* __restrict__ sb,
                  const float* __restrict__ hb, int n_faces, int n_clusters, int n_supers,
                  int n_hypers, float* __restrict__ out, int* __restrict__ mat_out) {
  __shared__ float slab[kCluster * kFaceRow];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < n;
  // the padded tail: a ray that nothing can be live for
  V3 o = real ? v3(ox[i], oy[i], oz[i]) : v3(0.0f, 0.0f, 0.0f);
  V3 d = real ? v3(dx[i], dy[i], dz[i]) : v3(1.0f, 1.0f, 1.0f);
  float t_run = real ? t_cull[i] : -INFINITY;
  V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float best_u = 0.0f, best_w = 0.0f;
  int best_f = -1;
  for (int h = 0; h < n_hypers; ++h) {
    if (!__syncthreads_or(slab_live(hb + h * kBoundsRow, o, inv, t_run))) continue;
    int s_end = min(h * kFanout + kFanout, n_supers);
    for (int s = h * kFanout; s < s_end; ++s) {
      if (!__syncthreads_or(slab_live(sb + s * kBoundsRow, o, inv, t_run))) continue;
      int c_end = min(s * kFanout + kFanout, n_clusters);
      for (int c = s * kFanout; c < c_end; ++c) {
        // The vote is also the barrier that separates the last cluster's
        // face tests from this cluster's staging.
        if (!__syncthreads_or(slab_live(cb + c * kBoundsRow, o, inv, t_run))) continue;
        const float* src = faces + (size_t)c * kCluster * kFaceRow;
        for (int j = threadIdx.x; j < kCluster * kFaceRow; j += blockDim.x) slab[j] = src[j];
        __syncthreads();
        int f_count = min(kCluster, n_faces - c * kCluster);
        for (int f = 0; f < f_count; ++f) {
          float u, w;
          float t = triangle_t(slab + f * kFaceRow, o, d, &u, &w);
          if (t < t_run) {   // strict: the earlier face keeps ties
            t_run = t;
            best_u = u;
            best_w = w;
            best_f = c * kCluster + f;
          }
        }
      }
    }
  }
  if (!real) return;   // no barrier below
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

extern "C" int aptd_mesh_bvh_v2(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* t_cull, int n, int lanes, const float* faces,
                                const float* cb, const float* sb, const float* hb, int n_faces,
                                int n_clusters, int n_supers, int n_hypers, float* out,
                                int* mat_out, void* stream) {
  const int blocks = (n + lanes - 1) / lanes;
  if (blocks > 0) {
    bvh_v2_kernel<<<blocks, lanes, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, t_cull, n, faces, cb, sb, hb, n_faces, n_clusters, n_supers,
        n_hypers, out, mat_out);
  }
  return (int)cudaGetLastError();
}
