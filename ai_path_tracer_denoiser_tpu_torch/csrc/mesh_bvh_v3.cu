// Closest hit of N rays against the mesh's 3-level cluster hierarchy,
// walked front to back by subtiles of 128 rays.
//
// Replaces the TPU kernel render/mesh_kernel_v3.py:_build_kernel (launched
// by _mesh_bvh_call_v3, impl "v3") of the JAX package.  Same contract as
// mesh_bvh_v2p.cu (first minimal face hit with t < t_cull per ray; t, point,
// normal, material; +inf, zeros, -1 on a miss).  What it does differently is
// what the TPU kernel does differently:
//   * a root-box gate: a subtile whose rays are all culled or aimed away
//     pays one slab test and leaves;
//   * per level the 8 siblings are slab-tested at once, the subtile's
//     minimum entry distance of each (+inf where no ray is live) is reduced
//     over the block, every thread runs the same 19-comparator sorting
//     network on the 8 distances, and the level is visited nearest first,
//     skipping +inf: a near cluster's hit tightens the running t before its
//     occluded siblings are looked at again;
//   * a cluster's liveness is tested again against the then-current running
//     t when its copy is started and once more before its 32 face tests;
//   * the face slabs of a super's clusters go to 8 shared-memory slots by
//     cp.async, started kLookahead = 3 sorted positions ahead of the face
//     tests that consume them;
//   * because the visiting order is not the face order, the merge breaks an
//     exact tie in t by cluster index: a candidate wins iff t < t_run, or
//     t == t_run, its cluster index is below the winner's and t is finite.
//     "No winner yet" is cluster -1, below which no index lies, so a tie
//     against the t_cull seed loses, as the scene merge needs.  Within a
//     cluster the faces run in ascending order with a strict `<`.  The
//     result is the dense scan's first minimal face whatever the order.
//
// Design.  One block of 128 threads per subtile, one thread per ray; votes
// are __syncthreads_or, so control flow is uniform in the block.  The sorted
// order of a level is packed into one register (8 x 3 bits) with the count
// of live siblings, so the three nested level loops stay rolled.  A cp.async
// group is committed at every start position whether or not a copy was
// issued, so "all but the newest kLookahead groups" is always the group the
// consumer needs.  A thread past n has t_cull = -inf and stays in the loops.
//
// Bound on the H100: FP32 ALU work, as for mesh_bvh_v2p.cu.
#include <cuda_pipeline.h>

#include "mesh_common.cuh"

namespace {
using namespace aptd;

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kLookahead = 3;
constexpr int kSlab = kCluster * kFaceRow;       // floats of one cluster's faces
static_assert((kSlab * sizeof(float)) % 16 == 0, "slabs are copied in 16-byte pieces");
constexpr int kSlabChunks = kSlab * sizeof(float) / 16;

struct Ray {
  V3 o, d, inv;
  float t_run, u, w;
  int face, cluster;   // the winner's face row and cluster; -1: none yet
};

// Batcher's odd-even merge sort for 8 elements (19 comparators).
__device__ __forceinline__ void sort8(float (&v)[kFanout], int (&id)[kFanout]) {
#define APTD_CSWAP(a, b)            \
  if (v[a] > v[b]) {                \
    float tv = v[a];                \
    v[a] = v[b];                    \
    v[b] = tv;                      \
    int ti = id[a];                 \
    id[a] = id[b];                  \
    id[b] = ti;                     \
  }
  APTD_CSWAP(0, 1) APTD_CSWAP(2, 3) APTD_CSWAP(4, 5) APTD_CSWAP(6, 7)
  APTD_CSWAP(0, 2) APTD_CSWAP(1, 3) APTD_CSWAP(4, 6) APTD_CSWAP(5, 7)
  APTD_CSWAP(1, 2) APTD_CSWAP(5, 6) APTD_CSWAP(0, 4) APTD_CSWAP(3, 7)
  APTD_CSWAP(1, 5) APTD_CSWAP(2, 6) APTD_CSWAP(1, 4) APTD_CSWAP(3, 6)
  APTD_CSWAP(2, 4) APTD_CSWAP(3, 5) APTD_CSWAP(3, 4)
#undef APTD_CSWAP
}

// The children base .. base + 7 of `table` (rows past n_rows do not exist)
// in front-to-back order for this subtile: child i of the order is
// (order >> 3 i) & 7, and only the first *n_live have a live ray.
__device__ __forceinline__ unsigned sorted_children(const float* __restrict__ table, int base,
                                                    int n_rows, const Ray& r,
                                                    float (*red)[kFanout], int* n_live) {
  float v[kFanout];
  int id[kFanout];
#pragma unroll
  for (int c = 0; c < kFanout; ++c) {
    float e = (base + c < n_rows)
                  ? slab_entry(table + (size_t)(base + c) * kBoundsRow, r.o, r.inv, r.t_run)
                  : INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e = fminf(e, __shfl_xor_sync(0xffffffffu, e, off));
    v[c] = e;
    id[c] = c;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kFanout; ++c) red[warp][c] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kFanout; ++c) {
    float e = red[0][c];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) e = fminf(e, red[wp][c]);
    v[c] = e;
  }
  __syncthreads();   // `red` may be written again
  sort8(v, id);
  unsigned order = 0;
  int live = 0;
#pragma unroll
  for (int c = 0; c < kFanout; ++c) {
    order |= (unsigned)id[c] << (3 * c);
    live += v[c] < INFINITY;
  }
  *n_live = live;
  return order;
}

__global__ void __launch_bounds__(kLanes)
    bvh_v3_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cull, int n, const float* __restrict__ faces,
                  const float* __restrict__ cb, const float* __restrict__ sb,
                  const float* __restrict__ hb, const float* __restrict__ root, int n_faces,
                  int n_clusters, int n_supers, int n_hypers, float* __restrict__ out,
                  int* __restrict__ mat_out) {
  __shared__ __align__(16) float slabs[kFanout][kSlab];
  __shared__ float red[kWarps][kFanout];
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const bool real = i < n;
  Ray r;
  r.o = real ? v3(ox[i], oy[i], oz[i]) : v3(0.0f, 0.0f, 0.0f);
  r.d = real ? v3(dx[i], dy[i], dz[i]) : v3(1.0f, 1.0f, 1.0f);
  r.inv = v3(1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z);
  r.t_run = real ? t_cull[i] : -INFINITY;
  r.u = r.w = 0.0f;
  r.face = r.cluster = -1;

  if (__syncthreads_or(slab_live(root, r.o, r.inv, r.t_run))) {
    for (int hbase = 0; hbase < n_hypers; hbase += kFanout) {
      int live_h;
      unsigned order_h = sorted_children(hb, hbase, n_hypers, r, red, &live_h);
      for (int ih = 0; ih < live_h; ++ih) {
        const int h = hbase + ((order_h >> (3 * ih)) & 7);
        int live_s;
        unsigned order_s = sorted_children(sb, h * kFanout, n_supers, r, red, &live_s);
        for (int is = 0; is < live_s; ++is) {
          const int s = h * kFanout + ((order_s >> (3 * is)) & 7);
          int live_c;
          unsigned order_c = sorted_children(cb, s * kFanout, n_clusters, r, red, &live_c);
          unsigned started = 0;   // bit p: the copy of sorted position p was issued
          // Position p's copy is started kLookahead positions before its
          // face tests; one group is committed per position, copy or not.
          for (int p = -kLookahead; p < live_c; ++p) {
            const int ps = p + kLookahead;
            if (ps < live_c) {
              const int k = s * kFanout + ((order_c >> (3 * ps)) & 7);
              if (__syncthreads_or(slab_live(cb + (size_t)k * kBoundsRow, r.o, r.inv, r.t_run))) {
                const float4* src = reinterpret_cast<const float4*>(faces + (size_t)k * kSlab);
                float4* dst = reinterpret_cast<float4*>(slabs[ps]);
                for (int j = threadIdx.x; j < kSlabChunks; j += kLanes)
                  __pipeline_memcpy_async(dst + j, src + j, sizeof(float4));
                started |= 1u << ps;
              }
            }
            __pipeline_commit();
            if (p < 0 || !((started >> p) & 1u)) continue;
            __pipeline_wait_prior(kLookahead);
            const int k = s * kFanout + ((order_c >> (3 * p)) & 7);
            // The vote is also the barrier that makes every thread's pieces
            // of the slab visible to the block.
            if (!__syncthreads_or(slab_live(cb + (size_t)k * kBoundsRow, r.o, r.inv, r.t_run)))
              continue;
            float t_c = INFINITY, u_c = 0.0f, w_c = 0.0f;
            int f_c = 0;
            const int f_count = min(kCluster, n_faces - k * kCluster);
            for (int f = 0; f < f_count; ++f) {
              float u, w;
              float t = triangle_t(slabs[p] + f * kFaceRow, r.o, r.d, &u, &w);
              if (t < t_c) {   // strict: the earlier face of the cluster keeps ties
                t_c = t;
                u_c = u;
                w_c = w;
                f_c = f;
              }
            }
            if (t_c < r.t_run || (t_c == r.t_run && k < r.cluster && t_c < INFINITY)) {
              r.t_run = t_c;
              r.u = u_c;
              r.w = w_c;
              r.face = k * kCluster + f_c;
              r.cluster = k;
            }
          }
          // Nothing is in flight here: a position whose copy was started is
          // waited for above, whether or not its face tests then run.
        }
      }
    }
  }
  if (!real) return;   // no barrier below
  float t_out = INFINITY;
  V3 point = v3(0.0f, 0.0f, 0.0f), normal = v3(0.0f, 0.0f, 0.0f);
  int mat = -1;
  if (r.face >= 0) {
    t_out = r.t_run;
    winner_attributes(faces + (size_t)r.face * kFaceRow, r.u, r.w, &point, &normal, &mat);
  }
  store_hit(out, mat_out, (size_t)n, i, t_out, point, normal, mat);
}

}  // namespace

extern "C" int aptd_mesh_bvh_v3(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* t_cull, int n, const float* faces, const float* cb,
                                const float* sb, const float* hb, const float* root, int n_faces,
                                int n_clusters, int n_supers, int n_hypers, float* out,
                                int* mat_out, void* stream) {
  const int blocks = (n + kLanes - 1) / kLanes;
  if (blocks > 0) {
    bvh_v3_kernel<<<blocks, kLanes, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, t_cull, n, faces, cb, sb, hb, root, n_faces, n_clusters,
        n_supers, n_hypers, out, mat_out);
  }
  return (int)cudaGetLastError();
}
