// Closest hit of N rays against the mesh's 3-level cluster hierarchy,
// walked front to back by subtiles of 128 rays.
//
// Replaces the TPU kernel render/mesh_kernel_v3.py:_build_kernel (launched
// by _mesh_bvh_call_v3, impl "v3") of the JAX package.  Same contract as
// mesh_bvh_v2p.cu (first minimal face hit with t < t_cull per ray; t, point,
// normal, material; +inf, zeros, -1 on a miss).  What defines this kernel is
// which clusters a subtile visits, and in which order:
//   * a root-box gate: a subtile whose rays are all culled or aimed away
//     pays one slab test and leaves;
//   * per level the 8 siblings are ordered by the subtile's minimum entry
//     distance of each (+inf where no ray is live), with the same
//     19-comparator network on every thread, and visited nearest first,
//     skipping +inf: a near cluster's hit tightens the running t before its
//     occluded siblings are looked at again;
//   * a cluster is tested again against the then-current running t when its
//     copy is started (one sorted position ahead of its face tests) and once
//     more before its face tests; a cluster that passes the second test is
//     visited, and every visit is added to `visits`;
//   * because the visiting order is not the face order, the merge breaks an
//     exact tie in t by cluster index: a cluster's first minimal hit wins
//     iff t < t_run, or t == t_run, its cluster index is below the winner's
//     and t is finite.  "No winner yet" is cluster -1, below which no index
//     lies, so a tie against the t_cull seed loses, as the scene merge
//     needs.  The result is the dense scan's first minimal face whatever
//     the order.
// Which rays do the arithmetic inside a visited node, and how faces are
// fetched, is the design's choice, not part of that definition.
//
// Bound on the H100: FP32 ALU work, as for mesh_bvh_v2p.cu.  What costs
// more, and what this design does about it (csrc/mesh_tile.cuh has the
// shared pieces):
//   * Tests of rays that cannot hit.  A thread slab-tests a node's children
//     only where its ray is live in the node (the boxes are unions of their
//     children, so the others' entries are +inf anyway), and only the rays
//     live in a visited cluster test its faces, pooled and spread one per
//     warp over the 4 warps, lane f on face f, the least (t, f) the
//     cluster's first minimal hit, merged by its own thread with the tie
//     rule.
//   * The cost of a level.  The subtile's minimum entry of each sibling is
//     one redux.sync per warp over the entry's bits (an entry is >= 0 or
//     +inf, a -0 taken as +0, so the bits order as the values), written to
//     one of two alternating reduce arrays: one barrier per level.  The
//     cluster votes of one sorted position (its face-test vote and the
//     copy-start vote of the next position, taken at the same running t as
//     before) share one barrier.
//   * Face fetches.  The packed faces (1.5 KB per cluster, not the 2.4 KB
//     of the 19-column rows) go by cp.async into two shared slots, the next
//     position's copy in flight while the current one is tested (starting
//     copies two or three positions ahead was slower: PERF.md §6).  The winner's point,
//     normal and material come from the 19-column rows once per ray.
//   * Tail effects.  Blocks are persistent (one resident wave) and take
//     subtiles from a counter zeroed on the call's stream.
// A thread past n has t_cull = -inf and stays in the loops: every thread
// reaches every barrier.  Built with -fmad=false, so the result equals the
// dense scan bit for bit.
#include "mesh_tile.cuh"

namespace {
using namespace aptd;

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr unsigned kFetchNext = 1u << 8;   // exchange bit: start the next position's copy

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

// The children base .. base + 7 of `table` (`count` of them real) in
// front-to-back order for this subtile: child i of the order is
// (order >> 3 i) & 7, and only the first *n_live have a live ray.  Each
// thread's entries (+inf unless `gate`: its ray is live in the parent) go
// to its column of `ent` ([kFanout][kLanes]).
__device__ __forceinline__ unsigned sorted_children(const float* __restrict__ table, int base,
                                                    int count, bool gate, V3 o, V3 inv,
                                                    float t_run, float* ent,
                                                    unsigned (*red)[kWarps][kFanout],
                                                    int& round, int* n_live) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned (*buf)[kFanout] = red[round & 1];
  ++round;
  child_entries(table, base, count, gate, o, inv, t_run, ent, kLanes, tid);
#pragma unroll
  for (int j = 0; j < kFanout; ++j) {
    const float e = ent[j * kLanes + tid];
    // live now: the entry, a -0 as +0 (the network takes them as equal)
    const unsigned key = __float_as_uint(e < t_run ? e + 0.0f : INFINITY);
    const unsigned least = __reduce_min_sync(kAllLanes, key);
    if (lane == 0) buf[warp][j] = least;
  }
  __syncthreads();
  float v[kFanout];
  int id[kFanout];
#pragma unroll
  for (int j = 0; j < kFanout; ++j) {
    unsigned least = buf[0][j];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) least = min(least, buf[wp][j]);
    v[j] = __uint_as_float(least);
    id[j] = j;
  }
  sort8(v, id);
  unsigned order = 0;
  int live = 0;
#pragma unroll
  for (int j = 0; j < kFanout; ++j) {
    order |= (unsigned)id[j] << (3 * j);
    live += v[j] < INFINITY;
  }
  *n_live = live;
  return order;
}

struct Hit {
  float t_run, u, w;
  int face, cluster;   // the winner's face row and cluster; -1: none yet
};

// The merge of cluster k's first minimal hit (t, u, w, face f of k).
__device__ __forceinline__ void merge(Hit& r, int k, float t, float u, float w, int f) {
  if (t < r.t_run || (t == r.t_run && k < r.cluster && t < INFINITY)) {
    r.t_run = t;
    r.u = u;
    r.w = w;
    r.face = k * kCluster + f;
    r.cluster = k;
  }
}

__global__ void __launch_bounds__(kLanes)
    bvh_v3_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cull, int n, const float* __restrict__ faces,
                  const float4* __restrict__ edges, const float* __restrict__ cb,
                  const float* __restrict__ sb, const float* __restrict__ hb,
                  const float* __restrict__ root, int n_faces, int n_clusters, int n_supers,
                  int n_hypers, float* __restrict__ out, int* __restrict__ mat_out,
                  int* __restrict__ next_tile, int* __restrict__ visits) {
  __shared__ float4 slots[2][kClusterPieces];
  __shared__ float ent[3][kFanout * kLanes];    // hypers', supers', clusters' entries
  __shared__ float ray[6 * kLanes];
  __shared__ float pool_t[kLanes], res_t[kLanes], res_u[kLanes], res_w[kLanes];
  __shared__ int pool_id[kLanes], res_f[kLanes];
  __shared__ unsigned red[2][kWarps][kFanout];
  __shared__ unsigned xchg[2 * kMaxWarps];
  __shared__ int tile_slot;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int round = 0, visited = 0;
  for (;;) {
    if (tid == 0) tile_slot = atomicAdd(next_tile, 1);
    __syncthreads();
    const long long i0 = (long long)tile_slot * kLanes;
    if (i0 >= n) break;   // the whole block
    const int i = (int)i0 + tid;
    const bool real = i < n;
    const V3 o = real ? v3(ox[i], oy[i], oz[i]) : v3(0.0f, 0.0f, 0.0f);
    const V3 d = real ? v3(dx[i], dy[i], dz[i]) : v3(1.0f, 1.0f, 1.0f);
    ray[tid] = o.x;
    ray[kLanes + tid] = o.y;
    ray[2 * kLanes + tid] = o.z;
    ray[3 * kLanes + tid] = d.x;
    ray[4 * kLanes + tid] = d.y;
    ray[5 * kLanes + tid] = d.z;
    const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    Hit r;
    r.t_run = real ? t_cull[i] : -INFINITY;
    r.u = r.w = 0.0f;
    r.face = r.cluster = -1;
    const float root_entry = slab_entry(root, o, inv, INFINITY);
    if (__syncthreads_or(root_entry < r.t_run)) {
      for (int hbase = 0; hbase < n_hypers; hbase += kFanout) {
        int live_h;
        const unsigned order_h =
            sorted_children(hb, hbase, n_hypers - hbase, root_entry < r.t_run, o, inv, r.t_run,
                            ent[0], red, round, &live_h);
        for (int ih = 0; ih < live_h; ++ih) {
          const int jh = (order_h >> (3 * ih)) & 7;
          const int s0 = (hbase + jh) * kFanout;
          int live_s;
          const unsigned order_s =
              sorted_children(sb, s0, n_supers - s0, ent[0][jh * kLanes + tid] < r.t_run, o, inv,
                              r.t_run, ent[1], red, round, &live_s);
          for (int is = 0; is < live_s; ++is) {
            const int js = (order_s >> (3 * is)) & 7;
            const int c0 = (s0 + js) * kFanout;
            int live_c;
            const unsigned order_c =
                sorted_children(cb, c0, n_clusters - c0, ent[1][js * kLanes + tid] < r.t_run, o,
                                inv, r.t_run, ent[2], red, round, &live_c);
            const float* ent_c = ent[2];
            // Position 0's copy starts if one of its rays is live now.
            bool fetched =
                block_or(xchg, round, live_c > 0 && ent_c[(order_c & 7) * kLanes + tid] < r.t_run,
                         warp, lane, kWarps) != 0;
            if (fetched) fetch_cluster(slots[0], edges, c0 + (order_c & 7), tid);
            __pipeline_commit();
            for (int p = 0; p < live_c; ++p) {
              __pipeline_wait_prior(0);   // this thread's pieces of position p
              const int jp = (order_c >> (3 * p)) & 7;
              const int jn = (order_c >> (3 * (p + 1))) & 7;
              const bool live = fetched && ent_c[jp * kLanes + tid] < r.t_run;
              const bool live_next = p + 1 < live_c && ent_c[jn * kLanes + tid] < r.t_run;
              const unsigned mask = __ballot_sync(kAllLanes, live);
              // Both votes at one barrier, which also makes every thread's
              // pieces of position p's slot visible; position p - 1's readers
              // of the other slot are past it.
              const unsigned x = exchange(
                  xchg, round,
                  __popc(mask) | (__any_sync(kAllLanes, live_next) ? kFetchNext : 0u), warp,
                  lane, kWarps);
              fetched = (__reduce_or_sync(kAllLanes, x) & kFetchNext) != 0;
              if (fetched) fetch_cluster(slots[(p + 1) & 1], edges, c0 + jn, tid);
              __pipeline_commit();
              int rank;
              const int n_pool = pool_rank(x & 0xffu, mask, warp, lane, &rank);
              if (n_pool == 0) continue;   // not visited: the whole block
              ++visited;
              const int k = c0 + jp;
              if (live) {
                pool_t[rank] = INFINITY;   // every hit: the tie rule is the owner's
                pool_id[rank] = tid;
              }
              __syncthreads();
              pooled_tests(slots[p & 1], min(kCluster, n_faces - k * kCluster), ray, kLanes,
                           pool_t, pool_id, n_pool, res_t, res_u, res_w, res_f, warp, kWarps,
                           lane);
              __syncthreads();
              if (live && res_f[rank] >= 0)
                merge(r, k, res_t[rank], res_u[rank], res_w[rank], res_f[rank]);
            }
            // Nothing is in flight here: the last position starts no copy.
          }
        }
      }
    }
    if (real) {
      float t_out = INFINITY;
      V3 point = v3(0.0f, 0.0f, 0.0f), normal = v3(0.0f, 0.0f, 0.0f);
      int mat = -1;
      if (r.face >= 0) {
        t_out = r.t_run;
        winner_attributes(faces + (size_t)r.face * kFaceRow, r.u, r.w, &point, &normal, &mat);
      }
      store_hit(out, mat_out, (size_t)n, i, t_out, point, normal, mat);
    }
    __syncthreads();   // the tile slot and the ray planes are written again
  }
  if (tid == 0 && visited != 0) atomicAdd(visits, visited);
}

int resident[kMaxTileDevices][9];

}  // namespace

extern "C" int aptd_mesh_bvh_v3(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* t_cull, int n, const float* faces,
                                const float* edges, const float* cb, const float* sb,
                                const float* hb, const float* root, int n_faces, int n_clusters,
                                int n_supers, int n_hypers, float* out, int* mat_out,
                                int* next_tile, int* visits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(visits, 0, sizeof(int), s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  int wave = 0;
  err = resident_blocks(bvh_v3_kernel, kLanes, 0, resident, 0, &wave);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(next_tile, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kLanes - 1) / kLanes;
  bvh_v3_kernel<<<min(wave, tiles), kLanes, 0, s>>>(
      ox, oy, oz, dx, dy, dz, t_cull, n, faces, reinterpret_cast<const float4*>(edges), cb, sb,
      hb, root, n_faces, n_clusters, n_supers, n_hypers, out, mat_out, next_tile, visits);
  return (int)cudaGetLastError();
}
