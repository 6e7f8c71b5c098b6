// Closest hit of N rays against the mesh's 3-level cluster hierarchy, with
// the descent gated per TILE of rays.
//
// Replaces the TPU kernel render/mesh_kernel.py:_build_kernel (launched by
// _mesh_bvh_call, impl "v2") of the JAX package.  Same contract as
// mesh_bvh_v2p.cu: per ray the first minimal face hit with t < t_cull, found
// by descending hypers -> supers -> clusters in index order; out t, point
// (rotated barycentrics), normal (normalized_safe) and material, or
// t = +inf, zeros and material -1 where nothing beat t_cull.  What defines
// this kernel is which clusters it visits: a tile of `lanes` rays (128 to
// 1024, a multiple of 128) visits cluster c iff at least one of its rays is
// live in c (hits its box and enters it before the ray's running t) at c's
// turn in index order, and every visited cluster is added to `visits`.
// Which rays do the arithmetic inside a visited cluster, and how faces are
// fetched, is the design's choice, not part of that definition.
//
// Bound on the H100: FP32 ALU work, as for mesh_bvh_v2p.cu: about 60
// operations per face test and 27 per slab test where a ray is live.  What
// costs more, and what this design does about it (csrc/mesh_tile.cuh has
// the shared pieces):
//   * Tests of rays that cannot hit.  Only the rays live in a visited
//     cluster test its faces, pooled and spread one per warp over the
//     block, so that a cluster with few live rays costs a few warp-steps,
//     not 32 face tests on one warp while the block waits.  (Testing a
//     warp's live rays lane by lane, each against the 32 faces in turn, was
//     slower on every frame measured: PERF.md §6.)  A thread
//     slab-tests a node's children only where its ray is live in the node:
//     the boxes are unions of their children (ops/bvh.py).
//   * Dependent steps per node.  On entering a hyper (super) each thread
//     computes the entries of all eight children at once into its column of
//     shared memory; the block's OR of the children live on entry lists the
//     only candidates (t_run only falls); at a candidate's turn the block
//     votes on `entry < t_run`, one barrier per candidate cluster.  A
//     hyper's or super's own vote is implied by its children's and is left
//     out: a node that no ray is live in has no live child.
//   * Face fetches.  A candidate cluster's packed faces (1.5 KB) are copied
//     by cp.async into one of two shared slots; the next candidate's copy
//     is issued as soon as the vote on the current one has passed, so it
//     lands while the current faces are tested.  The winner's point, normal
//     and material come from the 19-column rows once per ray.
//   * Tail effects.  Blocks are persistent (one resident wave) and take
//     tiles from a counter zeroed on the call's stream.  The block is the
//     tile: `lanes` threads, one ray each.
// Every cull is conservative and each ray's running t evolves as in a
// per-ray walk in index order, so the result equals the dense scan bit for
// bit (built with -fmad=false).  A thread past n, or with t_cull = -inf,
// is dead and stays in the loops: every thread reaches every barrier.
#include "mesh_tile.cuh"

namespace {
using namespace aptd;

constexpr int kMaxLanes = 1024;

// Dynamic shared memory of a block of `lanes` threads: two face slots, the
// children's entries of the current super and cluster level, the ray
// planes, the pool and its results, the exchange words and the tile slot.
__host__ __device__ constexpr size_t shared_bytes(int lanes) {
  return 2 * kClusterPieces * sizeof(float4) +
         (size_t)(2 * kFanout + 6 + 6) * sizeof(float) * lanes +
         (2 * kMaxWarps + 1) * sizeof(unsigned);
}

__global__ void __launch_bounds__(kMaxLanes)
    bvh_v2_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cull, int n, const float* __restrict__ faces,
                  const float4* __restrict__ edges, const float* __restrict__ cb,
                  const float* __restrict__ sb, const float* __restrict__ hb, int n_faces,
                  int n_clusters, int n_supers, int n_hypers, float* __restrict__ out,
                  int* __restrict__ mat_out, int* __restrict__ next_tile,
                  int* __restrict__ visits) {
  extern __shared__ float4 smem[];
  const int lanes = blockDim.x, warps = lanes >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float4* stage = smem;                                   // [2][kClusterPieces]
  float* ent_s = reinterpret_cast<float*>(smem + 2 * kClusterPieces);   // [kFanout][lanes]
  float* ent_c = ent_s + kFanout * lanes;                  // [kFanout][lanes]
  float* ray = ent_c + kFanout * lanes;                    // [6][lanes]
  float* pool_t = ray + 6 * lanes;
  int* pool_id = reinterpret_cast<int*>(pool_t + lanes);
  float* res_t = reinterpret_cast<float*>(pool_id + lanes);
  float* res_u = res_t + lanes;
  float* res_w = res_u + lanes;
  int* res_f = reinterpret_cast<int*>(res_w + lanes);
  unsigned* xchg = reinterpret_cast<unsigned*>(res_f + lanes);   // [2][kMaxWarps]
  int* tile_slot = reinterpret_cast<int*>(xchg + 2 * kMaxWarps);
  int round = 0, visited = 0;
  for (;;) {
    if (tid == 0) *tile_slot = atomicAdd(next_tile, 1);
    __syncthreads();
    const long long i0 = (long long)*tile_slot * lanes;
    if (i0 >= n) break;   // the whole block
    const int i = (int)i0 + tid;
    const bool real = i < n;
    const V3 o = real ? v3(ox[i], oy[i], oz[i]) : v3(0.0f, 0.0f, 0.0f);
    const V3 d = real ? v3(dx[i], dy[i], dz[i]) : v3(1.0f, 1.0f, 1.0f);
    float t_run = real ? t_cull[i] : -INFINITY;
    ray[tid] = o.x;
    ray[lanes + tid] = o.y;
    ray[2 * lanes + tid] = o.z;
    ray[3 * lanes + tid] = d.x;
    ray[4 * lanes + tid] = d.y;
    ray[5 * lanes + tid] = d.z;
    const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    const bool active = t_run > -INFINITY;   // false for -inf (and NaN): nothing can be live
    float best_u = 0.0f, best_w = 0.0f;
    int best_f = -1;
    for (int h = 0; h < n_hypers; ++h) {
      const bool live_h = active && slab_live(hb + (size_t)h * kBoundsRow, o, inv, t_run);
      const int s0 = h * kFanout;
      const unsigned supers = block_or(
          xchg, round,
          child_entries(sb, s0, n_supers - s0, live_h, o, inv, t_run, ent_s, lanes, tid), warp,
          lane, warps);
      for (unsigned sm = supers; sm != 0; sm &= sm - 1) {
        const int js = __ffs(sm) - 1;
        const bool live_s = ent_s[js * lanes + tid] < t_run;
        const int c0 = (s0 + js) * kFanout;
        unsigned clusters = block_or(
            xchg, round,
            child_entries(cb, c0, n_clusters - c0, live_s, o, inv, t_run, ent_c, lanes, tid),
            warp, lane, warps);
        if (clusters == 0) continue;
        // the first candidate's faces; its slot's readers are past the
        // barrier above
        int slot = 0;
        fetch_cluster(stage, edges, c0 + __ffs(clusters) - 1, tid);
        __pipeline_commit();
        while (clusters != 0) {
          const int jc = __ffs(clusters) - 1;
          clusters &= clusters - 1;
          const int c = c0 + jc;
          __pipeline_wait_prior(0);   // this thread's pieces of cluster c
          const bool live = ent_c[jc * lanes + tid] < t_run;
          const unsigned mask = __ballot_sync(kAllLanes, live);
          // The vote (K7's definition), which is also the barrier that makes
          // every thread's pieces of the slot visible and after which no
          // thread reads the other slot any more.
          const unsigned count = exchange(xchg, round, __popc(mask), warp, lane, warps);
          if (clusters != 0)
            fetch_cluster(stage + (slot ^ 1) * kClusterPieces, edges, c0 + __ffs(clusters) - 1,
                          tid);
          __pipeline_commit();
          const float4* st = stage + slot * kClusterPieces;
          slot ^= 1;
          int rank;
          const int n_pool = pool_rank(count, mask, warp, lane, &rank);
          if (n_pool == 0) continue;   // not visited: the whole block
          ++visited;
          if (live) {
            pool_t[rank] = t_run;
            pool_id[rank] = tid;
          }
          __syncthreads();
          pooled_tests(st, min(kCluster, n_faces - c * kCluster), ray, lanes, pool_t, pool_id,
                       n_pool, res_t, res_u, res_w, res_f, warp, warps, lane);
          __syncthreads();
          if (live && res_f[rank] >= 0) {   // strict below t_run: earlier faces keep ties
            t_run = res_t[rank];
            best_u = res_u[rank];
            best_w = res_w[rank];
            best_f = c * kCluster + res_f[rank];
          }
        }
      }
    }
    if (real) {
      float t_out = INFINITY;
      V3 point = v3(0.0f, 0.0f, 0.0f), normal = v3(0.0f, 0.0f, 0.0f);
      int mat = -1;
      if (best_f >= 0) {
        t_out = t_run;
        winner_attributes(faces + (size_t)best_f * kFaceRow, best_u, best_w, &point, &normal,
                          &mat);
      }
      store_hit(out, mat_out, (size_t)n, i, t_out, point, normal, mat);
    }
    __syncthreads();   // the tile slot and the ray planes are written again
  }
  if (tid == 0 && visited != 0) atomicAdd(visits, visited);
}

int resident[kMaxTileDevices][9];   // per device and lanes / 128
bool sized[kMaxTileDevices];        // the dynamic shared memory cap is set

}  // namespace

extern "C" int aptd_mesh_bvh_v2(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* t_cull, int n, int lanes, const float* faces,
                                const float* edges, const float* cb, const float* sb,
                                const float* hb, int n_faces, int n_clusters, int n_supers,
                                int n_hypers, float* out, int* mat_out, int* next_tile,
                                int* visits, void* stream) {
  if (lanes <= 0 || lanes % 128 != 0 || lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(visits, 0, sizeof(int), s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxTileDevices) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(bvh_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared_bytes(kMaxLanes));
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const size_t smem = shared_bytes(lanes);
  int wave = 0;
  err = resident_blocks(bvh_v2_kernel, lanes, smem, resident, lanes / 128, &wave);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(next_tile, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + lanes - 1) / lanes;
  bvh_v2_kernel<<<min(wave, tiles), lanes, smem, s>>>(
      ox, oy, oz, dx, dy, dz, t_cull, n, faces, reinterpret_cast<const float4*>(edges), cb, sb,
      hb, n_faces, n_clusters, n_supers, n_hypers, out, mat_out, next_tile, visits);
  return (int)cudaGetLastError();
}
