// Shared device code of the two tile traversals, mesh_bvh_v2.cu (K7: a tile
// of `lanes` rays descends the hierarchy in index order) and mesh_bvh_v3.cu
// (K8: subtiles of 128 rays walk it front to back).  Both are persistent
// blocks of one thread per ray that take tiles from a counter; both gate a
// node on a block-wide vote, which is their definition; and both test a
// visited cluster's faces only for the rays that are live in it, ray by
// ray: those rays are pooled and spread over all warps of the block, one
// ray per warp at a time; lane f tests face f, and the least (t, f) among
// the faces with t below the ray's limit wins: redux.sync's minimum over the
// bits of t (a hit's t is > 0 and never NaN, and positive floats order as
// their bits), then the lowest lane holding it (ballot, ffs), as in
// mesh_bvh_v2p.cu.  That is what the sequential scan with a strict `<`
// keeps.  The winner goes back to the ray's own thread through shared
// memory.
// Faces come from the packed (v0, e1, e2) table (mesh_kernel_v2p.py:
// packed_faces), copied by cp.async into a shared-memory slot.
#pragma once

#include <cuda_pipeline.h>

#include "mesh_common.cuh"

namespace aptd {

constexpr int kMaxWarps = 32;                      // warps of the largest block
constexpr int kFacePieces = 3;                     // float4 per packed face: v0 e1 | e1 e2 | e2 0
constexpr int kClusterPieces = kCluster * kFacePieces;   // 96 16-byte pieces, 1.5 KB
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;           // above the bits of every positive float
constexpr int kMaxTileDevices = 64;

struct EdgeFace {
  V3 v0, e1, e2;
};

// Face f of a staged cluster.
__device__ __forceinline__ EdgeFace staged_face(const float4* st, int f) {
  const float4 a = st[f * kFacePieces], b = st[f * kFacePieces + 1],
               c = st[f * kFacePieces + 2];
  EdgeFace r;
  r.v0 = v3(a.x, a.y, a.z);
  r.e1 = v3(a.w, b.x, b.y);
  r.e2 = v3(b.z, b.w, c.x);
  return r;
}

// Start copying cluster c of the packed table into `slot`: thread i < 96
// copies piece i.  The caller commits the group (every thread, copy or not).
__device__ __forceinline__ void fetch_cluster(float4* slot, const float4* __restrict__ edges,
                                              int c, int tid) {
  if (tid < kClusterPieces)
    __pipeline_memcpy_async(slot + tid, edges + (size_t)c * kClusterPieces + tid, sizeof(float4));
}

// A block-wide exchange: lane 0 of each warp publishes `value`, the block
// meets at a barrier, and lane l of every warp gets warp l's value (0 for
// l >= warps).  The two halves of `xchg` ([2][kMaxWarps]) alternate with
// `round`, so a half is written again only after a barrier that every
// reader of its last round has passed.
__device__ __forceinline__ unsigned exchange(unsigned* xchg, int& round, unsigned value,
                                             int warp, int lane, int warps) {
  unsigned* buf = xchg + (round & 1) * kMaxWarps;
  ++round;
  if (lane == 0) buf[warp] = value;
  __syncthreads();
  return lane < warps ? buf[lane] : 0u;
}

// The OR over the block of each thread's `bits`.
__device__ __forceinline__ unsigned block_or(unsigned* xchg, int& round, unsigned bits, int warp,
                                             int lane, int warps) {
  return __reduce_or_sync(
      kAllLanes, exchange(xchg, round, __reduce_or_sync(kAllLanes, bits), warp, lane, warps));
}

// A thread's entry distances into the up to kFanout sibling boxes
// table[base ..], `count` of them real, into its column of `ent`
// ([kFanout][lanes]; +inf where `gate` is false or the ray misses the box).
// A child is live at a running t iff its entry < t, slab_live's own rule,
// so the eight tests run at once, before the running t at each child's turn
// is known.  `gate` is "live in the parent": the boxes are unions of their
// children, so a ray not live in the parent is live in none of them.
// Returns the children live at t_run now, one bit each.
__device__ __forceinline__ unsigned child_entries(const float* __restrict__ table, int base,
                                                  int count, bool gate, V3 o, V3 inv,
                                                  float t_run, float* ent, int lanes, int tid) {
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < kFanout; ++j) {
    const float e = (gate && j < count)
                        ? slab_entry(table + (size_t)(base + j) * kBoundsRow, o, inv, INFINITY)
                        : INFINITY;
    ent[j * lanes + tid] = e;
    live |= (unsigned)(e < t_run) << j;
  }
  return live;
}

// The pooled rays of one visited cluster.  `count` is this lane's value of
// the cluster's exchange: warp l's live rays, for lane l (0 past the last
// warp).  Returns the block's pooled count; `rank` gets this thread's place
// in the pool (meaningful where its ray is live).
__device__ __forceinline__ int pool_rank(unsigned count, unsigned mask, int warp, int lane,
                                         int* rank) {
  unsigned incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kAllLanes, incl, off);
    if (lane >= off) incl += y;
  }
  *rank = (int)__shfl_sync(kAllLanes, incl - count, warp) + __popc(mask & ((1u << lane) - 1u));
  return (int)__shfl_sync(kAllLanes, incl, 31);
}

// The ray-by-ray face tests of a staged cluster: warp w takes the pooled
// rays e = w, w + warps, ... < n_pool; lane f tests face f (f < f_count)
// against ray pool_id[e], its planes in `ray` ([6][lanes]: o, d).  Of the
// faces with t < pool_t[e] the least (t, f) goes to res_*[e]; res_f[e] = -1
// where there is none.
__device__ __forceinline__ void pooled_tests(const float4* st, int f_count, const float* ray,
                                             int lanes, const float* pool_t, const int* pool_id,
                                             int n_pool, float* res_t, float* res_u,
                                             float* res_w, int* res_f, int warp, int warps,
                                             int lane) {
  if (warp >= n_pool) return;   // a whole warp
  const EdgeFace face = staged_face(st, lane);
  const bool mine = lane < f_count;
  for (int e = warp; e < n_pool; e += warps) {
    const int r = pool_id[e];
    const float limit = pool_t[e];
    const V3 ro = v3(ray[r], ray[lanes + r], ray[2 * lanes + r]);
    const V3 rd = v3(ray[3 * lanes + r], ray[4 * lanes + r], ray[5 * lanes + r]);
    float u, w;
    const float t = triangle_t_edges(face.v0, face.e1, face.e2, ro, rd, &u, &w);
    const unsigned key = (mine && t < limit) ? __float_as_uint(t) : kNoKey;
    const unsigned least = __reduce_min_sync(kAllLanes, key);
    int win = -1;
    float wu = 0.0f, ww = 0.0f;
    if (least != kNoKey) {
      win = __ffs(__ballot_sync(kAllLanes, key == least)) - 1;
      wu = __shfl_sync(kAllLanes, u, win);
      ww = __shfl_sync(kAllLanes, w, win);
    }
    if (lane == 0) {
      res_t[e] = __uint_as_float(least);
      res_u[e] = wu;
      res_w[e] = ww;
      res_f[e] = win;
    }
  }
}

// Blocks of `threads` threads and `smem` dynamic shared bytes resident on
// the whole card (SMs x blocks per SM), asked of the runtime once per device
// and slot.
template <typename Kernel>
__host__ cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int (*cache)[9],
                                     int slot, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxTileDevices) return cudaErrorInvalidDevice;
  if (cache[dev][slot] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    cache[dev][slot] = (per_sm > 1 ? per_sm : 1) * sms;
  }
  *out = cache[dev][slot];
  return cudaSuccess;
}

}  // namespace aptd
