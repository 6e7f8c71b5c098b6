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
// Bound on the H100: FP32 ALU work, about 60 operations per face test and
// 27 per slab test, counted for the nodes each ray is live in
// (mesh_kernel_v2p.py:traversal_work); the bytes are 28 in and 32 out per
// ray plus the tables once.
//
// What costs more than the bound, and what this design does about it:
//   * Divergence.  With one thread per ray walking on its own, a warp issues
//     the face tests of every cluster that any of its 32 rays is live in,
//     the other lanes masked off: it pays the union over its rays, not their
//     sum (traversal_warp_work counts that union).  Here the warp walks the
//     hierarchy together, in index order: each lane slab-tests its own ray
//     against the node (and only where the ray is live in the parent), a
//     ballot gives the live mask, and a node with no live lane is skipped,
//     so control flow is the same for the whole warp.  A visited cluster
//     with k = popc(mask) live rays is then worked in one of two ways:
//       - k >= kThr: every live lane tests the 32 faces in ascending order
//         against its own ray with a strict `<` (the thread-per-ray
//         algorithm; all lanes read the same staged face, a shared-memory
//         broadcast);
//       - k < kThr: the live rays are taken one at a time.  The warp
//         broadcasts the ray (__shfl_sync), lane f tests face f, and the
//         winner is the least (t, f) among the faces with t < t_run of that
//         ray: redux.sync's minimum over the bits of t (a hit's t is > 0
//         and never NaN, and positive floats order as their bits), then the
//         lowest lane holding that minimum (ballot, ffs).  That is what the
//         sequential scan keeps: its strict `<` replaces the winner only by a
//         smaller t, so after face 31 it holds the least t below t_run and,
//         of equal ones, the first in face order.  The ray's lane then takes
//         the new t_run before the next cluster is gated.
//     So a warp pays about 32 lane-face tests per live (ray, cluster), the
//     per-ray sum, where few of its rays share a cluster.  kThr is
//     APTD_K4_K_THR, which the build defines from mesh_kernel_v2p.py:K_THR,
//     a constant chosen by a sweep on the card (chip_smoke.py, PERF.md).
//   * Scattered loads.  Faces are read from a packed table built once per
//     hierarchy (mesh_kernel_v2p.py:packed_faces): v0, e1 = v1 - v0,
//     e2 = v2 - v0 in 12 floats, three aligned 16-byte pieces, one cluster
//     1.5 KB contiguous.  Lane f loads face f, so a cluster arrives in one
//     coalesced 1.5 KB read per warp, and the next candidate cluster's read
//     is issued before the current one is worked; the k >= kThr branch
//     stages the cluster in the warp's slice of shared memory.  The edges
//     are the same float32 subtractions the test made before, so every
//     result keeps its bits.  Normals and material stay in the 19-column
//     rows, read for the winner only.
//   * Latency of the walk.  A node's slab test depends on nothing but the
//     ray: a child is live at a running t iff its entry distance is below
//     it.  So on entering a hyper (super) each lane computes the entries of
//     all eight supers (clusters) at once, eight independent loads and
//     tests, keeps them in the warp's slice of shared memory, and gates each
//     child at its turn against the then-current t; the union over the warp
//     of the children live on entry lists the only ones that can be
//     visited.
//   * Tail effects.  Blocks are persistent, about one resident wave, and
//     each warp takes batches of 32 consecutive rays from an atomic counter
//     (zeroed on the call's stream before the launch), so a slow batch holds
//     only its own warp.
// Every cull is conservative, and each ray's running t evolves exactly as
// in a per-ray walk in index order, so the result equals the dense scan
// over the face table bit for bit (built with -fmad=false).
#include "mesh_common.cuh"

#ifndef APTD_K4_K_THR
#error "APTD_K4_K_THR: the build passes mesh_kernel_v2p.py:K_THR"
#endif

namespace {
using namespace aptd;

constexpr int kWarps = 4;                    // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPieces = 3;                   // float4 per packed face: v0 e1 | e1 e2 | e2 0
constexpr int kThr = APTD_K4_K_THR;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kNoHit = 0xffffffffu;     // above the bits of every positive float
constexpr int kMaxDevices = 64;

struct Face {
  V3 v0, e1, e2;
};

__device__ __forceinline__ Face unpack(float4 a, float4 b, float4 c) {
  Face f;
  f.v0 = v3(a.x, a.y, a.z);
  f.e1 = v3(a.w, b.x, b.y);
  f.e2 = v3(b.z, b.w, c.x);
  return f;
}

__device__ __forceinline__ V3 shfl(V3 a, int src) {
  return v3(__shfl_sync(kAll, a.x, src), __shfl_sync(kAll, a.y, src),
            __shfl_sync(kAll, a.z, src));
}

// The entry distances of this lane's ray into the up to kFanout sibling
// boxes table[base ..], `count` of them real, into the lane's column of
// `ent` (+inf where `gate` is false or the ray misses the box).  A child is
// live at a running t iff its entry < t, slab_live's own rule, so the tests
// can run before the running t is known, all eight at once: their loads and
// arithmetic overlap.  Returns the children live at t_run now, one bit each.
__device__ __forceinline__ unsigned sibling_entries(const float* __restrict__ table, int base,
                                                    int count, bool gate, V3 o, V3 inv,
                                                    float t_run, float* ent, int lane) {
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < kFanout; ++j) {
    const float e = (gate && j < count)
                        ? slab_entry(table + (size_t)(base + j) * kBoundsRow, o, inv, INFINITY)
                        : INFINITY;
    ent[j * 32 + lane] = e;
    live |= (unsigned)(e < t_run) << j;
  }
  return live;
}

// Lane f's piece of cluster c: its face f, three 16-byte loads.
__device__ __forceinline__ void load_face(const float4* __restrict__ edges, int c, int lane,
                                          float4 (&p)[kPieces]) {
  const float4* src = edges + ((size_t)c * kCluster + lane) * kPieces;
#pragma unroll
  for (int j = 0; j < kPieces; ++j) p[j] = __ldg(src + j);
}

__global__ void __launch_bounds__(kThreads)
    bvh_v2p_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ t_cull, int n, const float* __restrict__ faces,
                   const float4* __restrict__ edges, const float* __restrict__ cb,
                   const float* __restrict__ sb, const float* __restrict__ hb, int n_faces,
                   int n_clusters, int n_supers, int n_hypers, float* __restrict__ out,
                   int* __restrict__ mat_out, int* __restrict__ next_batch) {
  __shared__ float4 stage[kWarps][kCluster * kPieces];
  __shared__ float entries[kWarps][2][kFanout * 32];   // supers', clusters' entries
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* staged = stage[warp];
  float* ent_s = entries[warp][0];
  float* ent_c = entries[warp][1];
  for (;;) {
    int batch = 0;
    if (lane == 0) batch = atomicAdd(next_batch, 1);
    batch = __shfl_sync(kAll, batch, 0);
    if (batch * 32 >= n) return;
    const int i = batch * 32 + lane;
    const bool real = i < n;
    const V3 o = real ? v3(ox[i], oy[i], oz[i]) : v3(0.0f, 0.0f, 0.0f);
    const V3 d = real ? v3(dx[i], dy[i], dz[i]) : v3(1.0f, 1.0f, 1.0f);
    float t_run = real ? t_cull[i] : -INFINITY;
    float best_u = 0.0f, best_w = 0.0f;
    int best_f = -1;
    const bool active = t_run > -INFINITY;   // false for -inf (and NaN): nothing can be live
    if (__any_sync(kAll, active)) {
      const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
      for (int h = 0; h < n_hypers; ++h) {
        const bool live_h = active && slab_live(hb + h * kBoundsRow, o, inv, t_run);
        if (!__any_sync(kAll, live_h)) continue;
        const int s0 = h * kFanout;
        // the supers some lane is live in now: t_run only falls, so every
        // super visited below is one of them
        unsigned supers = __reduce_or_sync(
            kAll, sibling_entries(sb, s0, n_supers - s0, live_h, o, inv, t_run, ent_s, lane));
        for (; supers != 0; supers &= supers - 1) {
          const int js = __ffs(supers) - 1;
          const bool live_s = ent_s[js * 32 + lane] < t_run;
          if (!__any_sync(kAll, live_s)) continue;
          const int c0 = (s0 + js) * kFanout;
          unsigned clusters = __reduce_or_sync(
              kAll, sibling_entries(cb, c0, n_clusters - c0, live_s, o, inv, t_run, ent_c, lane));
          // the faces of the next candidate cluster are loaded while the
          // current one is worked
          float4 next[kPieces];
          if (clusters != 0) load_face(edges, c0 + __ffs(clusters) - 1, lane, next);
          while (clusters != 0) {
            const int jc = __ffs(clusters) - 1;
            clusters &= clusters - 1;
            const float4 pa = next[0], pb = next[1], pc = next[2];
            if (clusters != 0) load_face(edges, c0 + __ffs(clusters) - 1, lane, next);
            const bool live = ent_c[jc * 32 + lane] < t_run;
            const unsigned mask = __ballot_sync(kAll, live);
            if (mask == 0) continue;
            const int c = c0 + jc;
            const int f_count = min(kCluster, n_faces - c * kCluster);
            if (__popc(mask) < kThr) {
              // one live ray at a time, lane f on face f
              const Face face = unpack(pa, pb, pc);
              const bool mine = lane < f_count;
              for (unsigned m = mask; m != 0; m &= m - 1) {
                const int r = __ffs(m) - 1;
                const V3 ro = shfl(o, r), rd = shfl(d, r);
                const float tr = __shfl_sync(kAll, t_run, r);
                float u, w;
                const float t = triangle_t_edges(face.v0, face.e1, face.e2, ro, rd, &u, &w);
                const unsigned key = (mine && t < tr) ? __float_as_uint(t) : kNoHit;
                const unsigned least = __reduce_min_sync(kAll, key);
                if (least == kNoHit) continue;
                const int win = __ffs(__ballot_sync(kAll, key == least)) - 1;
                const float wu = __shfl_sync(kAll, u, win), ww = __shfl_sync(kAll, w, win);
                if (lane == r) {
                  t_run = __uint_as_float(least);
                  best_u = wu;
                  best_w = ww;
                  best_f = c * kCluster + win;
                }
              }
            } else {
              // every live lane on its own ray, the faces staged once
              staged[lane * kPieces] = pa;
              staged[lane * kPieces + 1] = pb;
              staged[lane * kPieces + 2] = pc;
              __syncwarp();
              if (live) {
                for (int f = 0; f < f_count; ++f) {
                  const Face face = unpack(staged[f * kPieces], staged[f * kPieces + 1],
                                           staged[f * kPieces + 2]);
                  float u, w;
                  const float t = triangle_t_edges(face.v0, face.e1, face.e2, o, d, &u, &w);
                  if (t < t_run) {   // strict: the earlier face keeps ties
                    t_run = t;
                    best_u = u;
                    best_w = w;
                    best_f = c * kCluster + f;
                  }
                }
              }
              __syncwarp();   // the slice may be written again
            }
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
  }
}

}  // namespace

extern "C" int aptd_mesh_bvh_v2p(const float* ox, const float* oy, const float* oz,
                                 const float* dx, const float* dy, const float* dz,
                                 const float* t_cull, int n, const float* faces,
                                 const float* edges, const float* cb, const float* sb,
                                 const float* hb, int n_faces, int n_clusters, int n_supers,
                                 int n_hypers, float* out, int* mat_out, int* next_batch,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // One resident wave: SMs x blocks per SM, asked of the runtime once per
  // device (the same value on every call).
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_v2p_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = max(per_sm, 1) * sms;
  }
  err = cudaMemsetAsync(next_batch, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int batches = (n + 31) / 32;
  const int blocks = min(resident[dev], (batches + kWarps - 1) / kWarps);
  bvh_v2p_kernel<<<blocks, kThreads, 0, s>>>(
      ox, oy, oz, dx, dy, dz, t_cull, n, faces, reinterpret_cast<const float4*>(edges), cb, sb,
      hb, n_faces, n_clusters, n_supers, n_hypers, out, mat_out, next_batch);
  return (int)cudaGetLastError();
}
