// The cluster visit of a mesh traversal, repeated: what one visit costs a
// tile of 1024 rays when the 32 face tests run as scalar float32 arithmetic.
//
// Replaces the TPU kernel tools/exp_mm_feasibility.py:180 (build_vpu_kernel,
// pl.pallas_call in run_visit_bench) of the JAX repo.  Same function: the
// state (t, point, normal, material) of each of 1024 rays starts at
// (3e38, 0...), and visit k = 0 .. n_visits - 1 fetches cluster k % 64 (32
// rows of a (2048, 128) face table, 19 columns used), runs the 32
// Moller-Trumbore tests with 3e38 as the miss value, takes the first minimal
// face and replaces the state where its t is strictly smaller.  The normal
// is the interpolated one, not normalised, and the material the row's
// column 18 as a float, as in the probe.  Out: the (8, 1024) state.
//
// Bound: FP32 ALU work, 32 face tests of about 54 operations per ray and
// visit, and each face's edges (6 operations) once per visit (58.0 G
// operations at 32,768 visits); the bytes (the table's rows once per
// visit, from L2, and 64 KB of rays and state) are small beside it.  Built with -fmad=false and IEEE division, so the result equals the
// plain PyTorch version's bit for bit; the card then issues one float32
// operation per lane and cycle, about half the FMA rate the bound assumes.
//
// What held the first version back (410.8 ms per launch on an H100, against
// a 0.866 ms bound): one block of 1024 threads for the whole launch, so 131
// of 132 SMs idled; each visit's rows loaded with plain loads between two
// barriers, nothing overlapping the fetch; each ray forming the edges
// v1 - v0 and v2 - v0 of every face again.
//
// Design.  The visits are split, not the rays: block s of S (S = SMs x the
// blocks that fit) runs the visits [s n / S, (s + 1) n / S) for all 1024
// rays into its partial state, so each fetch serves the whole tile as on
// the TPU; merge_visit_states (mesh_common.cuh) merges the S partial states
// in range order with a strict `<`, which gives the sequential state bit for
// bit.  Every visit fetches its cluster's rows from global memory: the
// block stages them in shared memory with cp.async (160 copies of 16 bytes,
// the 19 used floats of each row and one more) in three slots (the visit
// tested, the one being packed, the one in flight), so visit k + 2 is in
// flight while visit k is tested.  When a cluster has arrived, warp 0
// forms each face's v0, e1 = v1 - v0, e2 = v2 - v0 once (the subtraction of
// triangle_t, so the same bits) into a packed slab that the rays read as
// three broadcast 16-byte loads per face before triangle_t_edges.  A thread
// holds kRays rays, the state in registers (one ray per thread, 1024
// threads and one block per SM: tools/visit_sweep.py timed 2 and 4 rays per
// thread and two blocks per SM against it).  Thread 0 counts the visits its
// block ran and adds them to `visits_done` once: the caller checks that
// all n_visits were run.
#include <cuda_pipeline.h>

#include "mesh_common.cuh"

namespace {
using namespace aptd;

constexpr int kTile = 1024;       // rays
constexpr int kTableRow = 128;    // floats per row of the probe's face table
constexpr int kClusters = 64;     // clusters the visits cycle through
constexpr int kRawRow = 20;       // floats staged per face row: 19 used + 1
constexpr int kPieces = kCluster * kRawRow / 4;   // 16-byte copies per visit
constexpr int kPacked = 3;        // float4 per packed face: v0 e1 e2 (+3 pad)
constexpr int kRows = 8;          // t, point, normal, material
constexpr int kRays = 1;          // rays per thread
constexpr int kThreads = kTile / kRays;
constexpr float kMiss = 3e38f;

__device__ __forceinline__ int range_begin(int s, int n_visits, int splits) {
  return (int)((long long)s * n_visits / splits);
}

// Start copying visit `visit`'s cluster rows into `raw`: thread i < kPieces
// copies 16 bytes (row i / 5, floats 4 (i % 5) ..).  Every thread commits.
__device__ __forceinline__ void fetch_cluster(float* raw, const float* faces, int visit) {
  const int i = threadIdx.x;
  if (i < kPieces) {
    const int row = i / (kRawRow / 4), piece = i % (kRawRow / 4);
    __pipeline_memcpy_async(
        raw + row * kRawRow + piece * 4,
        faces + ((size_t)(visit % kClusters) * kCluster + row) * kTableRow + piece * 4, 16);
  }
  __pipeline_commit();
}

// Lane f of warp 0: face f's v0, e1 = v1 - v0, e2 = v2 - v0.
__device__ __forceinline__ void pack_face(const float* raw, float4* packed, int f) {
  const float* r = raw + f * kRawRow;
  const V3 v0 = v3(r[0], r[1], r[2]);
  const V3 e1 = sub(v3(r[3], r[4], r[5]), v0), e2 = sub(v3(r[6], r[7], r[8]), v0);
  packed[f * kPacked] = make_float4(v0.x, v0.y, v0.z, e1.x);
  packed[f * kPacked + 1] = make_float4(e1.y, e1.z, e2.x, e2.y);
  packed[f * kPacked + 2] = make_float4(e2.z, 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
    visit_vpu_kernel(const float* __restrict__ rays, const float* __restrict__ faces,
                     int n_visits, int splits, float* __restrict__ partial,
                     int* __restrict__ visits_done) {
  __shared__ __align__(16) float raw[3][kCluster * kRawRow];
  __shared__ float4 packed[2][kCluster * kPacked];
  const int lo = range_begin(blockIdx.x, n_visits, splits);
  const int hi = range_begin(blockIdx.x + 1, n_visits, splits);
  const bool packer = threadIdx.x < 32;

  V3 o[kRays], d[kRays], point[kRays], normal[kRays];
  float t_run[kRays], mat[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = threadIdx.x + r * kThreads;
    o[r] = v3(rays[i], rays[kTile + i], rays[2 * kTile + i]);
    d[r] = v3(rays[3 * kTile + i], rays[4 * kTile + i], rays[5 * kTile + i]);
    t_run[r] = kMiss;
    mat[r] = 0.0f;
    point[r] = v3(0.0f, 0.0f, 0.0f);
    normal[r] = v3(0.0f, 0.0f, 0.0f);
  }

  if (lo < hi) fetch_cluster(raw[0], faces, lo);
  if (lo + 1 < hi) fetch_cluster(raw[1], faces, lo + 1);
  __pipeline_wait_prior(0);
  __syncthreads();
  if (packer && lo < hi) pack_face(raw[0], packed[0], threadIdx.x);
  __syncthreads();

  int done = 0;
  int cur = 0, next = 1, ahead = 2;   // raw slots of visits k, k + 1, k + 2
  for (int k = lo; k < hi; ++k) {
    const int j = k - lo;
    // visit k + 1 arrived before the last barrier; visit k + 2 goes in flight
    if (packer && k + 1 < hi) pack_face(raw[next], packed[(j + 1) & 1], threadIdx.x);
    if (k + 2 < hi) fetch_cluster(raw[ahead], faces, k + 2);

    const float4* pk = packed[j & 1];
    float t_c[kRays], u_c[kRays], w_c[kRays];
    int f_c[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      t_c[r] = INFINITY;
      u_c[r] = 0.0f;
      w_c[r] = 0.0f;
      f_c[r] = 0;
    }
#pragma unroll 4
    for (int f = 0; f < kCluster; ++f) {
      const float4 a = pk[f * kPacked], b = pk[f * kPacked + 1], c = pk[f * kPacked + 2];
      const V3 v0 = v3(a.x, a.y, a.z), e1 = v3(a.w, b.x, b.y), e2 = v3(b.z, b.w, c.x);
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        float u, w;
        float t = triangle_t_edges(v0, e1, e2, o[r], d[r], &u, &w);
        t = t < INFINITY ? t : kMiss;
        if (t < t_c[r]) {   // strict: the first minimal row
          t_c[r] = t;
          u_c[r] = u;
          w_c[r] = w;
          f_c[r] = f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      if (t_c[r] < t_run[r]) {
        const float* fr = raw[cur] + f_c[r] * kRawRow;
        const V3 v0 = v3(fr[0], fr[1], fr[2]), v1 = v3(fr[3], fr[4], fr[5]),
                 v2 = v3(fr[6], fr[7], fr[8]);
        const V3 n0 = v3(fr[9], fr[10], fr[11]), n1 = v3(fr[12], fr[13], fr[14]),
                 n2 = v3(fr[15], fr[16], fr[17]);
        const float v = 1.0f - u_c[r] - w_c[r];
        t_run[r] = t_c[r];
        point[r] = add(add(scale(v0, u_c[r]), scale(v1, w_c[r])), scale(v2, v));
        normal[r] = add(add(scale(n0, v), scale(n1, u_c[r])), scale(n2, w_c[r]));
        mat[r] = fr[18];
      }
    }
    ++done;
    __pipeline_wait_prior(0);   // visit k + 2 has landed (this thread's copies)
    __syncthreads();            // ... every thread's; visit k's slots are free
    const int spent = cur;
    cur = next;
    next = ahead;
    ahead = spent;
  }
  if (threadIdx.x == 0) atomicAdd(visits_done, done);

  float* st = partial + (size_t)blockIdx.x * kRows * kTile;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = threadIdx.x + r * kThreads;
    st[i] = t_run[r];
    st[kTile + i] = point[r].x;
    st[2 * kTile + i] = point[r].y;
    st[3 * kTile + i] = point[r].z;
    st[4 * kTile + i] = normal[r].x;
    st[5 * kTile + i] = normal[r].y;
    st[6 * kTile + i] = normal[r].z;
    st[7 * kTile + i] = mat[r];
  }
}

}  // namespace

// n_visits visits split over `splits` blocks; partial: (splits, 8, 1024)
// scratch; visits_done: one int the caller zeroed; out: (8, 1024).
extern "C" int aptd_mm_visit_vpu(const float* rays, const float* faces, int n_visits, int splits,
                                 float* partial, int* visits_done, float* out, void* stream) {
  if (n_visits < 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  visit_vpu_kernel<<<splits, kThreads, 0, s>>>(rays, faces, n_visits, splits, partial,
                                               visits_done);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  aptd::merge_visit_states<kRows, kRows><<<aptd::merge_blocks(kTile), 256, 0, s>>>(
      partial, splits, kTile, out);
  return (int)cudaGetLastError();
}

// Blocks that fit on one SM (the occupancy API).
extern "C" int aptd_mm_visit_vpu_blocks_per_sm(int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, visit_vpu_kernel, kThreads, 0);
}
