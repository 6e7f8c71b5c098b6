// The cluster visit of a mesh traversal as a matrix product, repeated: what
// one visit costs a tile of 1024 rays when the 32 face tests are one
// (1024 x 16) @ (16 x 128) product on the tensor cores.
//
// Replaces the TPU kernel tools/exp_mm_feasibility.py:194 (build_mxu_kernel,
// pl.pallas_call in run_visit_bench) of the JAX repo.  Same function: the
// feature tile (16, 1024) = rows [d, o x d, o, 1, 0 x 6] of the ray planes;
// the state of each ray is (t, face) = (3e38, -1); visit k = 0 ..
// n_visits - 1 takes coefficient block k % 64, a (16, 128) matrix,
// contracts it with the features into 128 values per ray = 32 each of den,
// un, wn, tn, tests
//   den >= eps, un >= 0, un <= den, wn >= 0, un + wn <= den, tn >= 0,
// takes t = tn / den (IEEE division; 3e38 where the test fails), the first
// minimal face, and replaces the state where t is strictly smaller, the
// face id being (k % 64) * 32 + face.  Out: (8, 1024) = t, face id as float,
// six zero rows.  Two precisions, as the probe's DEFAULT and HIGHEST:
// `highest` = 0 rounds both operands to TF32 (cvt.rna, one product);
// `highest` = 1 is the 3xTF32 scheme of conv_mma.cuh (each operand split
// into a TF32 part and the TF32 of the rest, small terms first), which
// keeps float32 accuracy.  Built with -fmad=false, so the features o x d
// equal the plain version's bit for bit.
//
// Bound: the product, 2 x 128 x 16 x 1024 operations per visit at the TF32
// tensor-core rate (three such products in 3xTF32), or, where it takes
// longer, the test's 12 or so float32 operations per (face, ray): the
// tensor cores and the float32 pipes run at once.  The bytes (8 KB of
// coefficients per visit, from L2, the rays, the result) are small beside
// either.
//
// What held the first version back (380.7 / 664.5 ms per launch in TF32 /
// 3xTF32 on an H100, against bounds of 0.278 / 0.833 ms): one block for the
// launch, so 131 of 132 SMs idled; the ray features, fixed for the launch,
// reloaded from shared memory and rounded or split again on every visit,
// per face half and column tile (and A split again per column tile in
// 3xTF32); the opaque wmma accumulator layout, which sent each 16 x 16 t
// tile through a shared scratch where 16 lanes scanned 16 rows one by one;
// the coefficient block copied synchronously between two barriers.
//
// Design.  As in mm_visit_vpu.cu the visits are split over S blocks (SMs x
// the blocks that fit), each running a contiguous range of visits for the
// whole tile into a partial (t, face) state, merged in range order with a
// strict `<` by merge_visit_states (mesh_common.cuh).  The rays are the
// product's M dimension: the A operand is the features transposed, 16 rays
// x k = 16 per m-tile; a block has kWarps = 16 warps (512 threads, one block
// per SM: tools/visit_sweep.py timed 8 and 32 warps against it), and a warp
// owns 64 / kWarps m-tiles, builds their explicit mma.sync.m16n8k8 TF32 A
// fragments once, rounded (or split into hi and lo) once, and keeps them in
// registers for every visit (features 12-15 are zero by definition, so
// those fragment registers are the constant 0).  The coefficient block is
// the B operand, k = 16 x n = 128, fetched for every visit from global
// memory with cp.async into one of two padded shared slots: visit k + 2's
// block is in flight while visit k is computed and visit k + 1's, landed,
// is repacked into fragment order, rounded or split once per visit, so
// that a warp reads each n-tile's two k-steps as one 16-byte load.  The n-tiles are taken as (den, un, wn, tn)
// of the same 8 faces, so the four accumulators hold the four values of one
// (face, ray) at the same register position: the hit test and the division
// run in registers.  A lane holds 8 of the 32 faces (8g + 2(lane % 4) +
// {0, 1}) of each of its two rays per m-tile and scans them in ascending
// order with a strict `<` from the ray's state; two __shfl_xor_sync steps
// on (t, face), lower face on a tie, then give the quad the visit's first
// minimal face if it beats the state, which is what the sequential update
// keeps.  No shared scratch, no serial scan.  The division is taken only
// where it can change the state, a hit whose tn < t_state den (with slack
// for the product's rounding; see the epilogue): the four positions of a
// group are tested branch-free and one warp vote decides whether any lane
// divides.  Thread 0 counts the visits its block ran.
#include <cuda_pipeline.h>
#include <stdint.h>

#include "mesh_common.cuh"

namespace {
using namespace aptd;

constexpr int kTile = 1024;      // rays
constexpr int kFeat = 16;        // feature rows = depth of the product
constexpr int kCols = 128;       // den, un, wn, tn of 32 faces
constexpr int kFaces = 32;
constexpr int kBlocks = 64;      // coefficient blocks the visits cycle through
constexpr int kNTiles = kCols / 8;
constexpr int kFrags = kNTiles * 32;          // uint4 per packed B part
constexpr int kRawRow = kCols + 8;            // padded: conflict-free repacking
constexpr int kPieces = kFeat * kCols / 4;    // 16-byte copies per visit
constexpr int kPartRows = 2;                  // t, face id
constexpr int kOutRows = 8;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr float kMiss = 3e38f;

__host__ __device__ constexpr size_t shared_bytes(bool highest) {
  return sizeof(float) * 2 * kFeat * kRawRow + sizeof(uint4) * 2 * (highest ? 2 : 1) * kFrags;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: the part a TF32 holds and the TF32 of what is left.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += A (16 x 8, row) B (8 x 8, col); fragment layouts as the PTX ISA gives
// them for .tf32: lane = 4 group + q, A a0 (group, q), a1 (group + 8, q),
// a2 (group, q + 4), a3 (group + 8, q + 4); B b0 (q, group), b1 (q + 4,
// group); C c0 (group, 2q), c1 (group, 2q + 1), c2 (group + 8, 2q), c3
// (group + 8, 2q + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float pick(int q, float x0, float x1, float x2, float x3) {
  return q == 0 ? x0 : q == 1 ? x1 : q == 2 ? x2 : x3;
}

// Features of ray i that lane column q holds: f[q] (k-step 0, a0 / a1),
// f[q + 4] (k-step 0, a2 / a3) and f[8 + q] (k-step 1, a0 / a1), of the
// feature rows [dx dy dz | o x d | ox oy oz | 1 | 0 ...].
__device__ __forceinline__ void ray_features(const float* __restrict__ rays, int i, int q,
                                             float f[3]) {
  const float ox = rays[i], oy = rays[kTile + i], oz = rays[2 * kTile + i];
  const float dx = rays[3 * kTile + i], dy = rays[4 * kTile + i], dz = rays[5 * kTile + i];
  const float mx = oy * dz - oz * dy, my = oz * dx - ox * dz, mz = ox * dy - oy * dx;
  f[0] = pick(q, dx, dy, dz, mx);
  f[1] = pick(q, my, mz, ox, oy);
  f[2] = pick(q, oz, 1.0f, 0.0f, 0.0f);
}

// Start copying coefficient block `visit % 64` into `raw` (rows padded to
// kRawRow floats); every thread commits.
__device__ __forceinline__ void fetch_block(float* raw, const float* coeffs, int visit) {
  const float* src = coeffs + (size_t)(visit % kBlocks) * kFeat * kCols;
#pragma unroll
  for (int p = threadIdx.x; p < kPieces; p += kThreads) {
    const int row = p / (kCols / 4), piece = p % (kCols / 4);
    __pipeline_memcpy_async(raw + row * kRawRow + piece * 4, src + row * kCols + piece * 4, 16);
  }
  __pipeline_commit();
}

// The staged block in fragment order: entry (n-tile t, lane 4 group + q)
// holds B rows q, q + 4 (k-step 0) and 8 + q, 12 + q (k-step 1) of column
// 8 t + group, rounded to TF32, or their hi parts and, kFrags later, the lo
// parts.
template <bool kHighest>
__device__ __forceinline__ void pack_block(const float* raw, uint4* packed) {
#pragma unroll
  for (int p = threadIdx.x; p < kFrags; p += kThreads) {
    const int col = (p / 32) * 8 + (p % 32) / 4, q = p % 4;
    const float v[4] = {raw[q * kRawRow + col], raw[(q + 4) * kRawRow + col],
                        raw[(q + 8) * kRawRow + col], raw[(q + 12) * kRawRow + col]};
    if constexpr (kHighest) {
      uint4 hi, lo;
      split_tf32(v[0], hi.x, lo.x);
      split_tf32(v[1], hi.y, lo.y);
      split_tf32(v[2], hi.z, lo.z);
      split_tf32(v[3], hi.w, lo.w);
      packed[p] = hi;
      packed[kFrags + p] = lo;
    } else {
      packed[p] = make_uint4(to_tf32(v[0]), to_tf32(v[1]), to_tf32(v[2]), to_tf32(v[3]));
    }
  }
}

template <bool kHighest>
__global__ void __launch_bounds__(kThreads, 1)
    visit_mma_kernel(const float* __restrict__ rays, const float* __restrict__ coeffs,
                     int n_visits, int splits, float* __restrict__ partial,
                     int* __restrict__ visits_done) {
  constexpr int kMT = kTile / 16 / kWarps;     // m-tiles (16 rays) per warp
  constexpr int kParts = kHighest ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);                               // [2][16][kRawRow]
  uint4* packed = reinterpret_cast<uint4*>(smem + sizeof(float) * 2 * kFeat * kRawRow);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, q = lane & 3;
  const int lo_v = (int)((long long)blockIdx.x * n_visits / splits);
  const int hi_v = (int)((long long)(blockIdx.x + 1) * n_visits / splits);

  // A fragments of the warp's m-tiles, for every visit: [0..3] k-step 0,
  // [4..5] a0 / a1 of k-step 1 (its a2 / a3 are features 12-15: 0)
  uint32_t a_hi[kMT][6], a_lo[kHighest ? kMT : 1][6];
  float st_t[kMT][2];
  int st_f[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int ray = (warp * kMT + m) * 16 + group;
    float f_lo[3], f_hi[3];
    ray_features(rays, ray, q, f_lo);
    ray_features(rays, ray + 8, q, f_hi);
    const float x[6] = {f_lo[0], f_hi[0], f_lo[1], f_hi[1], f_lo[2], f_hi[2]};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      if constexpr (kHighest) {
        split_tf32(x[e], a_hi[m][e], a_lo[m][e]);
      } else {
        a_hi[m][e] = to_tf32(x[e]);
      }
    }
    st_t[m][0] = st_t[m][1] = kMiss;
    st_f[m][0] = st_f[m][1] = -1;
  }

  if (lo_v < hi_v) fetch_block(raw, coeffs, lo_v);
  if (lo_v + 1 < hi_v) fetch_block(raw + kFeat * kRawRow, coeffs, lo_v + 1);
  __pipeline_wait_prior(0);
  __syncthreads();
  if (lo_v < hi_v) pack_block<kHighest>(raw, packed);
  __syncthreads();

  int done = 0;
  for (int k = lo_v; k < hi_v; ++k) {
    const int j = k - lo_v;
    // visit k + 1 arrived before the last barrier: repack it; visit k's raw
    // slot, repacked a step ago, takes visit k + 2, in flight while visit k
    // is computed
    if (k + 1 < hi_v)
      pack_block<kHighest>(raw + ((j + 1) & 1) * kFeat * kRawRow,
                           packed + ((j + 1) & 1) * kParts * kFrags);
    if (k + 2 < hi_v) fetch_block(raw + (j & 1) * kFeat * kRawRow, coeffs, k + 2);

    const uint4* pk = packed + (j & 1) * kParts * kFrags;
    const int face0 = (k % kBlocks) * kFaces + 2 * q;
#pragma unroll
    for (int g = 0; g < kFaces / 8; ++g) {
      uint4 b_hi[4], b_lo[kHighest ? 4 : 1];
#pragma unroll
      for (int n = 0; n < 4; ++n) {   // n-tiles of den, un, wn, tn of faces 8g ..
        b_hi[n] = pk[(n * 4 + g) * 32 + lane];
        if constexpr (kHighest) b_lo[n] = pk[kFrags + (n * 4 + g) * 32 + lane];
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
          const uint32_t* a = a_hi[m];
          if constexpr (kHighest) {
            const uint32_t* al = a_lo[m];
            mma_tf32(acc[n], al[0], al[1], al[2], al[3], b_hi[n].x, b_hi[n].y);
            mma_tf32(acc[n], a[0], a[1], a[2], a[3], b_lo[n].x, b_lo[n].y);
            mma_tf32(acc[n], a[0], a[1], a[2], a[3], b_hi[n].x, b_hi[n].y);
            mma_tf32(acc[n], al[4], al[5], 0u, 0u, b_hi[n].z, b_hi[n].w);
            mma_tf32(acc[n], a[4], a[5], 0u, 0u, b_lo[n].z, b_lo[n].w);
            mma_tf32(acc[n], a[4], a[5], 0u, 0u, b_hi[n].z, b_hi[n].w);
          } else {
            mma_tf32(acc[n], a[0], a[1], a[2], a[3], b_hi[n].x, b_hi[n].y);
            mma_tf32(acc[n], a[4], a[5], 0u, 0u, b_hi[n].z, b_hi[n].w);
          }
        }
        // position i: ray group + 8 (i >> 1), face 8g + 2q + (i & 1).  A hit
        // changes the state only where tn / den < t_state, so only where
        // tn < t_state den (1 + 2^-20): two roundings of the product, each
        // under 2^-24 of it, cannot lose that where the product is normal;
        // below 2^-100 every hit is divided.
        bool need[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float den = acc[0][i], un = acc[1][i], wn = acc[2][i], tn = acc[3][i];
          const float lim = st_t[m][i >> 1] * den;
          need[i] = (den >= kFltEps) & (un >= 0.0f) & (un <= den) & (wn >= 0.0f) &
                    (un + wn <= den) & (tn >= 0.0f) &
                    ((tn < lim * 1.00000095367431640625f) | (lim < 0x1p-100f));
        }
        if (__any_sync(0xffffffffu, need[0] | need[1] | need[2] | need[3])) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (need[i]) {
              const float t = acc[3][i] / acc[0][i];
              if (t < st_t[m][i >> 1]) {   // strict, faces ascending within the lane
                st_t[m][i >> 1] = t;
                st_f[m][i >> 1] = face0 + g * 8 + (i & 1);
              }
            }
          }
        }
      }
    }
    // the quad's first minimal face of the visit, where it beats the state
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ot = __shfl_xor_sync(0xffffffffu, st_t[m][r], off);
          const int of = __shfl_xor_sync(0xffffffffu, st_f[m][r], off);
          if (ot < st_t[m][r] || (ot == st_t[m][r] && of < st_f[m][r])) {
            st_t[m][r] = ot;
            st_f[m][r] = of;
          }
        }
      }
    }
    ++done;
    __pipeline_wait_prior(0);   // visit k + 2 has landed (this thread's copies)
    __syncthreads();            // ... every thread's; visit k's packed slot is free
  }
  if (threadIdx.x == 0) atomicAdd(visits_done, done);

  if (q == 0) {
    float* st = partial + (size_t)blockIdx.x * kPartRows * kTile;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ray = (warp * kMT + m) * 16 + group + 8 * r;
        st[ray] = st_t[m][r];
        st[kTile + ray] = (float)st_f[m][r];
      }
    }
  }
}

}  // namespace

// n_visits visits split over `splits` blocks; partial: (splits, 2, 1024)
// scratch; visits_done: one int the caller zeroed; out: (8, 1024).
extern "C" int aptd_mm_visit_mma(const float* rays, const float* coeffs, int n_visits,
                                 int highest, int splits, float* partial, int* visits_done,
                                 float* out, void* stream) {
  if (n_visits < 0 || splits < 1) return (int)cudaErrorInvalidValue;
  auto kernel = highest ? visit_mma_kernel<true> : visit_mma_kernel<false>;
  const size_t bytes = shared_bytes(highest);
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<splits, kThreads, bytes, s>>>(rays, coeffs, n_visits, splits, partial, visits_done);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  aptd::merge_visit_states<kPartRows, kOutRows><<<aptd::merge_blocks(kTile), 256, 0, s>>>(
      partial, splits, kTile, out);
  return (int)cudaGetLastError();
}

// Blocks that fit on one SM (the occupancy API).
extern "C" int aptd_mm_visit_mma_blocks_per_sm(int highest, int* out) {
  auto kernel = highest ? visit_mma_kernel<true> : visit_mma_kernel<false>;
  const size_t bytes = shared_bytes(highest);
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, bytes);
}
