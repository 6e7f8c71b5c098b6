// The cluster visit of a mesh traversal as a matrix product, repeated: what
// one visit costs a tile of 1024 rays when the 32 face tests are one
// (128 x 16) @ (16 x 1024) product on the tensor cores.
//
// Replaces the TPU kernel tools/exp_mm_feasibility.py:build_mxu_kernel
// (pl.pallas_call in run_visit_bench) of the JAX repo.  Same function: the
// kernel builds the feature tile (16, 1024) = rows [d, o x d, o, 1, 0 x 6]
// from the ray planes; the state of each ray is (t, face) = (3e38, -1);
// visit k = 0 .. n_visits - 1 takes coefficient block k % 64, a (16, 128)
// matrix, contracts it with the features over dim 0 into (128, 1024) =
// 32 rows each of den, un, wn, tn, tests
//   den >= eps, un >= 0, un <= den, wn >= 0, un + wn <= den, tn >= 0,
// takes t = tn / den (3e38 where the test fails), the first minimal row, and
// replaces the state where t is strictly smaller, the face id being
// (k % 64) * 32 + row.  Out: (8, 1024) = t, face id as float, six zero rows.
//
// Two precisions, as the probe's DEFAULT and HIGHEST: `highest` = 0 rounds
// both operands to TF32 (one wmma m16n16k8 product per k-step); `highest` =
// 1 is the 3xTF32 scheme of conv_mma.cuh (operands split into a TF32 part
// and the TF32 of the rest, small terms first), which keeps float32 accuracy.
//
// Design.  One block of 512 threads (16 warps) for the one tile: as in
// mm_visit_vpu.cu the probe asks what a visit costs one tile, so one SM
// works.  The features (64 KB) stay in shared memory for all visits; per
// visit the block stages the coefficient block (8 KB) between two barriers.
// A warp owns 64 rays = 4 column tiles.  For each half g of the 32 faces it
// loads the 4 x 2 A fragments (rows g*16 .. +15 of den, un, wn, tn; the
// staged block is A column-major), and per column tile runs 8 (24) mma into
// four accumulators that hold den, un, wn, tn of the same (face, ray) at the
// same fragment position, so the hit test and the division are elementwise
// on the fragments.  The t tile goes through a per-warp 16 x 16 shared
// scratch, where lane c < 16 scans column c's rows in ascending order with a
// strict `<` into the ray's state, held in that lane's registers.
//
// Bound: the product, 2 * 128 * 16 * 1024 operations per visit, at the TF32
// tensor-core rate (as float32 work for `highest`), plus about 12 float32
// operations per (face, ray) for the test; the bytes (512 KB of
// coefficients once, the rays, the result) are nothing beside it.
#include <cuda_runtime.h>
#include <mma.h>

namespace {
using namespace nvcuda;

constexpr int kTile = 1024;      // rays
constexpr int kFeat = 16;        // feature rows = depth of the product
constexpr int kRows = 128;       // den, un, wn, tn of 32 faces
constexpr int kFaces = 32;
constexpr int kBlocks = 64;      // coefficient blocks the visits cycle through
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kColTiles = kTile / 16 / kWarps;   // column tiles per warp: 4
constexpr float kMiss = 3e38f;
constexpr float kFltEps = 1.1920929e-07f;
constexpr size_t kSharedBytes =
    sizeof(float) * (kFeat * kTile + kFeat * kRows + kWarps * 16 * 16);

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;

template <typename Frag>
__device__ __forceinline__ void round_tf32(Frag& f) {
#pragma unroll
  for (int t = 0; t < f.num_elements; ++t) f.x[t] = wmma::__float_to_tf32(f.x[t]);
}

// v = hi + lo: the part a TF32 holds and the TF32 of what is left.
template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& hi, Frag& lo) {
#pragma unroll
  for (int t = 0; t < hi.num_elements; ++t) {
    const float v = hi.x[t];
    const float h = wmma::__float_to_tf32(v);
    hi.x[t] = h;
    lo.x[t] = wmma::__float_to_tf32(v - h);
  }
}

template <bool kHighest>
__global__ void __launch_bounds__(kThreads)
    visit_mma_kernel(const float* __restrict__ rays, const float* __restrict__ coeffs,
                     int n_visits, float* __restrict__ out) {
  extern __shared__ __align__(128) float shared[];
  float* feats = shared;                       // (16, 1024) row-major
  float* stage = feats + kFeat * kTile;        // (16, 128): A, column-major, ld 128
  float* scratch = stage + kFeat * kRows;      // per warp (16, 16)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* tile = scratch + warp * 256;

  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const float ox = rays[i], oy = rays[kTile + i], oz = rays[2 * kTile + i];
    const float dx = rays[3 * kTile + i], dy = rays[4 * kTile + i], dz = rays[5 * kTile + i];
    feats[0 * kTile + i] = dx;
    feats[1 * kTile + i] = dy;
    feats[2 * kTile + i] = dz;
    feats[3 * kTile + i] = oy * dz - oz * dy;
    feats[4 * kTile + i] = oz * dx - ox * dz;
    feats[5 * kTile + i] = ox * dy - oy * dx;
    feats[6 * kTile + i] = ox;
    feats[7 * kTile + i] = oy;
    feats[8 * kTile + i] = oz;
    feats[9 * kTile + i] = 1.0f;
#pragma unroll
    for (int r = 10; r < kFeat; ++r) feats[r * kTile + i] = 0.0f;
  }

  // lane c < 16 holds the state of ray warp*64 + ct*16 + c
  float st_t[kColTiles], st_f[kColTiles];
#pragma unroll
  for (int ct = 0; ct < kColTiles; ++ct) {
    st_t[ct] = kMiss;
    st_f[ct] = -1.0f;
  }

  for (int visit = 0; visit < n_visits; ++visit) {
    const int blk = visit % kBlocks;
    __syncthreads();   // the last visit's A loads are done (and the features are written)
    {
      const float4* src = reinterpret_cast<const float4*>(coeffs + (size_t)blk * kFeat * kRows);
      reinterpret_cast<float4*>(stage)[threadIdx.x] = src[threadIdx.x];   // 512 x 16 bytes
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kFaces / 16; ++g) {
      FragA a[4][2];   // [den, un, wn, tn][k-step]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          wmma::load_matrix_sync(a[q][kh], stage + kh * 8 * kRows + q * kFaces + g * 16, kRows);
          if (!kHighest) round_tf32(a[q][kh]);
        }
      }
#pragma unroll
      for (int ct = 0; ct < kColTiles; ++ct) {
        Acc acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wmma::fill_fragment(acc[q], 0.0f);
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          FragB b_hi, b_lo;
          wmma::load_matrix_sync(b_hi, feats + kh * 8 * kTile + warp * 64 + ct * 16, kTile);
          if (kHighest) {
            split_tf32(b_hi, b_lo);
          } else {
            round_tf32(b_hi);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (kHighest) {
              FragA a_hi = a[q][kh], a_lo;
              split_tf32(a_hi, a_lo);
              wmma::mma_sync(acc[q], a_lo, b_hi, acc[q]);
              wmma::mma_sync(acc[q], a_hi, b_lo, acc[q]);
              wmma::mma_sync(acc[q], a_hi, b_hi, acc[q]);
            } else {
              wmma::mma_sync(acc[q], a[q][kh], b_hi, acc[q]);
            }
          }
        }
        // the four accumulators share one layout: position e is one (face, ray)
#pragma unroll
        for (int e = 0; e < acc[0].num_elements; ++e) {
          const float den = acc[0].x[e], un = acc[1].x[e], wn = acc[2].x[e], tn = acc[3].x[e];
          const bool hit = den >= kFltEps && un >= 0.0f && un <= den && wn >= 0.0f &&
                           un + wn <= den && tn >= 0.0f;
          acc[0].x[e] = hit ? tn / den : kMiss;
        }
        wmma::store_matrix_sync(tile, acc[0], 16, wmma::mem_row_major);
        __syncwarp();
        if (lane < 16) {
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float t = tile[r * 16 + lane];
            if (t < st_t[ct]) {   // strict, rows ascending: the first minimal face
              st_t[ct] = t;
              st_f[ct] = (float)(blk * kFaces + g * 16 + r);
            }
          }
        }
        __syncwarp();   // the tile is written again
      }
    }
  }

  if (lane < 16) {
#pragma unroll
    for (int ct = 0; ct < kColTiles; ++ct) {
      const int i = warp * 64 + ct * 16 + lane;
      out[i] = st_t[ct];
      out[kTile + i] = st_f[ct];
    }
  }
  for (int i = threadIdx.x; i < 6 * kTile; i += kThreads) out[2 * kTile + i] = 0.0f;
}

}  // namespace

extern "C" int aptd_mm_visit_mma(const float* rays, const float* coeffs, int n_visits,
                                 int highest, float* out, void* stream) {
  auto kernel = highest ? visit_mma_kernel<true> : visit_mma_kernel<false>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)kSharedBytes);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<1, kThreads, kSharedBytes, (cudaStream_t)stream>>>(rays, coeffs, n_visits, out);
  return (int)cudaGetLastError();
}
