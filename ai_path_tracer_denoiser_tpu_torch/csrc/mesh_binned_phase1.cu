// Bin subscription of the binned mesh pipeline: which bins is a ray live in?
//
// Replaces the TPU kernel render/mesh_binned.py:_build_phase1_kernel
// (launched by _phase1_call) of the JAX package.  Same contract: per ray,
// slab-test the kb bin boxes (supers of 256 faces) in ascending order
// against the ray's cull distance; count every live bin, and write the live
// bins numbered skip .. skip + c_out - 1 into the ray's c_out slots, the
// dead key (1 << 20) into slots that stay empty.  Here the liveness IS the
// result, so the slab test's NaN rule is kept (mesh_common.cuh).
//
// Bound on the H100: FP32 ALU work, one slab test of about 27 operations
// per live ray and bin (a ray with t_cull = -inf needs none); the bytes are
// 28 in and 4 * (c_out + 1) out per ray (mesh_binned.py:phase1_work).
// Built with -fmad=false, it issues one operation per lane and cycle where
// the bound counts two, so it can reach about half of the bound.
//
// Design:
//   * The bounds table is copied into shared memory once per block, by one
//     thread with cp.async.bulk completing on an mbarrier, in chunks of
//     kChunk rows so that any kb fits; each bin is read as two 16-byte
//     broadcasts (lb xyz ub.x | ub.yz 0 0).
//   * As the TPU kernel does, the live bins of each run of 32 are collected
//     as one bit word, counted with popc and peeled into their slots after
//     the run: no store inside the test loop.
//   * kLpr adjacent lanes share a ray and take its words in turn (lane g of
//     the group the words g, g + kLpr, ...): after each round of kLpr
//     words a scan of the words' counts across the group gives each lane
//     the number of its first live bin.  A frame's calls hold 10 k to 140 k
//     live rays, too few warps to hide the tests' latency at one lane per
//     ray.
//   * A warp whose rays are all dead (t_cull = -inf or NaN: no box can be
//     live, slab_live's last comparison fails) writes dead slots and count
//     0 without testing a bin; a block with no live ray copies nothing.
//     The pipeline's packed prefixes put such rays last.
//   * Where every ray of a warp has a finite origin and finite, nonzero
//     inverse direction components and the chunk's rows are finite, no
//     plane distance can be NaN, and the warp takes slab_live_no_nan (the
//     NaN rule's selects left out, same result); otherwise slab_live.
// Slots and counts are int32 planes, (c_out, N) and (N,).
#include "bulk_copy.cuh"
#include "mesh_common.cuh"

namespace {
using namespace aptd;

constexpr int kDeadKey = 1 << 20;
// The shape, chosen on the card (PERF.md, tools/binned_sweep.py)
constexpr int kThreads = 128;
constexpr int kLpr = 2;                      // lanes per ray
constexpr int kRays = kThreads / kLpr;       // rays per block
constexpr int kChunk = 1024;                 // bounds rows staged at a time (32 KB)
constexpr int kWord = 32;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kThreads % 32 == 0 && 32 % kLpr == 0 && kChunk % kWord == 0, "block shape");

__device__ __forceinline__ bool finite3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}

// Bin `k` of the staged chunk as slab_live's row: lb xyz, ub xyz.
__device__ __forceinline__ void staged_row(const float4* rows, int k, float (&row)[6]) {
  const float4 a = rows[2 * k], b = rows[2 * k + 1];
  row[0] = a.x;
  row[1] = a.y;
  row[2] = a.z;
  row[3] = a.w;
  row[4] = b.x;
  row[5] = b.y;
}

// The live bits of the 32 staged bins w * 32 .. w * 32 + 31 (bins at or past
// m read rows beyond the chunk's and are masked off).
template <bool kNoNan>
__device__ __forceinline__ unsigned live_word(const float4* rows, int w, int m, V3 o, V3 inv,
                                              float tc) {
  unsigned word = 0u;
  // a partial unroll keeps the loop body inside the instruction cache
#pragma unroll 8
  for (int b = 0; b < kWord; ++b) {
    float row[6];
    staged_row(rows, w * kWord + b, row);
    const bool live = kNoNan ? slab_live_no_nan(row, o, inv, tc) : slab_live(row, o, inv, tc);
    word |= (unsigned)live << b;
  }
  const int left = m - w * kWord;
  return left >= kWord ? word : left > 0 ? word & ((1u << left) - 1u) : 0u;
}

// The ray's live bins among the m staged ones (bins base .. base + m - 1),
// this lane's words in turn; `cnt` (the same in every lane of the group)
// counts the ray's live bins so far.
template <bool kNoNan>
__device__ __forceinline__ void scan_chunk(const float4* rows, int m, int base, V3 o, V3 inv,
                                           float tc, int& cnt, int g, int i, int n, int skip,
                                           int c_out, int* slots) {
  const int words = (m + kWord - 1) / kWord;
  for (int w0 = 0; w0 < words; w0 += kLpr) {
    const int w = w0 + g;
    unsigned bits = w < words ? live_word<kNoNan>(rows, w, m, o, inv, tc) : 0u;
    // inclusive scan of the words' counts over the group's lanes
    const int own = __popc(bits);
    int upto = own;
#pragma unroll
    for (int k = 1; k < kLpr; k <<= 1) {
      const int v = __shfl_up_sync(kAll, upto, k, kLpr);
      if (g >= k) upto += v;
    }
    const int before = cnt + upto - own;
    cnt += __shfl_sync(kAll, upto, kLpr - 1, kLpr);
    if (before + own > skip && before < skip + c_out) {
      for (int idx = before; bits; bits &= bits - 1u, ++idx) {
        const int slot = idx - skip;
        if (slot >= 0 && slot < c_out)
          slots[(size_t)slot * n + i] = base + w * kWord + __ffs(bits) - 1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    phase1_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cull, int n, const float4* __restrict__ bounds,
                  int kb, int skip, int c_out, int* __restrict__ slots,
                  int* __restrict__ counts) {
  extern __shared__ float4 rows[];   // min(kb, kChunk) rows rounded up to a word, 2 each
  __shared__ uint64_t full;
  const int g = threadIdx.x % kLpr;   // lane in the ray's group
  const int i = blockIdx.x * kRays + threadIdx.x / kLpr;
  V3 o = v3(0.0f, 0.0f, 0.0f), inv = v3(1.0f, 1.0f, 1.0f);
  float tc = -INFINITY;
  if (i < n) {
    o = v3(ox[i], oy[i], oz[i]);
    inv = v3(1.0f / dx[i], 1.0f / dy[i], 1.0f / dz[i]);
    tc = t_cull[i];
  }
  const bool live = tc > -INFINITY;   // no box is live at -inf or NaN
  const bool no_nan = !live || (finite3(o) && finite3(inv) && inv.x != 0.0f &&
                                inv.y != 0.0f && inv.z != 0.0f);
  const bool warp_live = __any_sync(kAll, live);
  const bool warp_no_nan = __all_sync(kAll, no_nan);
  int cnt = 0;
  if (threadIdx.x == 0) mbar_init(&full);
  if (__syncthreads_or(live)) {
    for (int base = 0, round = 0; base < kb; base += kChunk, ++round) {
      const int m = min(kChunk, kb - base);
      if (round > 0) __syncthreads();   // every thread is done with the last chunk
      if (threadIdx.x == 0) bulk_copy(rows, bounds + (size_t)base * 2, m * 32u, &full);
      mbar_wait(&full, round & 1);
      bool rows_finite = true;
      for (int k = threadIdx.x; k < m; k += kThreads) {
        float row[6];
        staged_row(rows, k, row);
#pragma unroll
        for (int a = 0; a < 6; ++a) rows_finite &= isfinite(row[a]);
      }
      rows_finite = __syncthreads_and(rows_finite);
      if (!warp_live) continue;
      if (warp_no_nan && rows_finite)
        scan_chunk<true>(rows, m, base, o, inv, tc, cnt, g, i, n, skip, c_out, slots);
      else
        scan_chunk<false>(rows, m, base, o, inv, tc, cnt, g, i, n, skip, c_out, slots);
    }
  }
  if (i >= n) return;
  for (int slot = max(cnt - skip, 0) + g; slot < c_out; slot += kLpr)
    slots[(size_t)slot * n + i] = kDeadKey;
  if (g == 0) counts[i] = cnt;
}

}  // namespace

extern "C" int aptd_binned_phase1(const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const float* t_cull, int n, const float* bounds, int kb,
                                  int skip, int c_out, int* slots, int* counts, void* stream) {
  const int blocks = (n + kRays - 1) / kRays;
  if (blocks > 0 && kb > 0) {
    const int rows = min((kb + kWord - 1) / kWord * kWord, kChunk);
    phase1_kernel<<<blocks, kThreads, rows * 2 * sizeof(float4), (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, t_cull, n, reinterpret_cast<const float4*>(bounds), kb, skip,
        c_out, slots, counts);
  }
  return (int)cudaGetLastError();
}
