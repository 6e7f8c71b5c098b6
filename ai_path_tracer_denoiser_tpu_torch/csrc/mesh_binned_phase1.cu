// Bin subscription of the binned mesh pipeline: which bins is a ray live in?
//
// Replaces the TPU kernel render/mesh_binned.py:_build_phase1_kernel
// (launched by _phase1_call) of the JAX package.  Same contract: per ray,
// slab-test the kb bin boxes (supers of 256 faces) in ascending order
// against the ray's cull distance; count every live bin, and write the live
// bins numbered skip .. skip + c_out - 1 into the ray's c_out slots, the
// dead key (1 << 20) into slots that stay empty.  Here the liveness IS the
// result, so the slab test's NaN rule is written out (mesh_common.cuh).
//
// Design.  One thread per ray with the ray, its count and nothing else in
// registers; a block stages the bounds table through shared memory in
// chunks (every thread reads the same row: a broadcast), so any kb fits.
// Slots and counts are int32 planes, (c_out, N) and (N,), written directly
// and once each, neighbouring threads to neighbouring addresses.
//
// Bound on the H100: FP32 ALU work, N * kb slab tests of about 27
// operations; the bytes are 28 in and 4 * (c_out + 1) out per ray.
#include "mesh_common.cuh"

namespace {
using namespace aptd;

constexpr int kDeadKey = 1 << 20;
constexpr int kThreads = 128;
constexpr int kChunk = 512;   // bounds rows staged at a time (6 floats each)

__global__ void __launch_bounds__(kThreads)
    phase1_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cull, int n, const float* __restrict__ bounds,
                  int kb, int skip, int c_out, int* __restrict__ slots,
                  int* __restrict__ counts) {
  __shared__ float rows[kChunk * 6];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool in_range = i < n;
  V3 o = v3(0.0f, 0.0f, 0.0f), inv = v3(1.0f, 1.0f, 1.0f);
  float tc = -INFINITY;
  if (in_range) {
    o = v3(ox[i], oy[i], oz[i]);
    inv = v3(1.0f / dx[i], 1.0f / dy[i], 1.0f / dz[i]);
    tc = t_cull[i];
  }
  size_t stride = (size_t)n;
  int cnt = 0;
  for (int base = 0; base < kb; base += kChunk) {
    int m = min(kChunk, kb - base);
    __syncthreads();
    for (int j = threadIdx.x; j < m * 6; j += kThreads)
      rows[j] = bounds[(size_t)(base + j / 6) * kBoundsRow + j % 6];
    __syncthreads();
    if (!in_range) continue;
    for (int k = 0; k < m; ++k) {
      if (slab_live(rows + k * 6, o, inv, tc)) {
        int slot = cnt - skip;
        if (slot >= 0 && slot < c_out) slots[(size_t)slot * stride + i] = base + k;
        ++cnt;
      }
    }
  }
  if (!in_range) return;
  for (int slot = max(cnt - skip, 0); slot < c_out; ++slot)
    slots[(size_t)slot * stride + i] = kDeadKey;
  counts[i] = cnt;
}

}  // namespace

extern "C" int aptd_binned_phase1(const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const float* t_cull, int n, const float* bounds, int kb,
                                  int skip, int c_out, int* slots, int* counts, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    phase1_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, t_cull, n, bounds, kb, skip, c_out, slots, counts);
  }
  return (int)cudaGetLastError();
}
