// K12: the kernel-predicting denoiser's per-pixel kernel apply.
//
// out[n, y, x, c] = sum_t softmax(logits[n, y, x, 0:K*K])[t]
//                         * rad[n, c, y + t / K - R, x + t % K - R]
// for c = 0..2, R = K / 2, the radiance zero outside the image.
//
// Replaces no TPU kernel: the JAX package has no kernel-predicting
// denoiser.  It was added for KPCN (models/kpcn.py): no ATen call forms a
// softmax over each pixel's 441 logits and gathers the 21x21 window it
// weights, and the plain version (F.unfold) writes a 441-fold copy of the
// radiance (3.4 GB at 800x800) to do it.
//
// Bound on the H100: bytes.  Each pixel's logits are read once (441
// bfloat16, 882 B), its radiance once and its result written once (12 B
// each): 0.173 ms at 800x800 and 3.35 TB/s.  The work per pixel (441
// exponentials, 1,323 multiply-adds) is small beside it.
//
// Design: a block of 8 warps takes a 16x16 tile of pixels; it first stages
// the tile's radiance with its R-pixel border (zero outside the image) in
// shared memory, three planes.  Each warp then takes the tile's pixels one
// at a time: its 32 lanes read the pixel's logits as bfloat16 pairs (one
// 128-byte line per instruction, 7 instructions for K = 21), form the
// maximum over the warp, then each lane adds exp(logit - max) (as
// 2^(logit log2 e - max log2 e), the hardware's base-2 exponential) and its
// product with the window's radiance, read from shared memory at offsets
// the lane finds once for all pixels, over its taps; five shuffle steps
// sum the four partial sums over the warp, and lane 0 writes the pixel's 3
// float32 values divided by the sum.  Every sum is float32.  Built with
// -fmad=false, so that each multiply and add rounds as the plain version's
// do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;           // tile side, pixels
constexpr int kWarps = 8;
constexpr int kMaxK = 21;
constexpr int kPairs = 7;           // bfloat16 pairs per lane: 7 * 64 >= 441
constexpr float kLog2e = 1.4426950408889634f;

__global__ void __launch_bounds__(kWarps * 32)
kernel_apply(const __nv_bfloat16* __restrict__ logits, const float* __restrict__ rad,
             float* __restrict__ out, int H, int W, int ldl, int K, int tiles_x) {
  extern __shared__ float win[];    // three planes of (kTile + 2R)^2 floats
  const int R = K / 2, side = kTile + 2 * R, plane = side * side;
  const int img = blockIdx.y;
  const int x0 = (blockIdx.x % tiles_x) * kTile, y0 = (blockIdx.x / tiles_x) * kTile;
  const size_t hw = (size_t)H * W;
  const float* r_img = rad + (size_t)img * 3 * hw;
  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    const int gy = y0 + i / side - R, gx = x0 + i % side - R;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t at = (size_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < 3; ++c) win[c * plane + i] = in ? r_img[c * hw + at] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kk = K * K;
  // This lane's taps t = 2 (lane + 32 q) + e and their offsets in the
  // window from its top left pixel (-1: past the k*k taps), the same for
  // every pixel.
  int off[2 * kPairs];
#pragma unroll
  for (int i = 0; i < 2 * kPairs; ++i) {
    const int t = 2 * (lane + 32 * (i >> 1)) + (i & 1);
    off[i] = t < kk ? (t / K) * side + t % K : -1;
  }
  for (int p = warp; p < kTile * kTile; p += kWarps) {
    const int py = p / kTile, px = p % kTile;
    const int y = y0 + py, x = x0 + px;
    if (y >= H || x >= W) continue;                 // warp-uniform
    const __nv_bfloat162* lp = reinterpret_cast<const __nv_bfloat162*>(
        logits + ((size_t)img * hw + (size_t)y * W + x) * ldl);
    float v[2 * kPairs];
    float m = -INFINITY;
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int t = 2 * (lane + 32 * q);
      float2 f = make_float2(-INFINITY, -INFINITY);
      if (t < kk) {
        f = __bfloat1622float2(lp[lane + 32 * q]);
        if (t + 1 >= kk) f.y = -INFINITY;
      }
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
      m = fmaxf(m, fmaxf(f.x, f.y));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float m2 = m * kLog2e;
    const int base = py * side + px;
    float s = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 2 * kPairs; ++i) {
      if (off[i] >= 0) {
        const float wgt = exp2f(v[i] * kLog2e - m2);
        const int at = base + off[i];
        s += wgt;
        a0 += wgt * win[at];
        a1 += wgt * win[plane + at];
        a2 += wgt * win[2 * plane + at];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      a0 += __shfl_xor_sync(0xffffffffu, a0, o);
      a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    if (lane == 0) {
      float* o = out + ((size_t)img * hw + (size_t)y * W + x) * 3;
      o[0] = a0 / s;
      o[1] = a1 / s;
      o[2] = a2 / s;
    }
  }
}

}  // namespace

// logits (N, H, W, ldl) bfloat16, the first K*K of each pixel used (ldl
// even and at least K*K + 1 when K*K is odd, so that the pairs read stay in
// the pixel's row); rad (N, 3, H, W) float32; out (N, H, W, 3) float32.  K
// odd, 1..21.  Returns a CUDA error code; cudaErrorInvalidValue (1) for a
// call the kernel does not take.
extern "C" int aptd_kernel_apply(const void* logits, const float* rad, float* out, int N, int H,
                                 int W, int ldl, int K, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (K <= 0 || K > kMaxK || K % 2 == 0 || ldl % 2 != 0 || ldl < K * K + (K * K) % 2 ||
      reinterpret_cast<uintptr_t>(logits) % 4 != 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const int side = kTile + 2 * (K / 2);
  const size_t bytes = 3 * sizeof(float) * side * side;
  cudaError_t err = cudaFuncSetAttribute(kernel_apply, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kTile - 1) / kTile;
  dim3 grid(tiles_x * ((H + kTile - 1) / kTile), N);
  kernel_apply<<<grid, kWarps * 32, bytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(logits), rad, out, H, W, ldl, K, tiles_x);
  return (int)cudaGetLastError();
}
