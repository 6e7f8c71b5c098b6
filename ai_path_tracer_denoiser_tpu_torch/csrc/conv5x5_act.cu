// K11: fused SAME 5x5 conv + bias + ReLU (or identity), bfloat16 in,
// float32 sums, bfloat16 or float32 out.
//
// Replaces no TPU kernel: the JAX package has no 5x5 conv.  It was added
// for the kernel-predicting denoiser (KPCN, models/kpcn.py), whose nine
// layers are 5x5 convs 100 channels wide (the last one 441 wide), and it is
// the 3x3 tile kernel of conv3x3_act.cu with the tap count raised to 25,
// built from the same Hopper pieces (conv_sm90.cuh).  Input NHWC
// (N, H, W, Cin) with Cin a multiple of 8 (the model keeps its activations
// padded to 104 channels and its features to 32, the extra channels zero,
// so every pixel starts on a 16-byte boundary); output (N, H, W, Co).
//
// Bound on the H100: operations.  A KPCN frame at 800x800 does 3.75 TFLOP
// (3.79 ms at 989 TFLOP/s) against about 1.7 GB of activations moved once
// (0.5 ms at 3.35 TB/s).  What limits the kernel is feeding the tensor
// cores: a block streams all 25 taps' weights for its channels once per
// tile, so the weights' traffic from L2 is as large as the products' rate
// allows, and the copies must run behind the products.
//
// Design, as the 3x3 kernel where not said:
// - Implicit GEMM, M = a tile of 64 or 128 output pixels (one or two
//   warpgroups), N = 8 * NB output channels (NB up to 16), K = 25 taps x
//   16-channel chunks.  Co = 100 takes NB 13 in one block; Co = 441 (56
//   groups of 8) NB 14 in four blocks per tile.
// - A ring of two stages (three do not fit: one chunk's 25 x 16 x 104
//   weights are 83 KB): each holds the tile's halo of one 16-channel chunk
//   ((TH + 4) x (TW + 4) pixels at the 48-byte stride) and the chunk's
//   packed weights, copied with cp.async while the chunk before is
//   multiplied.  Cin is a multiple of 8, so every copy lands in place and
//   nothing is re-laid.
// - The A fragments of a tap row (5 taps, 20 registers) are loaded by
//   ldmatrix and their products issued and committed as one group; two
//   rows' registers alternate, and a row's loads wait only for the products
//   of the row two before (wgmma.wait_group 1), so loads overlap products.
//   The 3x3 kernel's way, all taps' fragments loaded at once, would hold
//   100 registers here.
// - Epilogue from the accumulators (conv_sm90.cuh:store_acc): bias, then
//   ReLU (slope 0) or identity (slope 1), rounded once at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "conv_sm90.cuh"

namespace {

constexpr int kK = 5;               // taps per side
constexpr int kR = kK / 2;          // halo radius
constexpr int kTaps = kK * kK;
constexpr int kStages = 2;          // ring of halo + weight stages
constexpr int kMaxThreads = 256;    // two warpgroups
constexpr int kMaxNB = 16;          // 8-channel groups per block (Co 128)
// Halo pieces (2 per pixel) per thread: at most 2 * 216 over 128 threads
// (a 32x2 tile) and 2 * 288 over 256 (32x4).
constexpr int kItems = 4;

template <int NB>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv5x5_bf16_sm90(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                  const float* __restrict__ bias, void* __restrict__ out, int H, int W, int Cin,
                  int Co, int TW, int TH, int tiles_x, int nb_total, float slope, int out_f32) {
  using namespace conv_sm90;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kWBytes = kTaps * NB * 256;      // one chunk's weights: 25 taps x 16 x 8NB
  const int hw2 = TW + 2 * kR;
  const int halo_pix = (TH + 2 * kR) * hw2;
  const int raw_bytes = halo_pix * kPixBytes;
  const int stage_bytes = raw_bytes + kWBytes;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int x0 = (blockIdx.x % tiles_x) * TW, y0 = (blockIdx.x / tiles_x) * TH;
  const int grp = blockIdx.y, img = blockIdx.z;
  const int chunks = (Cin + 15) / 16;

  // The halo pieces this thread copies (item i = tid + t * nthreads: pixel
  // i / 2, channels 8 (i % 2) ..., landing at byte 48 (i / 2) + 16 (i % 2)
  // of the stage): their element offsets in x do not change from chunk to
  // chunk.
  const long long img0 = (long long)img * H * W;
  int pix[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int i = tid + t * nthreads;
    pix[t] = i < 2 * halo_pix ? halo_pixel<kR>(i >> 1, hw2, x0, y0, H, W) : -1;
  }

  // Start the copies of chunk k into stage s: halo pieces zero-filled
  // outside the image and past Cin, then the chunk's weights.
  auto start_copies = [&](int k, int s) {
    const uint32_t raw_s = smem_addr(smem + s * stage_bytes);
    const int c0 = k * 16;
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int i = tid + t * nthreads;
      if (i >= 2 * halo_pix) break;
      const int j = i & 1;
      const int bytes = (pix[t] >= 0 && c0 + 8 * j < Cin) ? 16 : 0;
      const __nv_bfloat16* src = bytes ? x + (img0 + pix[t]) * Cin + c0 + 8 * j : x;
      cp_async16(raw_s + (i >> 1) * kPixBytes + 16 * j, src, bytes);
    }
    copy_weights<NB, kTaps>(raw_s + raw_bytes,
                            wp + ((size_t)k * kTaps * nb_total + grp * NB) * 128, nb_total, tid,
                            nthreads);
  };

  // This lane's ldmatrix row: pixel P of the tile, channels 0-7 or 8-15.
  const int warp = tid >> 5, lane = tid & 31;
  const int P = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ty = P / TW;
  const uint32_t a_off = (ty * hw2 + P - ty * TW) * kPixBytes + (lane >> 4) * 16;

  float acc[NB * 4];
#pragma unroll
  for (int i = 0; i < NB * 4; ++i) acc[i] = 0.0f;
  fence_regs(acc);

  start_copies(0, 0);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int s = k % kStages;
    cp_async_wait<0>();                // chunk k has landed (this thread's copies)
    fence_proxy_async();               // ... and is visible to wgmma's reads of B
    __syncthreads();                   // everyone's copies; chunk k-1's products are done
    if (k + 1 < chunks) start_copies(k + 1, (k + 1) % kStages);
    cp_async_commit();
    const uint32_t a_base = smem_addr(smem + s * stage_bytes) + a_off;
    const uint32_t w_s = smem_addr(smem + s * stage_bytes + raw_bytes);
    uint32_t a[2][kK][4];
#pragma unroll
    for (int dy = 0; dy < kK; ++dy) {
      if (dy >= 2) wgmma_wait<1>();    // row dy - 2's products no longer read a[dy & 1]
#pragma unroll
      for (int dx = 0; dx < kK; ++dx)
        ldmatrix_x4(a[dy & 1][dx], a_base + (dy * hw2 + dx) * kPixBytes);
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < kK; ++dx)
        wgmma_tap<NB>(acc, a[dy & 1][dx], w_s + (dy * kK + dx) * NB * 256);
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  const int co0 = grp * NB * 8 + 2 * (lane & 3);
  size_t row[2];
  bool live[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = warp * 16 + (lane >> 2) + 8 * half;
    const int py = y0 + p / TW, px = x0 + p % TW;
    live[half] = py < H && px < W;
    row[half] = ((size_t)(img * H + py) * W + px) * Co;
  }
  store_acc<NB>(acc, co0, Co, row, live, bias, bias, bias, slope, 0, out, out_f32);
}

template <int NB>
int launch(const void* x, const void* wp, const float* bias, void* out, int N, int H, int W,
           int Cin, int Co, int TW, int nwg, int nb_total, float slope, int out_f32,
           cudaStream_t st) {
  const int TH = 64 * nwg / TW;
  const size_t bytes =
      kStages * ((size_t)(TH + 2 * kR) * (TW + 2 * kR) * conv_sm90::kPixBytes + kTaps * NB * 256);
  auto kernel = conv5x5_bf16_sm90<NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW;
  dim3 grid(tiles_x * ((H + TH - 1) / TH), nb_total / NB, N);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, 128 * nwg, bytes, st>>>(static_cast<const __nv_bfloat16*>(x),
                                         static_cast<const __nv_bfloat16*>(wp), bias, out, H, W,
                                         Cin, Co, TW, TH, tiles_x, nb_total, slope, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin) bfloat16, 16-byte aligned, Cin a multiple of 8; w the
// (ceil(Cin/16), 25, nb_total, 2, 8, 8) packing of
// models/conv_kernel.py:pack_weights_sm90 for a (5, 5, Cin, Co) weight; a
// block takes `nb` groups of 8 output channels (1, 2, 4, 8, 13, 14 or 16;
// nb_total a multiple of nb and 8 * nb_total >= Co) of a tile of 64 * nwg
// pixels, tw wide (8, 16 or 32).  bias float32 (Co,); slope 0 for ReLU, 1
// for none.  out (N, H, W, Co) is float32 when out_f32, else bfloat16.
// Returns a CUDA error code; cudaErrorInvalidValue (1) for a call or plan
// the kernel does not take.
extern "C" int aptd_conv5x5_act(const void* x, const void* w, const float* bias, void* out,
                                int N, int H, int W, int Cin, int Co, float slope, int out_f32,
                                int tw, int nwg, int nb, int nb_total, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  if ((nwg != 1 && nwg != 2) || (tw != 8 && tw != 16 && tw != 32) || Cin <= 0 ||
      Cin % 8 != 0 || nb <= 0 || nb > kMaxNB || nb_total % nb != 0 || 8 * nb_total < Co ||
      (long long)H * W > INT_MAX || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define APTD_CONV5_NB(n)                                                                    \
  case n:                                                                                   \
    return launch<n>(x, w, bias, out, N, H, W, Cin, Co, tw, nwg, nb_total, slope, out_f32, \
                     st);
  switch (nb) {
    APTD_CONV5_NB(1) APTD_CONV5_NB(2) APTD_CONV5_NB(4) APTD_CONV5_NB(8) APTD_CONV5_NB(13)
    APTD_CONV5_NB(14) APTD_CONV5_NB(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef APTD_CONV5_NB
}
