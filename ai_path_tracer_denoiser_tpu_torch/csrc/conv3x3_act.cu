// Fused SAME 3x3 conv + bias + LeakyReLU (+ per-channel affine x*s+t).
//
// Replaces the TPU kernel models/conv_kernel.py:_build_kernel_chw of the
// JAX package (conv3x3_act_chw, impl "pallas2"), which the denoiser's 28
// convolutions per frame go through at inference and, in training, the
// forward pass and the input gradient of every conv (slope 1, zero bias,
// float32 out; the input gradient is this kernel called on the output
// gradient with the weights flipped and transposed).  Input NHWC
// (N, H, W, Cin) bfloat16 or float32, weights HWIO (3, 3, Cin, Co) in the
// input's type, bias/scale/shift float32 (Co,), output (N, H, W, Co)
// bfloat16 or float32.  bfloat16 products are exact in the tensor cores;
// float32 inputs go through the 3xTF32 scheme of conv_mma.cuh, which keeps
// float32 accuracy.  Sums are float32; the epilogue runs in float32 and
// rounds once at the store.
//
// Design (implicit GEMM, M = pixels, N = output channels, K = 9 * Cin):
// a block owns a 16x16 pixel tile of one image and 32 output channels.  For
// each step of 16 input channels it stages the tile's 18x18 halo (zero
// outside the image and past Cin) and the 9 taps' 16x32 weight slices in
// shared memory; then each of its 8 warps runs, for each tap, 16x16x16
// tile products for its two tile rows: a tile row of 16 pixels shifted by
// (dy, dx) is a 16x16 A fragment read straight from the halo (row stride
// 16 channels), so the 9 taps need no im2col copy and each input element
// is read from device memory once per output-channel block, not 9 times.
// The accumulators go through shared memory to a masked epilogue, which
// handles the ragged pixel and channel edges (any N, H, W, Cin, Co).
//
// Bound on the H100: at the main paths' shapes the tensor-core work is far
// below the card's rate; the kernel is bound by its loads, which are
// scalar loads into shared memory with no cp.async/TMA pipelining and no
// double buffering, by the padding of Cin to 16 and Co to 32, and by
// grid.z = N * ceil(Co/32) blocks each reading the input again (7 times at
// Co = 202, the bottleneck's input gradient).  Vector loads, a deeper
// pipeline and wgmma are the later work.
//
// Built with default nvcc float semantics (multiply-add contraction on, no
// fast math); the float32 epilogue differs from the plain version only by
// that contraction and by the summation order of the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv_mma.cuh"

using namespace nvcuda;

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kKc = 16;        // input channels per step (one tile product's depth)
constexpr int kBn = 32;        // output channels per block
constexpr int kWarps = 8;      // warp w: tile rows 2w, 2w+1; all 32 channels
constexpr int kThreads = kWarps * 32;

constexpr int kHaloElems = kHaloH * kHaloW * kKc;     // 5184
constexpr int kWeightElems = 9 * kKc * kBn;           // 4608
constexpr int kStageElems = kTileH * kTileW * kBn;    // 8192 floats

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ aff_s,
                   const float* __restrict__ aff_t, void* __restrict__ out, int H, int W,
                   int Cin, int Co, int co_blocks, float slope, int has_affine, int out_f32) {
  using Tile = conv_mma::Tile<T>;
  constexpr int kHaloBytes = kHaloElems * (int)sizeof(T);      // a multiple of 32
  constexpr int kOperandBytes = kHaloBytes + kWeightElems * (int)sizeof(T);
  constexpr int kSmemBytes = kOperandBytes > kStageElems * 4 ? kOperandBytes : kStageElems * 4;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  T* halo = reinterpret_cast<T*>(smem);
  T* wt = reinterpret_cast<T*>(smem + kHaloBytes);
  float* stage = reinterpret_cast<float*>(smem);   // reused after the K loop

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int img = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z % co_blocks) * kBn;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const T zero = Tile::zero();
  const int row0 = img * H;          // the image's first row in the (N*H, W, C) arrays

  typename Tile::Acc acc[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[r][j], 0.0f);

  for (int c0 = 0; c0 < Cin; c0 += kKc) {
    for (int e = tid; e < kHaloElems; e += kThreads) {
      const int ch = e % kKc;
      const int pos = e / kKc;
      const int gy = y0 + pos / kHaloW - 1;
      const int gx = x0 + pos % kHaloW - 1;
      const int c = c0 + ch;
      halo[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin)
                    ? x[((size_t)(row0 + gy) * W + gx) * Cin + c]
                    : zero;
    }
    for (int e = tid; e < kWeightElems; e += kThreads) {
      const int nn = e % kBn;
      const int kk = (e / kBn) % kKc;
      const int tap = e / (kBn * kKc);
      const int c = c0 + kk;
      const int o = co0 + nn;
      wt[e] = (c < Cin && o < Co) ? w[((size_t)tap * Cin + c) * Co + o] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      typename Tile::B b[2];
      Tile::load_b(b[0], wt + tap * kKc * kBn, kBn);
      Tile::load_b(b[1], wt + tap * kKc * kBn + 16, kBn);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 2 + r;
        typename Tile::A a;
        Tile::load_a(a, halo + ((row + dy) * kHaloW + dx) * kKc, kKc);
        Tile::mma(acc[r][0], a, b[0]);
        Tile::mma(acc[r][1], a, b[1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stage + (warp * 2 + r) * kTileW * kBn + j * 16, acc[r][j], kBn,
                              wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < kStageElems; e += kThreads) {
    const int nn = e % kBn;
    const int m = e / kBn;
    const int gy = y0 + m / kTileW;
    const int gx = x0 + m % kTileW;
    const int o = co0 + nn;
    if (gy < H && gx < W && o < Co) {
      float v = stage[e] + bias[o];
      v = v >= 0.0f ? v : v * slope;
      if (has_affine) v = v * aff_s[o] + aff_t[o];
      const size_t idx = ((size_t)(row0 + gy) * W + gx) * Co + o;
      if (out_f32)
        static_cast<float*>(out)[idx] = v;
      else
        static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

// x (N, H, W, Cin) and w (3, 3, Cin, Co) are float32 when in_f32, else
// bfloat16; out (N, H, W, Co) is float32 when out_f32, else bfloat16.
extern "C" int aptd_conv3x3_act(const void* x, const void* w, const float* bias,
                                const float* aff_s, const float* aff_t, void* out, int N, int H,
                                int W, int Cin, int Co, float slope, int has_affine, int in_f32,
                                int out_f32, void* stream) {
  const int co_blocks = (Co + kBn - 1) / kBn;
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N * co_blocks);
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_f32) {
    conv3x3_act_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias, aff_s, aff_t, out, H,
        W, Cin, Co, co_blocks, slope, has_affine, out_f32);
  } else {
    conv3x3_act_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias, aff_s,
        aff_t, out, H, W, Cin, Co, co_blocks, slope, has_affine, out_f32);
  }
  return (int)cudaGetLastError();
}
