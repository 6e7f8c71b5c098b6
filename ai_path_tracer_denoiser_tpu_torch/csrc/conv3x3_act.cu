// Fused SAME 3x3 conv + bias + LeakyReLU (+ per-channel affine x*s+t).
//
// Replaces the TPU kernel models/conv_kernel.py:_build_kernel_chw of the JAX
// package (conv3x3_act_chw, impl "pallas2", pl.pallas_call at :287), which
// the denoiser's 28 convolutions per frame go through at inference and, in
// training, the forward pass and the input gradient of every conv (slope 1,
// zero bias, float32 out; the input gradient is this kernel called on the
// output gradient with the weights flipped and transposed).  Input NHWC
// (N, H, W, Cin), output (N, H, W, Co) bfloat16 or float32; bias, scale and
// shift float32 (Co,).  Sums are float32; the epilogue runs in float32 and
// rounds once at the store.
//
// Bound on the H100: bytes.  The frame's 28 convs move 586 MB (input,
// weights and output once each: 0.175 ms at 3.35 TB/s) and do 46 G
// multiply-adds (0.093 ms at 989 TFLOP/s), so the kernel must read its
// input once, keep copies in flight behind the products, and waste little
// tensor-core work on padding.
//
// Two kernels, picked by the input's type:
//
// * bfloat16 input (every default path): conv3x3_bf16_sm90, implicit GEMM
//   with M = pixels, N = output channels, K = 9 taps x 16-channel chunks.
//   A block of one or two warpgroups owns a tile of 64 or 128 output pixels
//   (8x8, 16x8, ... : the launcher picks the shape that wastes the least of
//   a ragged image) and N = 8 * NB output channels, NB up to 26 (Co 208).
//   - Input read once for all output channels: one block covers every
//     output channel of its tile (Co rounded up to 8, not 32).  Only where
//     the tiles alone cannot fill the card's 132 SMs (images of 50x50 and
//     below) are the channels dealt out to several blocks, as the row-band
//     kernel's launcher does; small images also take 64-pixel tiles.
//   - Asynchronous 16-byte copies in a ring of three stages: each stage
//     holds the tile's halo of one 16-channel chunk and the chunk's 9 x 16
//     x N packed weights (pack_weights_sm90), copied with cp.async while
//     the products of the chunk before run.  An odd Cin (21 of the frame's
//     28 input widths are not multiples of 8) puts a pixel's channels off
//     the 16-byte grid, so each halo pixel copies the 16-byte pieces that
//     cover its 16 channels from the boundary at or below their start (two
//     or three pieces; the copy of the tensor's last piece is cut at its
//     end with cp.async's source size) and the block re-lays them at a
//     fixed 48-byte pixel stride, zero outside the image and past Cin.
//     When Cin is a multiple of 8 the pieces are already aligned: they land
//     in place (zero-filled by the copy itself) and nothing is re-laid.
//   - Tensor cores: wgmma.mma_async m64nNk16 bf16 x bf16 -> f32.  A comes
//     from registers, loaded by ldmatrix out of the halo: a tap's (dy, dx)
//     shift moves A by whole pixels, which a shared-memory A operand's
//     core-matrix layout could not follow.  B is the tap's 16 x N weight
//     slice in shared memory, in the no-swizzle K-major core-matrix layout
//     (conv_sm90.cuh).  The 48-byte pixel stride puts the 8 rows of every
//     ldmatrix in 8 different groups of 4 banks: no bank conflicts.
//   - Padding: Co is padded to a multiple of 8 and Cin to 16 (the depth of
//     one product); a Cin = 3 layer multiplies zeros in 13 of its 16 input
//     channels, but at 800x800 its bytes, not its products, set its time.
//   - Epilogue from the accumulator registers: bias, LeakyReLU, affine and
//     the rounding, in float32, stored straight to the output (channel
//     pairs when Co is even), masked at the pixel and channel edges.
//   - What is left looks like latency (no profiler reaches the card): a
//     block's few chunks wait in series (copy, barrier, products), and the
//     kernel runs fastest with the most blocks resident.  Each thread finds
//     its halo pixels once, not per chunk, and the register budget is set
//     so that three blocks of up to 32 channels (two of up to 104) fit on
//     an SM.  Over the frame's 28 shapes the
//     kernel runs at about 15% of the byte bound (PERF.md), its 800x800
//     layers at 17-29%.
// * float32 input: conv3x3_tf32_kernel, a 16x16 pixel tile x 32 output
//   channels per block; the 9 taps are shifted wmma fragments of one halo
//   tile staged in shared memory (scalar loads), the products 3xTF32
//   (conv_mma.cuh), which keeps float32 accuracy.
//
// Built with default nvcc float semantics (multiply-add contraction on, no
// fast math); the float32 epilogue differs from the plain version only by
// that contraction and by the summation order of the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

#include "conv_mma.cuh"
#include "conv_sm90.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// bfloat16 input: wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kStages = 3;       // ring of halo + weight stages
constexpr int kMaxThreads = 256; // two warpgroups
constexpr int kMaxNB = 26;       // 8-channel groups per block (Co 208)
// Halo pieces (3 per pixel) per thread: at most 3 * 136 over 128 threads
// (a 32x2 tile) and 3 * 204 over 256 (32x4).
constexpr int kItems = 4;

// Blocks per SM the register budget is set for: an 8-channel group of
// accumulators is 4 registers, the 9 taps' A fragments 36.
constexpr int min_blocks(int nb) { return nb <= 4 ? 3 : (nb <= 13 ? 2 : 1); }

template <int NB>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(NB))
conv3x3_bf16_sm90(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                  const float* __restrict__ bias, const float* __restrict__ aff_s,
                  const float* __restrict__ aff_t, void* __restrict__ out, int H, int W, int Cin,
                  int Co, int TW, int TH, int tiles_x, int nb_total, float slope, int has_affine,
                  int out_f32, int direct) {
  using namespace conv_sm90;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kWBytes = 9 * NB * 256;          // one chunk's weights: 9 taps x 16 x 8NB
  const int hw2 = TW + 2;
  const int halo_pix = (TH + 2) * hw2;
  const int raw_bytes = halo_pix * kPixBytes;
  const int stage_bytes = raw_bytes + kWBytes;
  unsigned char* abuf = smem + kStages * stage_bytes;   // the re-laid halo (odd Cin)
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int x0 = (blockIdx.x % tiles_x) * TW, y0 = (blockIdx.x / tiles_x) * TH;
  const int grp = blockIdx.y, img = blockIdx.z;
  const long long total = (long long)gridDim.z * H * W * Cin;
  const int chunks = (Cin + 15) / 16;

  // The halo pieces this thread copies (item i = tid + t * nthreads: pixel
  // i / 3, piece i % 3, landing at byte 16 i of the stage) and the halo
  // halves it re-lays (item i: pixel i / 2, channels 8 (i % 2) ..): their
  // pixels' element offsets in x do not change from chunk to chunk.
  const long long img0 = (long long)img * H * W;     // the image's first pixel
  int pix[kItems], rpix[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int i = tid + t * nthreads;
    pix[t] = i < 3 * halo_pix ? halo_pixel(i / 3, hw2, x0, y0, H, W) : -1;
    rpix[t] = i < 2 * halo_pix ? halo_pixel(i >> 1, hw2, x0, y0, H, W) : -1;
  }

  // Start the copies of chunk k into stage s.
  auto start_copies = [&](int k, int s) {
    const uint32_t raw_s = smem_addr(smem + s * stage_bytes);
    const int c0 = k * 16;
    const int nvalid = min(16, Cin - c0);
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int i = tid + t * nthreads;
      if (i >= 3 * halo_pix) break;
      copy_piece(raw_s + i * 16, x, (img0 + pix[t]) * Cin + c0, i % 3, nvalid, total,
                 pix[t] >= 0, direct);
    }
    copy_weights<NB>(raw_s + raw_bytes, wp + ((size_t)k * 9 * nb_total + grp * NB) * 128,
                     nb_total, tid, nthreads);
  };

  // Re-lay chunk k's halo from stage s at the 48-byte pixel stride (odd Cin).
  auto relay = [&](int k, int s) {
    const uint32_t* raw = reinterpret_cast<const uint32_t*>(smem + s * stage_bytes);
    const int nvalid = min(16, Cin - k * 16);
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int i = tid + t * nthreads;
      if (i >= 2 * halo_pix) break;
      const int hp = i >> 1, h = i & 1;
      relay_half(abuf + hp * kPixBytes + h * 16, raw + hp * (kPixBytes / 4),
                 (int)(((img0 + rpix[t]) * Cin) & 7), h, nvalid, rpix[t] >= 0);
    }
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

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) start_copies(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    const int s = k % kStages;
    cp_async_wait<kStages - 2>();      // chunk k has landed (this thread's copies)
    fence_proxy_async();               // ... and is visible to wgmma's reads of B
    __syncthreads();                   // everyone's copies; stage k-1 is free
    if (k + kStages - 1 < chunks) start_copies(k + kStages - 1, (k + kStages - 1) % kStages);
    cp_async_commit();
    uint32_t a_base = smem_addr(smem + s * stage_bytes);
    if (!direct) {
      relay(k, s);
      __syncthreads();
      a_base = smem_addr(abuf);
    }
    uint32_t a[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      ldmatrix_x4(a[tap], a_base + a_off + ((tap / 3) * hw2 + tap % 3) * kPixBytes);
    const uint32_t w_s = smem_addr(smem + s * stage_bytes + raw_bytes);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) wgmma_tap<NB>(acc, a[tap], w_s + tap * NB * 256);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // Epilogue from the accumulators: rows lane/4 and lane/4 + 8 of the warp's
  // 16 pixels, channels 8j + 2(lane%4) and the one after.
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
  store_acc<NB>(acc, co0, Co, row, live, bias, aff_s, aff_t, slope, has_affine, out, out_f32);
}

template <int NB>
int launch_bf16(const void* x, const void* wp, const float* bias, const float* aff_s,
                const float* aff_t, void* out, int N, int H, int W, int Cin, int Co, int TW,
                int nwg, int nb_total, float slope, int has_affine, int out_f32,
                cudaStream_t st) {
  const int TH = 64 * nwg / TW;
  const int direct = Cin % 8 == 0;
  const size_t raw = (size_t)(TH + 2) * (TW + 2) * conv_sm90::kPixBytes;
  const size_t bytes = kStages * (raw + 9 * NB * 256) + (direct ? 0 : raw);
  auto kernel = conv3x3_bf16_sm90<NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW;
  dim3 grid(tiles_x * ((H + TH - 1) / TH), nb_total / NB, N);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, 128 * nwg, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp), bias, aff_s,
      aff_t, out, H, W, Cin, Co, TW, TH, tiles_x, nb_total, slope, has_affine, out_f32, direct);
  return (int)cudaGetLastError();
}

// The B operand's layout (pack_weights_sm90 of models/conv_kernel.py):
// wp[k][t][j][h][r][c] = w[t][16k + 8h + c][8j + r], zero past Cin and Co;
// one thread per element of wp.
__global__ void pack_weights_sm90(const __nv_bfloat16* __restrict__ w,
                                  __nv_bfloat16* __restrict__ wp, int Cin, int Co, int n_cols,
                                  int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int c = e & 7, r = (e >> 3) & 7, h = (e >> 6) & 1;
  const int rest = e >> 7;                   // (k * 9 + t) * (n_cols / 8) + j
  const int j = rest % (n_cols / 8), kt = rest / (n_cols / 8);
  const int t = kt % 9, k = kt / 9;
  const int ci = 16 * k + 8 * h + c, o = 8 * j + r;
  wp[e] = (ci < Cin && o < Co) ? w[((size_t)t * Cin + ci) * Co + o] : __float2bfloat16_rn(0.0f);
}

// ---------------------------------------------------------------------------
// float32 input: 3xTF32 wmma kernel
// ---------------------------------------------------------------------------

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
conv3x3_tf32_kernel(const T* __restrict__ x, const T* __restrict__ w,
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

// w (3, 3, Cin, Co) bfloat16 -> wp (ceil(Cin/16), 9, n_cols/8, 2, 8, 8), the
// layout conv3x3_bf16_sm90 reads its weights in.  Returns a CUDA error code.
extern "C" int aptd_conv3x3_pack_weights(const void* w, void* wp, int Cin, int Co, int n_cols,
                                         void* stream) {
  if (Cin <= 0 || Co <= 0 || n_cols % 8 != 0 || n_cols < Co) return (int)cudaErrorInvalidValue;
  const int n = (Cin + 15) / 16 * 9 * n_cols * 16;
  pack_weights_sm90<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp), Cin, Co, n_cols,
      n);
  return (int)cudaGetLastError();
}

// bfloat16 input (in_f32 = 0): x (N, H, W, Cin) 16-byte aligned, w the
// (ceil(Cin/16), 9, nb_total, 2, 8, 8) packing of pack_weights_sm90; a block
// takes `nb` groups of 8 output channels (one of 1-8, 10, 11, 13, 15, 19, 26;
// nb_total a multiple of nb and 8 * nb_total >= Co) of a tile of 64 * nwg
// pixels, tw wide (8, 16 or 32).  float32 input: w (3, 3, Cin, Co) float32;
// tw, nwg, nb, nb_total are not read.  out (N, H, W, Co) is float32 when
// out_f32, else bfloat16.  Returns a CUDA error code; cudaErrorInvalidValue
// (1) for a plan the kernel does not take.
extern "C" int aptd_conv3x3_act(const void* x, const void* w, const float* bias,
                                const float* aff_s, const float* aff_t, void* out, int N, int H,
                                int W, int Cin, int Co, float slope, int has_affine, int in_f32,
                                int out_f32, int tw, int nwg, int nb, int nb_total,
                                void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (in_f32) {
    const int co_blocks = (Co + kBn - 1) / kBn;
    dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N * co_blocks);
    if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidConfiguration;
    conv3x3_tf32_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias, aff_s, aff_t, out, H,
        W, Cin, Co, co_blocks, slope, has_affine, out_f32);
    return (int)cudaGetLastError();
  }
  if ((nwg != 1 && nwg != 2) || (tw != 8 && tw != 16 && tw != 32) || nb <= 0 ||
      nb > kMaxNB || nb_total % nb != 0 || 8 * nb_total < Co || (long long)H * W > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
#define APTD_CONV_NB(n) \
  case n:               \
    return launch_bf16<n>(x, w, bias, aff_s, aff_t, out, N, H, W, Cin, Co, tw, nwg, nb_total, \
                          slope, has_affine, out_f32, st);
  switch (nb) {
    APTD_CONV_NB(1) APTD_CONV_NB(2) APTD_CONV_NB(3) APTD_CONV_NB(4) APTD_CONV_NB(5)
    APTD_CONV_NB(6) APTD_CONV_NB(7) APTD_CONV_NB(8) APTD_CONV_NB(10) APTD_CONV_NB(11)
    APTD_CONV_NB(13) APTD_CONV_NB(15) APTD_CONV_NB(19) APTD_CONV_NB(26)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef APTD_CONV_NB
}
