// Row-band fused SAME 3x3 conv + bias + LeakyReLU (+ per-channel affine).
//
// Replaces the TPU kernel models/conv_kernel.py:_build_kernel of the JAX
// package (conv3x3_act, impl "pallas"): a band of rows is staged once and
// reused for all 9 taps and ALL output channels, the three dy taps ride the
// contraction, and the weights arrive packed as the (3*Cin, 3*Co) operand
// Wall[dy*Cin + c, dx*Co + o] = w[dy, dx, c, o] (pack_weights).  Input NHWC
// (N, HA, WA, Cin) bfloat16 or float32: either the image itself (HA = H,
// WA = W, `pad` = 0: the halo is zero-filled by bounds tests) or the
// conv_input_pad layout (HA = H + 2, WA >= W + 2, `pad` = 1: the zero border
// is in the array and only the array's own extent is tested).  Output
// (N, H, W, Co) in the input's type; sums and the epilogue are float32.
//
// Design for Hopper.  A block owns a band of 8 output rows x TW columns of
// one image (TW = 32 for bfloat16, 16 for float32) and loads the band's
// (8 + 2) x (TW + 2) halo with every input channel into shared memory ONCE
// (channels zero-padded to a multiple of 16; at Cin = 202 that is 141 KB, so
// the kernel asks for dynamic shared memory).  It then loops over the
// output channels in blocks of 32 inside the block, so the input is read
// from device memory once however many output channels there are (the tile
// kernel in conv3x3_act.cu re-reads it once per 32 output channels).  Only
// where an image has too few bands to fill the card's 132 SMs are a band's
// output-channel blocks dealt out to several blocks.  Warp r
// owns output row r of the band: for each block of 32 output channels it
// walks K = (dy, 16-channel chunk) with the 3 dx taps as shifted A
// fragments of the same halo rows, i.e. the TPU kernel's (W+2, 3C) row
// operand without ever building it, and accumulates TW x 32 outputs in
// tensor-core fragments (conv_mma.cuh: bfloat16 m16n16k16, or 3xTF32 for
// float32 inputs).  The 9 x 16 x 32 weight slice of each step is staged in
// shared memory from the packed operand; each warp passes its accumulators
// through a 2 KB staging tile of its own to a coalesced, masked epilogue
// (32 lanes = 32 consecutive channels of a pixel).
//
// Bound on the H100: bytes.  At the denoiser's shapes (Cin, Co <= 202) the
// tensor-core work is far below the card's rate, and each input, weight and
// output byte crosses device memory once; what the kernel does not yet do
// about it is overlap: the halo load is scalar, unpipelined, and the weight
// slices (L2 hits after the first block) are re-staged per step behind two
// block-wide barriers.  The halo's pixel stride is chosen 32 bytes off a
// multiple of 64 so that fragment loads stay 32-byte aligned with at most
// two-way bank conflicts.
//
// Built with default nvcc float semantics (multiply-add contraction on, no
// fast math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv_mma.cuh"

using namespace nvcuda;

namespace {

constexpr int kTH = 8;          // output rows per band: one warp each
constexpr int kWarps = kTH;
constexpr int kThreads = kWarps * 32;
constexpr int kKc = 16;         // input channels per step
constexpr int kBn = 32;         // output channels per inner block
constexpr int kWeightElems = 9 * kKc * kBn;
constexpr int kStageFloats = 16 * kBn;            // per warp: 16 pixels x 32 channels
constexpr int kMaxSmem = 232448;                  // a block's limit on sm_90
constexpr int kBlocksToFill = 2 * 132;            // two blocks on each of the card's SMs

// Channels per pixel in shared memory: Cin rounded up to 16, then stepped so
// that the stride in bytes is 32 more than a multiple of 64.
template <typename T>
__host__ __device__ inline int pixel_stride(int Cin) {
  const int cp = (Cin + kKc - 1) / kKc * kKc;
  const int unit = 32 / (int)sizeof(T);           // elements in 32 bytes
  return (cp / unit) % 2 == 1 ? cp : cp + unit;
}

template <typename T, int MF>
__host__ __device__ inline size_t smem_bytes(int Cin) {
  const size_t halo = (size_t)(kTH + 2) * (MF * 16 + 2) * pixel_stride<T>(Cin) * sizeof(T);
  return halo + kWeightElems * sizeof(T) + kWarps * kStageFloats * sizeof(float);
}

// MF = 16-pixel fragments per warp: 2 for bfloat16, 1 for float32.
template <typename T, int MF>
__global__ void __launch_bounds__(kThreads)
conv3x3_rows_kernel(const T* __restrict__ x, const T* __restrict__ wall,
                    const float* __restrict__ bias, const float* __restrict__ aff_s,
                    const float* __restrict__ aff_t, T* __restrict__ out, int HA, int WA, int H,
                    int W, int Cin, int Co, int pad, float slope, int has_affine, int groups,
                    int co_per_group) {
  using Tile = conv_mma::Tile<T>;
  constexpr int kTW = MF * 16;
  constexpr int kHaloW = kTW + 2;
  constexpr int kHaloPos = (kTH + 2) * kHaloW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cs = pixel_stride<T>(Cin);
  const int cp = (Cin + kKc - 1) / kKc * kKc;
  T* halo = reinterpret_cast<T*>(smem);
  T* wt = halo + (size_t)kHaloPos * cs;                      // byte offset a multiple of 32
  float* stage = reinterpret_cast<float*>(wt + kWeightElems);

  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const int img = blockIdx.z / groups;
  const int co_lo = (blockIdx.z % groups) * co_per_group;
  const int co_hi = min(Co, co_lo + co_per_group);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T zero = Tile::zero();

  // the band's halo, every channel, once
  for (int pos = warp; pos < kHaloPos; pos += kWarps) {
    const int gy = y0 + pos / kHaloW - 1 + pad;
    const int gx = x0 + pos % kHaloW - 1 + pad;
    const bool inside = gy >= 0 && gy < HA && gx >= 0 && gx < WA;
    const T* src = x + ((size_t)(img * HA + (inside ? gy : 0)) * WA + (inside ? gx : 0)) * Cin;
    T* dst = halo + (size_t)pos * cs;
    for (int c = lane; c < cp; c += 32) dst[c] = (inside && c < Cin) ? src[c] : zero;
  }

  float* my_stage = stage + warp * kStageFloats;
  const int gy_out = y0 + warp;
  const int wall_ld = 3 * Co;
#pragma unroll 1
  for (int co0 = co_lo; co0 < co_hi; co0 += kBn) {
    typename Tile::Acc acc[MF][2];
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[m][j], 0.0f);

#pragma unroll 1
    for (int c0 = 0; c0 < cp; c0 += kKc) {
      __syncthreads();           // the halo is complete; the last step's weights are used up
      for (int e = tid; e < kWeightElems; e += kThreads) {
        const int nn = e % kBn;
        const int kk = (e / kBn) % kKc;
        const int tap = e / (kBn * kKc);
        const int c = c0 + kk;
        const int o = co0 + nn;
        wt[e] = (c < Cin && o < Co)
                    ? wall[((size_t)(tap / 3) * Cin + c) * wall_ld + (tap % 3) * Co + o]
                    : zero;
      }
      __syncthreads();
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const T* wtap = wt + (dy * 3 + dx) * kKc * kBn;
          typename Tile::B b[2];
          Tile::load_b(b[0], wtap, kBn);
          Tile::load_b(b[1], wtap + 16, kBn);
#pragma unroll
          for (int m = 0; m < MF; ++m) {
            typename Tile::A a;
            Tile::load_a(a, halo + (size_t)((warp + dy) * kHaloW + m * 16 + dx) * cs + c0, cs);
            Tile::mma(acc[m][0], a, b[0]);
            Tile::mma(acc[m][1], a, b[1]);
          }
        }
      }
    }

    const int o = co0 + lane;
    const bool o_ok = o < Co;
    const float bo = o_ok ? bias[o] : 0.0f;
    const float so = (o_ok && has_affine) ? aff_s[o] : 1.0f;
    const float to = (o_ok && has_affine) ? aff_t[o] : 0.0f;
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      wmma::store_matrix_sync(my_stage, acc[m][0], kBn, wmma::mem_row_major);
      wmma::store_matrix_sync(my_stage + 16, acc[m][1], kBn, wmma::mem_row_major);
      __syncwarp();
      if (gy_out < H && o_ok) {
        for (int p = 0; p < 16; ++p) {
          const int gx = x0 + m * 16 + p;
          if (gx < W) {
            float v = my_stage[p * kBn + lane] + bo;
            v = v >= 0.0f ? v : v * slope;
            if (has_affine) v = v * so + to;
            out[((size_t)(img * H + gy_out) * W + gx) * Co + o] = Tile::from_float(v);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <typename T, int MF>
int launch(const void* x, const void* wall, const float* bias, const float* aff_s,
           const float* aff_t, void* out, int N, int HA, int WA, int H, int W, int Cin, int Co,
           int pad, float slope, int has_affine, cudaStream_t st) {
  const size_t bytes = smem_bytes<T, MF>(Cin);
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_rows_kernel<T, MF>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // One block takes every output channel of its band when the bands alone
  // fill the card; a small image's output-channel blocks are dealt out to
  // `groups` blocks per band instead (its input then sits in L2 anyway).
  const int bands = ((W + MF * 16 - 1) / (MF * 16)) * ((H + kTH - 1) / kTH) * N;
  const int co_blocks = (Co + kBn - 1) / kBn;
  int groups = (kBlocksToFill + bands - 1) / bands;
  groups = groups < 1 ? 1 : (groups > co_blocks ? co_blocks : groups);
  const int co_per_group = (co_blocks + groups - 1) / groups * kBn;
  groups = (Co + co_per_group - 1) / co_per_group;
  dim3 grid((W + MF * 16 - 1) / (MF * 16), (H + kTH - 1) / kTH, N * groups);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(x), static_cast<const T*>(wall),
                                        bias, aff_s, aff_t, static_cast<T*>(out), HA, WA, H, W,
                                        Cin, Co, pad, slope, has_affine, groups, co_per_group);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, HA, WA, Cin), wall (3*Cin, 3*Co) and out (N, H, W, Co) are float32
// when in_f32, else bfloat16.  pad = 1: x is the zero-bordered layout and
// pixel (y, x) of the image sits at (y + 1, x + 1).  Returns a CUDA error
// code; cudaErrorInvalidValue (1) when Cin needs more shared memory than a
// block has.
extern "C" int aptd_conv3x3_rows(const void* x, const void* wall, const float* bias,
                                 const float* aff_s, const float* aff_t, void* out, int N,
                                 int HA, int WA, int H, int W, int Cin, int Co, int pad,
                                 float slope, int has_affine, int in_f32, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (in_f32)
    return launch<float, 1>(x, wall, bias, aff_s, aff_t, out, N, HA, WA, H, W, Cin, Co, pad,
                            slope, has_affine, st);
  return launch<__nv_bfloat16, 2>(x, wall, bias, aff_s, aff_t, out, N, HA, WA, H, W, Cin, Co,
                                  pad, slope, has_affine, st);
}
