// Hopper (sm_90a) building blocks of the two bfloat16 conv kernels, the tile
// kernel (conv3x3_act.cu) and the row-band kernel (conv3x3_rows.cu):
// 16-byte asynchronous copies into shared memory, the piece copy and re-lay
// of a halo pixel's 16-channel chunk, ldmatrix, warpgroup matrix products
// (wgmma) with A in registers and B in shared memory, and the epilogue.
//
// wgmma.mma_async m64nNk16, bfloat16 x bfloat16 -> float32.  A (64 x 16) is
// the register fragment of the four warps of a warpgroup: warp w holds rows
// 16w..16w+15 as four 32-bit registers, laid out as one ldmatrix.x4 leaves
// them (rows 0-7 / 8-15 of channels 0-7, then of channels 8-15).  B (16 x N)
// is read from shared memory through a descriptor in the no-swizzle,
// K-major core-matrix layout: a core matrix is 8 output channels x 8 input
// channels, 128 contiguous bytes (one 16-byte row of 8 input channels per
// output channel); the two core matrices of a 16-deep slice sit 128 bytes
// apart (the leading byte offset, K direction) and consecutive groups of 8
// output channels 256 bytes apart (the stride byte offset, N direction).
// The accumulator fragment of thread (warp w, lane l) holds, for each group
// j of 8 output channels, rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1):
// d[4j + 0..3] = (r, c), (r, c+1), (r+8, c), (r+8, c+1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace conv_sm90 {

constexpr int kPixBytes = 48;    // a halo pixel's slot: 16 channels + 8 of slack

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (0..16) from global memory and zero the rest of the 16 bytes
// at dst; src and dst 16-byte aligned.  bytes == 0 reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's completed generic-proxy writes to shared memory (the
// cp.async copies) visible to the async proxy that wgmma reads B through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Descriptor of a K-major, no-swizzle B operand starting at shared address
// `addr` (16-byte aligned): leading byte offset 128, stride byte offset 256.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products (they change the registers behind its back).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0 .. N/2) += A (64 x 16, registers) * B (16 x N, descriptor), N = 8 * G.
template <int G>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_bf16<1>(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<2>(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<3>(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, "
      "p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<4>(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[0 .. 4 NB) += A * B for one tap: the tap's 16 x 8NB weight slice at
// shared address wt, in m64n32 products and one narrower one.
template <int NB>
__device__ __forceinline__ void wgmma_tap(float* d, const uint32_t (&a)[4], uint32_t wt) {
#pragma unroll
  for (int g = 0; g + 4 <= NB; g += 4) wgmma_bf16<4>(d + 4 * g, a, b_desc(wt + g * 256));
  if constexpr (NB % 4 != 0)
    wgmma_bf16<NB % 4>(d + 4 * (NB - NB % 4), a, b_desc(wt + (NB - NB % 4) * 256));
}

// One chunk's weights for NB groups of 8 output channels: 9 taps x 16 x 8NB
// of the packing of pack_weights_sm90 (wk = the chunk's first tap at the
// block's first group; nb_total groups in all), copied to w_s in 16-byte
// pieces by the block's threads.
template <int NB>
__device__ __forceinline__ void copy_weights(uint32_t w_s, const __nv_bfloat16* wk, int nb_total,
                                             int tid, int nthreads) {
  for (int i = tid; i < 9 * NB * 16; i += nthreads) {
    const int tap = i / (NB * 16), r = i - tap * (NB * 16);
    cp_async16(w_s + i * 16, wk + (size_t)tap * nb_total * 128 + r * 8, 16);
  }
}

// Pixel index (gy * W + gx) within its image of halo pixel hp of a halo
// hw2 pixels wide whose first pixel sits at (y0 - 1, x0 - 1), or -1
// outside the image.
__device__ __forceinline__ int halo_pixel(int hp, int hw2, int x0, int y0, int H, int W) {
  const int hy = hp / hw2;
  const int gy = y0 + hy - 1, gx = x0 + (hp - hy * hw2) - 1;
  return (gy < 0 || gy >= H || gx < 0 || gx >= W) ? -1 : gy * W + gx;
}

// Piece j (0-2) of a halo pixel's 16-channel chunk, copied to the stage's
// shared address dst.  e is the element index in x of the chunk's first
// channel, nvalid its channels left in the tensor (1-16), total x's
// elements, inside whether the pixel lies in the image.  direct (Cin a
// multiple of 8): pieces 0 and 1 land in place, zero-filled outside the
// image and past Cin.  Otherwise the pieces covering [e, e + nvalid) are
// copied from the 16-byte boundary at or below e (the tensor's last piece
// cut at its end), for relay_half to re-lay.
__device__ __forceinline__ void copy_piece(uint32_t dst, const __nv_bfloat16* x, long long e,
                                           int j, int nvalid, long long total, bool inside,
                                           bool direct) {
  if (direct) {
    if (j == 2) return;
    const int bytes = (inside && 8 * j < nvalid) ? 16 : 0;
    cp_async16(dst, bytes ? x + e + 8 * j : x, bytes);
  } else {
    if (!inside) return;
    const long long a = (e & ~7LL) + 8 * j;
    if (a >= e + nvalid) return;
    const long long left = total - a;
    cp_async16(dst, x + a, left >= 8 ? 16 : (int)left * 2);
  }
}

// Re-lays half h (channels 8h .. 8h + 7) of a halo pixel's chunk copied by
// copy_piece from its slot `raw` to dst at the 48-byte pixel stride: eight
// channels from 32-bit words, shifted by half a word where the chunk starts
// on an odd element (e0 = its first element's index mod 8); zero outside
// the image and past Cin.
__device__ __forceinline__ void relay_half(unsigned char* dst, const uint32_t* raw, int e0, int h,
                                           int nvalid, bool inside) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (inside) {
    e0 += 8 * h;
    const uint32_t* src = raw + (e0 >> 1);
    uint32_t wd[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) wd[q] = src[q];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = (e0 & 1) ? __funnelshift_r(wd[q], wd[q + 1], 16) : wd[q];
      const int c = 8 * h + 2 * q;
      if (c >= nvalid) v[q] = 0u;
      else if (c + 1 >= nvalid) v[q] &= 0xFFFFu;
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// Epilogue of one warp's 16 pixels from the accumulators of one 64-row
// product: rows lane/4 and lane/4 + 8 (output elements row[half], live
// where the pixel is in the image), channels co0 + 8j (co0 = the block's
// first channel + 2(lane%4)) and the one after.  Bias, LeakyReLU, affine
// and the rounding in float32, stored straight to out (channel pairs when
// Co is even), masked at the channel edge.
template <int NB>
__device__ __forceinline__ void store_acc(const float* acc, int co0, int Co, const size_t (&row)[2],
                                          const bool (&live)[2], const float* __restrict__ bias,
                                          const float* __restrict__ aff_s,
                                          const float* __restrict__ aff_t, float slope,
                                          int has_affine, void* __restrict__ out, int out_f32) {
  const bool pairs = !(Co & 1);     // channel pairs stay aligned for one store
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int c = co0 + 8 * j;
    if (c >= Co) continue;
    const bool two = c + 1 < Co;
    float bq[2], sq[2] = {1.0f, 1.0f}, tq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int o = two ? c + q : c;
      bq[q] = bias[o];
      if (has_affine) {
        sq[q] = aff_s[o];
        tq[q] = aff_t[o];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!live[half]) continue;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float y = acc[4 * j + 2 * half + q] + bq[q];
        y = y >= 0.0f ? y : y * slope;
        v[q] = has_affine ? y * sq[q] + tq[q] : y;
      }
      const size_t idx = row[half] + c;
      if (out_f32) {
        float* o = static_cast<float*>(out) + idx;
        if (two && pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        } else {
          o[0] = v[0];
          if (two) o[1] = v[1];
        }
      } else {
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + idx;
        if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          o[0] = __float2bfloat16_rn(v[0]);
          if (two) o[1] = __float2bfloat16_rn(v[1]);
        }
      }
    }
  }
}

}  // namespace conv_sm90
