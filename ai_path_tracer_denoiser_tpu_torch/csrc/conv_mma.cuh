// Tensor-core tile products shared by the two conv kernels (conv3x3_act.cu,
// conv3x3_rows.cu): acc (16 x 16, float32) += A (16 x 16) * B (16 x 16), with
// A and B row-major in shared memory.  Operands are loaded once (load_a,
// load_b) and may enter several products.
//
// bfloat16 operands: one wmma m16n16k16 product, exact products, float32 sums.
//
// float32 operands: the 3xTF32 scheme.  Each operand is split into the part a
// TF32 holds (10 mantissa bits) and the TF32 of what is left,
// v = hi + lo, and the product is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// in two m16n16k8 steps.  Only lo*lo is dropped (about 2^-22 relative), so
// the result keeps float32 accuracy; one TF32 product alone would lose 13 of
// the 24 mantissa bits.  The small terms are added first.
//
// Every pointer handed to a wmma load or store here is 32-byte aligned and
// every leading dimension a multiple of 16 bytes, as wmma requires.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace conv_mma {

using namespace nvcuda;

template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  struct B {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> f;
  };
  static __device__ __forceinline__ void load_b(B& b, const __nv_bfloat16* p, int ld) {
    wmma::load_matrix_sync(b.f, p, ld);
  }
  struct A {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> f;
  };
  static __device__ __forceinline__ void load_a(A& a, const __nv_bfloat16* p, int ld) {
    wmma::load_matrix_sync(a.f, p, ld);
  }
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const B& b) {
    wmma::mma_sync(c, a.f, b.f, c);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16_rn(0.0f); }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Tile<float> {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  struct B {
    FragB hi[2], lo[2];   // the two k8 halves of a 16-deep tile
  };
  template <typename Frag>
  static __device__ __forceinline__ void split(Frag& hi, Frag& lo) {
#pragma unroll
    for (int t = 0; t < hi.num_elements; ++t) {
      const float v = hi.x[t];
      const float h = wmma::__float_to_tf32(v);
      hi.x[t] = h;
      lo.x[t] = wmma::__float_to_tf32(v - h);
    }
  }
  static __device__ __forceinline__ void load_b(B& b, const float* p, int ld) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wmma::load_matrix_sync(b.hi[h], p + h * 8 * ld, ld);
      split(b.hi[h], b.lo[h]);
    }
  }
  struct A {
    FragA raw[2];         // split at each use: keeping hi and lo alive costs 16 registers
  };
  static __device__ __forceinline__ void load_a(A& a, const float* p, int ld) {
#pragma unroll
    for (int h = 0; h < 2; ++h) wmma::load_matrix_sync(a.raw[h], p + h * 8, ld);
  }
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const B& b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      FragA a_hi = a.raw[h], a_lo;
      split(a_hi, a_lo);
      wmma::mma_sync(c, a_lo, b.hi[h], c);
      wmma::mma_sync(c, a_hi, b.lo[h], c);
      wmma::mma_sync(c, a_hi, b.hi[h], c);
    }
  }
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

}  // namespace conv_mma
