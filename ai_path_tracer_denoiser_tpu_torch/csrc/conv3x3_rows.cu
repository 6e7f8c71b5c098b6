// Row-band fused SAME 3x3 conv + bias + LeakyReLU (+ per-channel affine).
//
// Replaces the TPU kernel models/conv_kernel.py:_build_kernel of the JAX
// package (conv3x3_act, impl "pallas", pl.pallas_call at :120): a band of
// output rows is computed from its rows of input once for all output
// channels, and the three input rows under an output row (dy) feed the
// contraction, as the TPU kernel's (W+2, 3C) row operand times the (3C,
// 3Co) packed weights does.  Input NHWC (N, HA, WA, Cin) bfloat16 or
// float32: either the image itself (HA = H, WA = W, `pad` = 0: the halo is
// zero-filled by bounds tests) or the conv_input_pad layout (HA = H + 2,
// WA >= W + 2, `pad` = 1: the zero border is in the array and only the
// array's own extent is tested).  Output (N, H, W, Co) in the input's type;
// sums and the epilogue are float32, rounded once at the store.
//
// Bound on the H100: bytes.  The frame's 28 convs move 586 MB (input,
// weights and output once each: 0.175 ms at 3.35 TB/s) and do 46 G
// multiply-adds (0.093 ms at 989 TFLOP/s).
//
// Two kernels, picked by the input's type:
//
// * bfloat16 input: conv3x3_rows_sm90, implicit GEMM with M = pixels, N =
//   output channels, K = (dy, dx) taps x 16-channel chunks, built from the
//   tile kernel's Hopper pieces (conv_sm90.cuh).
//   - Row bands: a block owns a band of TH output rows by a segment of 64
//     consecutive pixels of those rows.  Each of its two warpgroups owns MT
//     whole rows of the segment: a warpgroup's M = 64 is a run of pixels of
//     one output row, the TPU kernel's row operand.  The launcher
//     (conv_kernel.rows_plan) picks MT from the register budget: MT = 2
//     where a block covers at most 32 output channels (the 800x800 and
//     400x400 layers that move most of the frame's bytes), so a band is 4
//     rows and its halo (6 x 66 pixels) is read for 256 outputs, 1.55
//     pixels per output against 2.06 for a 2-row band; MT = 1 otherwise:
//     at 40 to 64 channels two rows measured slower, and above that two
//     rows of accumulators do not fit the budget.  Blocks of one
//     warpgroup (a 1-row band, 3 halo pixels per output) measured slower
//     at every frame shape, the small ones included, where they would
//     have given more blocks.  The budget gives 2 to 3 resident blocks per
//     SM (launch bounds below); at 800x800 and 400x400 shared memory
//     holds two.
//   - Asynchronous copies in a ring: each stage holds the band's halo of
//     one 16-channel chunk and the chunk's 9 x 16 x N packed weights
//     (pack_weights_sm90, packed once on the card and cached), copied in
//     16-byte pieces with cp.async while the products of the chunk before
//     run.  The ring has min(3, chunks) stages: a layer of one chunk (Cin
//     <= 16) asks for one stage's memory, not three.  An odd Cin takes the
//     tile kernel's piece copy and re-lay at the 48-byte pixel stride (21
//     of the frame's 28 input widths are not multiples of 8); Cin % 8 == 0
//     lands in place.  In the pad = 1 layout the zero border is in the
//     array, so only the array's extent is tested, once per block.
//   - Tensor cores: wgmma.mma_async m64nNk16 bf16 x bf16 -> f32, A from
//     registers by ldmatrix, so a tap's dx shift is a shifted A; B the
//     tap's 16 x N weight slice in the no-swizzle K-major layout.  A
//     warpgroup loads the A fragments of its MT + 2 halo rows at the three
//     dx shifts once per chunk and uses each for every output row it feeds
//     (halo row r is dy = 0, 1, 2 of output rows r, r - 1, r - 2).  With
//     two rows the halo rows go one at a time through two register sets,
//     each row's products committed as a group and waited for two rows
//     later, which keeps the budget of two resident blocks.
//   - All output channels per block: N = Co rounded up to 8.  Only where
//     the bands alone give fewer than 88 blocks (two thirds of the card's
//     132 SMs; images of 50x50 and below) are the channels dealt out to
//     several blocks, each of which then re-reads the band's halo: the
//     plan's sweep over the frame's shapes on the card found that cheaper
//     than filling all 132 SMs.
//   - Epilogue from the accumulator registers: bias, LeakyReLU, affine and
//     rounding in float32, stored straight to the output, masked at the
//     pixel and channel edges.
// * float32 input: conv3x3_rows_kernel, the first design, unchanged: a band of 8 rows x 16 columns staged once with
//   every input channel (scalar loads), 3xTF32 wmma (conv_mma.cuh) against
//   the (3 Cin, 3 Co) operand Wall[dy*Cin + c, dx*Co + o] = w[dy, dx, c, o]
//   (pack_weights), 32 output channels at a time.
//
// Built with default nvcc float semantics (multiply-add contraction on, no
// fast math).

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

constexpr int kSeg = 64;         // pixels of a band's segment: one warpgroup's M
constexpr int kHaloW = kSeg + 2;
constexpr int kWgThreads = 256;  // two warpgroups per block
constexpr int kRingMax = 3;      // stages of the halo + weight ring
constexpr int kMaxNB = 26;       // 8-channel groups per block (Co 208)
// Blocks per SM the register budget is set for: an 8-channel group of
// accumulators is 4 registers per row, the A fragments 12 per halo row.
constexpr int rows_min_blocks(int nb, int mt) {
  return mt == 2 ? 2 : (nb <= 4 ? 3 : (nb <= 13 ? 2 : 1));
}

template <int NB, int MT>
__global__ void __launch_bounds__(kWgThreads, rows_min_blocks(NB, MT))
conv3x3_rows_sm90(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                  const float* __restrict__ bias, const float* __restrict__ aff_s,
                  const float* __restrict__ aff_t, __nv_bfloat16* __restrict__ out, int HA,
                  int WA, int H, int W, int Cin, int Co, int pad, int segs_x, int nb_total,
                  float slope, int has_affine, int direct, int stages) {
  using namespace conv_sm90;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TH = 2 * MT;                     // output rows of the band
  constexpr int halo_pix = (TH + 2) * kHaloW;
  constexpr int raw_bytes = halo_pix * kPixBytes;
  constexpr int kWBytes = 9 * NB * 256;          // one chunk's weights: 9 taps x 16 x 8NB
  constexpr int nthreads = kWgThreads;
  constexpr int kItems = (3 * halo_pix + nthreads - 1) / nthreads;  // halo pieces per thread
  const int tid = threadIdx.x;
  const int stage_bytes = raw_bytes + kWBytes;
  unsigned char* abuf = smem + stages * stage_bytes;    // the re-laid halo (odd Cin)
  const int x0 = (blockIdx.x % segs_x) * kSeg, y0 = (blockIdx.x / segs_x) * TH;
  const int grp = blockIdx.y, img = blockIdx.z;
  const long long total = (long long)gridDim.z * HA * WA * Cin;
  const int chunks = (Cin + 15) / 16;
  const int ahead = stages > 1 ? stages - 1 : 1;        // chunks in flight

  // The halo pieces this thread copies (item i = tid + t * nthreads: pixel
  // i / 3, piece i % 3, landing at byte 16 i of the stage) and the halo
  // halves it re-lays (item i: pixel i / 2, channels 8 (i % 2) ..), as
  // pixel indices in the (HA, WA) array: they do not change from chunk to
  // chunk.  Halo pixel (hy, hx) is array pixel (y0 + hy - 1 + pad, x0 + hx
  // - 1 + pad).
  const long long img0 = (long long)img * HA * WA;   // the image's first pixel
  int pix[kItems], rpix[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int i = tid + t * nthreads;
    pix[t] = i < 3 * halo_pix ? halo_pixel(i / 3, kHaloW, x0 + pad, y0 + pad, HA, WA) : -1;
    rpix[t] = i < 2 * halo_pix ? halo_pixel(i >> 1, kHaloW, x0 + pad, y0 + pad, HA, WA) : -1;
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

  // Warpgroup wg owns output rows wg * MT .. wg * MT + MT - 1 of the band;
  // this lane's ldmatrix row is pixel P of the segment, channels 0-7 or 8-15.
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;
  const int P = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off = (wg * MT * kHaloW + P) * kPixBytes + (lane >> 4) * 16;

  float acc[MT * NB * 4];
#pragma unroll
  for (int i = 0; i < MT * NB * 4; ++i) acc[i] = 0.0f;
  fence_regs(acc);

  for (int s = 0; s < ahead; ++s) {
    start_copies(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    const int s = k % stages;
    if (ahead == 2) cp_async_wait<1>();   // chunk k has landed (this thread's copies)
    else cp_async_wait<0>();
    fence_proxy_async();                 // ... and is visible to wgmma's reads of B
    __syncthreads();                     // everyone's copies; stage k-1 is free
    if (k + ahead < chunks) start_copies(k + ahead, (k + ahead) % stages);
    cp_async_commit();
    uint32_t a_base = smem_addr(smem + s * stage_bytes);
    if (!direct) {
      relay(k, s);
      __syncthreads();
      a_base = smem_addr(abuf);
    }
    const uint32_t w_s = smem_addr(smem + s * stage_bytes + raw_bytes);
    if constexpr (MT == 1) {
      // A of the warpgroup's three halo rows (dy) at the three shifts (dx)
      uint32_t a[3][3][4];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          ldmatrix_x4(a[r][dx], a_base + a_off + (r * kHaloW + dx) * kPixBytes);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        wgmma_tap<NB>(acc, a[tap / 3][tap % 3], w_s + tap * NB * 256);
      wgmma_commit();
    } else {
      // Halo row r's three shifted A fragments feed dy = r - m of output
      // rows m; two sets of registers alternate, a set reloaded once the
      // products that read it two rows before are done (a register set for
      // each of the four halo rows would cost the second resident block).
      uint32_t a[2][3][4];
#pragma unroll
      for (int r = 0; r < MT + 2; ++r) {
        if (r >= 2) wgmma_wait<1>();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          ldmatrix_x4(a[r & 1][dx], a_base + a_off + (r * kHaloW + dx) * kPixBytes);
        wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int m = r - dy;
          if (m < 0 || m >= MT) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            wgmma_tap<NB>(acc + m * NB * 4, a[r & 1][dx], w_s + (dy * 3 + dx) * NB * 256);
        }
        wgmma_commit();
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // Epilogue from the accumulators: for each of the warpgroup's rows,
  // pixels lane/4 and lane/4 + 8 of the warp's 16, channels 8j + 2(lane%4)
  // and the one after.
  const int co0 = grp * NB * 8 + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int py = y0 + wg * MT + m;
    size_t row[2];
    bool live[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = x0 + wq * 16 + (lane >> 2) + 8 * half;
      live[half] = py < H && px < W;
      row[half] = ((size_t)(img * H + py) * W + px) * Co;
    }
    store_acc<NB>(acc + m * NB * 4, co0, Co, row, live, bias, aff_s, aff_t, slope, has_affine,
                  out, 0);
  }
}

template <int NB, int MT>
int launch_bf16(const void* x, const void* wp, const float* bias, const float* aff_s,
                const float* aff_t, void* out, int N, int HA, int WA, int H, int W, int Cin,
                int Co, int pad, int nb_total, float slope, int has_affine,
                cudaStream_t st) {
  const int TH = 2 * MT;
  const int direct = Cin % 8 == 0;
  const int chunks = (Cin + 15) / 16;
  const int stages = chunks < kRingMax ? chunks : kRingMax;
  const size_t raw = (size_t)(TH + 2) * kHaloW * conv_sm90::kPixBytes;
  const size_t bytes = stages * (raw + 9 * NB * 256) + (direct ? 0 : raw);
  auto kernel = conv3x3_rows_sm90<NB, MT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int segs_x = (W + kSeg - 1) / kSeg;
  dim3 grid(segs_x * ((H + TH - 1) / TH), nb_total / NB, N);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, kWgThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp), bias, aff_s,
      aff_t, static_cast<__nv_bfloat16*>(out), HA, WA, H, W, Cin, Co, pad, segs_x, nb_total,
      slope, has_affine, direct, stages);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 input: 3xTF32 wmma kernel
// ---------------------------------------------------------------------------

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

// MF = 16-pixel fragments per warp (1: the float32 path).
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

// bfloat16 input (in_f32 = 0): x (N, HA, WA, Cin) 16-byte aligned, w the
// (ceil(Cin/16), 9, nb_total, 2, 8, 8) packing of pack_weights_sm90
// (conv3x3_act.cu); a block takes `nb` groups of 8 output channels (one of
// 1-8, 10, 11, 13, 15, 19, 26; nb_total a multiple of nb and 8 * nb_total
// >= Co) of a band of 2 * mt rows by 64 pixels (mt rows per warpgroup, 1
// or 2, and 2 only with nb <= 4).  float32 input: w the (3 Cin, 3 Co)
// float32 operand of pack_weights; mt, nb, nb_total are not read.  pad = 1: x is the zero-bordered layout and pixel (y, x) of the
// image sits at (y + 1, x + 1).  out (N, H, W, Co) in x's type.  Returns a
// CUDA error code; cudaErrorInvalidValue (1) for a plan the kernel does not
// take, or (float32) when Cin needs more shared memory than a block has.
extern "C" int aptd_conv3x3_rows(const void* x, const void* w, const float* bias,
                                 const float* aff_s, const float* aff_t, void* out, int N,
                                 int HA, int WA, int H, int W, int Cin, int Co, int pad,
                                 float slope, int has_affine, int in_f32, int mt,
                                 int nb, int nb_total, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (in_f32)
    return launch<float, 1>(x, w, bias, aff_s, aff_t, out, N, HA, WA, H, W, Cin, Co, pad,
                            slope, has_affine, st);
  if ((mt != 1 && mt != 2) || (mt == 2 && nb > 4) ||
      nb <= 0 || nb > kMaxNB || nb_total % nb != 0 || 8 * nb_total < Co ||
      (pad != 0 && pad != 1) || HA < H + 2 * pad || WA < W + 2 * pad ||
      (long long)HA * WA > INT_MAX || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
#define APTD_ROWS_NB(n, m)                                                                 \
  case n:                                                                                   \
    return launch_bf16<n, m>(x, w, bias, aff_s, aff_t, out, N, HA, WA, H, W, Cin, Co, pad, \
                             nb_total, slope, has_affine, st);
  if (mt == 2) {
    switch (nb) {
      APTD_ROWS_NB(1, 2) APTD_ROWS_NB(2, 2) APTD_ROWS_NB(3, 2) APTD_ROWS_NB(4, 2)
    }
  }
  switch (nb) {
    APTD_ROWS_NB(1, 1) APTD_ROWS_NB(2, 1) APTD_ROWS_NB(3, 1) APTD_ROWS_NB(4, 1)
    APTD_ROWS_NB(5, 1) APTD_ROWS_NB(6, 1) APTD_ROWS_NB(7, 1) APTD_ROWS_NB(8, 1)
    APTD_ROWS_NB(10, 1) APTD_ROWS_NB(11, 1) APTD_ROWS_NB(13, 1) APTD_ROWS_NB(15, 1)
    APTD_ROWS_NB(19, 1) APTD_ROWS_NB(26, 1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef APTD_ROWS_NB
}
