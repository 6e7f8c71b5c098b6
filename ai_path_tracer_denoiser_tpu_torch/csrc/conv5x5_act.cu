// K11: fused SAME 5x5 conv + bias + ReLU (or identity), bfloat16 in,
// float32 sums, bfloat16 or float32 out.
//
// Replaces no TPU kernel: the JAX package has no 5x5 conv.  It was added
// for the kernel-predicting denoiser (KPCN, models/kpcn.py), whose nine
// layers are 5x5 convs 100 channels wide (the last one 441 wide).  Input
// NHWC (N, H, W, Cin) with Cin a multiple of 8 (the model keeps its
// activations padded to 104 channels and its features to 32, the extra
// channels zero, so every pixel starts on a 16-byte boundary); output
// (N, H, W, Co).
//
// Bound on the H100: operations.  A KPCN frame at 800x800 does 3.75 TFLOP
// (3.79 ms at 989 TFLOP/s) against about 1.7 GB of activations moved once
// (0.5 ms at 3.35 TB/s).  What limits the kernel is feeding the tensor
// cores: a block streams all 25 taps' weights for its channels from L2
// once per tile and 16-channel chunk, 25 x 16 x 8NB x 2 bytes (83 KB at
// NB = 13), and both operands of every product come from shared memory.
//
// Design:
// - Implicit GEMM, M = a tile of 256 output pixels (8 wide, 32 tall), N =
//   8 * NB output channels (NB up to 13), K = 25 taps x 16-channel chunks.
//   The 256-pixel tile halves the weights' L2 bytes per product against a
//   128-pixel one: a chunk's 83 KB feed 21.3 MFLOP (NB = 13), 256
//   operations a byte.  models/conv_kernel.py:conv5_plan picks NB from the
//   shapes: Co = 100 takes NB 13 in one block a tile, Co = 441 (56 groups
//   of 8) NB 8 in seven (no padded channel, and m64n64 products run nearer
//   the tensor cores' rate than m64n104 ones, which outweighs staging each
//   halo seven times).
// - Both operands from shared memory.  A chunk's halo ((TH + 4) x (TW + 4)
//   pixels) is kept as two planes, channels 0-7 and 8-15, at 16 bytes a
//   pixel, so a tile row of 8 pixels shifted by a tap is one 8 x 8 core
//   matrix and a tap's A operand is a descriptor (tile rows 192 bytes
//   apart, planes one plane apart).  No register that a product in flight
//   reads is written by other instructions, so ptxas keeps the products
//   asynchronous across the chunk loop (A fragments loaded into registers
//   there make it serialise every product).  Descriptors are built from
//   warp-uniform values, so they live in uniform registers and a product
//   costs two or three instructions besides itself.
// - Warp-specialised: two consumer warpgroups of 128 pixels, each as two
//   m64 products that share the tap's B descriptor (one instruction each),
//   and one producer warpgroup (64 registers, the consumers 216).  The
//   producer keeps two rings full: one thread copies each tap row's weights
//   (5 x 16 x 8NB, one run where a block takes all of Co, else 5 runs of NB
//   x 256 bytes) by bulk copy into a ring of ten (two chunks), and three
//   warps copy each chunk's halo by cp.async into a ring of three,
//   zero-filled outside the image and past Cin, every piece in place; a
//   halo thread waits for its pieces and fences them for the async proxy
//   before it arrives.  Every stage has a full and an empty barrier.
// - No block barrier after the start: a consumer issues a tap row's ten
//   products as one group and waits only until two groups are in flight,
//   then releases the weights of the row two before (and, at the second
//   row of a chunk, the chunk before's halo).  So the tensor cores hold
//   queued products across rows and chunks, and the copies run two chunks
//   ahead of them.
// - Persistent blocks, one per SM, walk the (image, tile, channel block)
//   items with the channel blocks of a tile adjacent; the producer runs
//   into the next item while the consumers store this one.
// - Epilogue from the accumulators (conv_sm90.cuh:store_acc): bias, then
//   ReLU (slope 0) or identity (slope 1), rounded once at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "conv_sm90.cuh"

namespace {

constexpr int kK = 5;               // taps per side
constexpr int kR = kK / 2;          // halo radius
constexpr int kTaps = kK * kK;
constexpr int kTW = 8, kTH = 32;    // the pixel tile: one core matrix a row
constexpr int kHW = kTW + 2 * kR;   // halo width
constexpr int kHaloPix = (kTH + 2 * kR) * kHW;
constexpr int kPlane = kHaloPix * 16;            // one plane: 8 channels a pixel
constexpr int kHaloBytes = 2 * kPlane;
constexpr int kHaloStages = 3;      // ring of chunk halos
constexpr int kWStages = 10;        // ring of tap rows' weights: two chunks
constexpr int kInflight = 2;        // tap rows' products a consumer keeps queued
constexpr int kProducerRegs = 64, kConsumerRegs = 216;   // 384 threads' 168 moved
constexpr int kConsumers = 256;     // two warpgroups of 128 pixels
constexpr int kThreads = kConsumers + 128;       // and one producer warpgroup
constexpr int kHaloThreads = 96;    // the producer's warps 1-3
constexpr int kItems = (2 * kHaloPix + kHaloThreads - 1) / kHaloThreads;   // halo pieces a thread

// Descriptor of a K-major, no-swizzle operand at shared address `addr`:
// core matrices `lbo` bytes apart along K and `sbo` bytes apart along M or
// N, as its low word (start and lbo) and high word (sbo).  Adding (bytes >>
// 4) to the low word moves the start by `bytes`; only the low word changes
// from tap to tap and stage to stage.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}
__device__ __forceinline__ uint64_t desc(uint32_t lo, uint32_t sbo) {
  return ((uint64_t)(sbo >> 4) << 32) | lo;
}

#define APTD_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d[0 .. 4 NB) += A (64 x 16) * B (16 x 8NB), both read from shared memory
// through their descriptors.
template <int NB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<1>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : APTD_ACC4(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<2>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : APTD_ACC4(0), APTD_ACC4(4)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<4>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : APTD_ACC4(0), APTD_ACC4(4), APTD_ACC4(8), APTD_ACC4(12)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<8>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : APTD_ACC4(0), APTD_ACC4(4), APTD_ACC4(8), APTD_ACC4(12), APTD_ACC4(16),
        APTD_ACC4(20), APTD_ACC4(24), APTD_ACC4(28)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<13>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
      : APTD_ACC4(0), APTD_ACC4(4), APTD_ACC4(8), APTD_ACC4(12), APTD_ACC4(16),
        APTD_ACC4(20), APTD_ACC4(24), APTD_ACC4(28), APTD_ACC4(32), APTD_ACC4(36),
        APTD_ACC4(40), APTD_ACC4(44), APTD_ACC4(48)
      : "l"(da), "l"(db), "r"(1));
}

#undef APTD_ACC4

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
conv5x5_bf16_sm90(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                  const float* __restrict__ bias, void* __restrict__ out, int H, int W, int Cin,
                  int Co, int tiles_x, int tiles, int items, int nb_total, float slope,
                  int out_f32) {
  using namespace aptd;
  using namespace conv_sm90;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRowBytes = kK * NB * 256;       // a tap row's weights: 5 taps x 16 x 8NB
  const int tid = threadIdx.x;
  const int groups = nb_total / NB;
  const int chunks = (Cin + 15) / 16;
  const bool one_run = groups == 1;      // a tap row's weights: one run, else kK
  unsigned char* const wring = smem + kHaloStages * kHaloBytes;   // after the halo ring
  const uint32_t base = smem_addr(smem), wbase = smem_addr(wring);
  // Barriers: the halo stages' full and empty, then the weight stages'.
  uint64_t* const h_full = reinterpret_cast<uint64_t*>(wring + kWStages * kRowBytes);
  uint64_t* const h_empty = h_full + kHaloStages;
  uint64_t* const w_full = h_empty + kHaloStages;
  uint64_t* const w_empty = w_full + kWStages;
  if (tid == 0) {
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(h_full + s, kHaloThreads);
      mbar_init(h_empty + s, kConsumers / 32);
    }
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(w_full + s, one_run ? 1 : kK);     // one arrival a copy
      mbar_init(w_empty + s, kConsumers / 32);
    }
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread's bulk copies of the weights, three warps'
    // cp.async of the halo, each running ahead as far as its ring allows ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int pt = tid - kConsumers;
    if (pt == 0) {
      int wit = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int grp = item % groups;
        for (int k = 0; k < chunks; ++k) {
          for (int dy = 0; dy < kK; ++dy, ++wit) {
            const int s = wit % kWStages;
            mbar_wait(w_empty + s, ((wit / kWStages) & 1) ^ 1);   // the consumers let go of s
            unsigned char* const dst = wring + s * kRowBytes;
            const __nv_bfloat16* wk =
                wp + ((size_t)(k * kTaps + dy * kK) * nb_total + grp * NB) * 128;
            if (one_run) {
              bulk_copy(dst, wk, kRowBytes, w_full + s);
            } else {
              for (int dx = 0; dx < kK; ++dx)
                bulk_copy(dst + dx * NB * 256, wk + (size_t)dx * nb_total * 128, NB * 256,
                          w_full + s);
            }
          }
        }
      }
    } else if (pt >= 32) {
      const int ht = pt - 32;
      int hit = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int t = item / groups;
        const int tile = t % tiles, img = t / tiles;
        const int x0 = (tile % tiles_x) * kTW, y0 = (tile / tiles_x) * kTH;
        const __nv_bfloat16* xi = x + (long long)img * H * W * Cin;
        for (int k = 0; k < chunks; ++k, ++hit) {
          const int s = hit % kHaloStages;
          mbar_wait(h_empty + s, ((hit / kHaloStages) & 1) ^ 1);
          const uint32_t st = base + s * kHaloBytes;
          const int c0 = k * 16;
          // Piece i: channels 8 (i % 2) ... of halo pixel i / 2, landing in
          // plane i % 2 at 16 (i / 2); zero outside the image and past Cin.
#pragma unroll
          for (int q = 0; q < kItems; ++q) {
            const int i = ht + q * kHaloThreads;
            if (i >= 2 * kHaloPix) break;
            const int j = i & 1;
            const int p = halo_pixel<kR>(i >> 1, kHW, x0, y0, H, W);
            const int bytes = (p >= 0 && c0 + 8 * j < Cin) ? 16 : 0;
            const __nv_bfloat16* src = bytes ? xi + (long long)p * Cin + c0 + 8 * j : x;
            cp_async16(st + j * kPlane + (i >> 1) * 16, src, bytes);
          }
          // The products read the halo through the async proxy: it must
          // have landed, and be ordered before them, when this thread arrives.
          cp_async_commit();
          cp_async_wait<0>();
          fence_proxy_async();
          mbar_arrive(h_full + s);
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups, two m64 products each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    // wg read from lane 0: the compiler then knows it is the same across
    // the warp, and keeps the descriptors in uniform registers.
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), warp = (tid >> 5) & 3, lane = tid & 31;
    // Product h of warpgroup wg: tile rows 8 (2 wg + h) .. + 7, one core
    // matrix each, kHW halo pixels apart; the two channel halves a plane
    // apart.
    uint32_t a_lo[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) a_lo[h] = desc_lo(base + 8 * (2 * wg + h) * kHW * 16, kPlane);
    const uint32_t b_lo = desc_lo(wbase, 128);
    float acc[2][NB * 4];
    int hit = 0, wit = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int grp = item % groups, t = item / groups;
      const int tile = t % tiles, img = t / tiles;
      const int x0 = (tile % tiles_x) * kTW, y0 = (tile / tiles_x) * kTH;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < NB * 4; ++i) acc[h][i] = 0.0f;
        fence_regs(acc[h]);
      }
      const int w0 = wit;                // the item's first tap row
      for (int k = 0; k < chunks; ++k, ++hit) {
        const int hs = hit % kHaloStages;
        mbar_wait(h_full + hs, (hit / kHaloStages) & 1);   // chunk k's halo has landed
        const uint32_t ho = hs * kHaloBytes >> 4;
#pragma unroll
        for (int dy = 0; dy < kK; ++dy, ++wit) {
          const int ws = wit % kWStages;
          mbar_wait(w_full + ws, (wit / kWStages) & 1);     // ... and tap row dy's weights
          const uint32_t db = b_lo + (ws * kRowBytes >> 4);
          wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < kK; ++dx) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              wgmma_ss<NB>(acc[h], desc(a_lo[h] + ho + dy * kHW + dx, kHW * 16),
                           desc(db + dx * NB * 16, 256));
          }
          wgmma_commit();
          // The row kInflight before has retired: its weights go back, and
          // with the chunk before's last row that chunk's halo.
          wgmma_wait<kInflight>();
          if (wit - kInflight >= w0) {
            __syncwarp();
            if (lane == 0) {
              mbar_arrive(w_empty + (wit - kInflight) % kWStages);
              if (dy == kInflight - 1 && k > 0) mbar_arrive(h_empty + (hit - 1) % kHaloStages);
            }
          }
        }
      }
      wgmma_wait_all();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      __syncwarp();
      if (lane == 0) {
        for (int r = wit - kInflight; r < wit; ++r) mbar_arrive(w_empty + r % kWStages);
        mbar_arrive(h_empty + (hit - 1) % kHaloStages);
      }

      const int co0 = grp * NB * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        size_t row[2];
        bool live[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = 128 * wg + 64 * h + 16 * warp + (lane >> 2) + 8 * half;
          const int py = y0 + p / kTW, px = x0 + p % kTW;
          live[half] = py < H && px < W;
          row[half] = ((size_t)(img * H + py) * W + px) * Co;
        }
        store_acc<NB>(acc[h], co0, Co, row, live, bias, bias, bias, slope, 0, out, out_f32);
      }
    }
  }
}

template <int NB>
int launch(const void* x, const void* wp, const float* bias, void* out, int N, int H, int W,
           int Cin, int Co, int nb_total, float slope, int out_f32, cudaStream_t st) {
  const size_t bytes = kHaloStages * (kHaloBytes + 16) + kWStages * (kK * NB * 256 + 16);
  auto kernel = conv5x5_bf16_sm90<NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles_x = (W + kTW - 1) / kTW;
  const long long tiles = (long long)tiles_x * ((H + kTH - 1) / kTH);
  const long long items = tiles * N * (nb_total / NB);
  if (items > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)(items < sms ? items : sms);
  kernel<<<grid, kThreads, bytes, st>>>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<const __nv_bfloat16*>(wp), bias, out, H, W,
                                        Cin, Co, tiles_x, (int)tiles, (int)items, nb_total, slope,
                                        out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin) bfloat16, 16-byte aligned, Cin a multiple of 8; w the
// (ceil(Cin/16), 25, nb_total, 2, 8, 8) packing of
// models/conv_kernel.py:pack_weights_sm90 for a (5, 5, Cin, Co) weight,
// 16-byte aligned; a block takes `nb` groups of 8 output channels (1, 2,
// 4, 8 or 13; nb_total a multiple of nb and 8 * nb_total >= Co) of a
// tile tw x th = 8 x 32 pixels.  bias float32 (Co,); slope 0 for ReLU, 1
// for none.  out (N, H, W, Co) is float32 when out_f32, else bfloat16.
// Returns a CUDA error code; cudaErrorInvalidValue (1) for a call or plan
// the kernel does not take.
extern "C" int aptd_conv5x5_act(const void* x, const void* w, const float* bias, void* out,
                                int N, int H, int W, int Cin, int Co, float slope, int out_f32,
                                int tw, int th, int nb, int nb_total, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaGetLastError();
  if (tw != kTW || th != kTH || Cin <= 0 || Cin % 8 != 0 || nb <= 0 || nb_total % nb != 0 ||
      8 * nb_total < Co || (long long)H * W > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define APTD_CONV5_NB(n)                                                                  \
  case n:                                                                                 \
    return launch<n>(x, w, bias, out, N, H, W, Cin, Co, nb_total, slope, out_f32, st);
  switch (nb) {
    APTD_CONV5_NB(1) APTD_CONV5_NB(2) APTD_CONV5_NB(4) APTD_CONV5_NB(8) APTD_CONV5_NB(13)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef APTD_CONV5_NB
}
