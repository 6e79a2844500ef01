// Grouped expert FFN for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels/
// grouped_gemm.py: _pallas_ffn (_kernel), the expert FFN of the MoE block
// on sort-dispatched buckets, and _pallas_ffn_q (_qkernel), the same over
// int8 expert weights:
//
//     out[e] = cast_to_x_dtype(act(x[e] @ w1[e] + b1[e]) @ w2[e] + b2[e])
//     int8:    h = act((x[e] @ q1[e]) * s1[e] + b1[e])
//              out[e] = cast(sum over F blocks of (h_blk @ q2_blk) * s2[e]
//                        + b2[e])
//
// Layouts (all contiguous, row-major):
//   x   [E, C, H]  float32 or bfloat16       out [E, C, H]  x's dtype
//   w1  [E, H, F]  x's dtype, or int8        s1  [E, F]     float32 (int8)
//   w2  [E, F, H]  x's dtype, or int8        s2  [E, H]     float32 (int8)
//   b1  [E, F]     float32                   b2  [E, H]     float32
// (the wrapper casts the biases to float32; E, C, H, F any size >= 1.)
//
// As in the TPU kernel, x and the weights are widened to f32 for the
// products, the hidden h = act(...) is f32 and never leaves the block, and
// the f32 sum is cast once.
//
// Bound.  4 * E * C * H * F flops: at MoE training sizes (C in the
// thousands) that is the bf16 tensor-core rate; at a decode-sized C the
// expert weights, read once, over the memory rate.
//
// Design (simple first; wgmma, TMA and warp specialisation come later).
// The TPU kernel kept a [bc, H] f32 row block in VMEM across the F
// blocks; at bc = 64, H = 2048 that is 512 KB, and an SM has 227 KB of
// shared memory.  Here a block owns kRows = 16 rows of one expert and up
// to kCols = 2048 output columns, and keeps their f32 sum in registers
// (8 warps x 32 lanes x 128 floats).  It walks the F blocks (kFB = 64
// wide).  For each:
//   1. h[16, 64] = x[16, H] @ w1[:, fblk], H in chunks of kKC = 128: each
//      warp one n8 column tile, mma.sync m16n8k16 bf16 x bf16 -> f32
//      (exact products); then s1 (int8), b1 and the activation in f32.
//      h is split into two bf16 terms, hi = bf16(h) and lo = bf16(h - hi),
//      written to shared memory.
//   2. acc[16, 2048] += (h_hi + h_lo) @ w2[fblk, :] in column chunks of
//      kNC = 256, each warp 4 n8 tiles per chunk; each F block's
//      contribution is summed apart and then added (times s2 for int8),
//      as _kernel / _qkernel add `contrib` per grid step.  Two bf16 terms
//      carry h to about 16 bits, so h is never rounded to bf16 once.
// The x, w1 and w2 chunks stream through a kStages-deep ring of shared
// memory buffers with cp.async (16-byte copies, zero-filled past the
// edges), so 3 chunks are in flight while one is multiplied.  int8 chunks
// land raw and are widened to bf16 (exact) in shared memory before the
// ldmatrix loads.  Blocks are ordered by expert, so the blocks of one
// expert run together and re-read its panels from L2.  H above 2048 takes
// more column slices, each recomputing h.  When the blocks are too few to
// fill the card (decode-sized C) the wrapper splits the F blocks over
// `nsplit` blocks, each writing an f32 partial sum, and gffn_reduce_kernel
// adds b2 and the partials in split order (deterministic, no atomics).
// f32 x takes gffn_fma_kernel: the same decomposition on the fp32 cores,
// no tensor cores (they would round x to TF32, which the TPU kernel does
// not).  Shapes whose rows are not 16-byte aligned take element loads.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): 19.0 ms at
// E = 8, C = 2560, H = 2048, F = 5504, 5% of the flop bound, and the same
// with 3 to 10 ring stages, so latency is not the limit.  A 16-row block
// moves each weight byte through cp.async, shared memory and ldmatrix for
// only 16 rows of products (58 GB over that call): the SMs' load path
// bounds it.  More rows per weight byte is the fix: 64-row wgmma tiles,
// and TMA multicast of the panels across a cluster of blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 16;     // rows of x per block: one m16 tile
constexpr int kFB = 64;       // F block
constexpr int kCols = 2048;   // output columns per block
constexpr int kKC = 128;      // depth of a first-product chunk
constexpr int kNC = 256;      // columns of a second-product chunk
constexpr int kNChunks = kCols / kNC;
constexpr int kStages = 4;  // 3 to 10 stages measured the same on an H100

constexpr int kXStride = kKC + 8;   // bf16 per shared row (+16 B: no
constexpr int kW1Stride = kFB + 8;  // ldmatrix bank conflicts)
constexpr int kW2Stride = kNC + 8;
constexpr int kHStride = kFB + 8;
constexpr int kXBytes = kRows * kXStride * 2;
constexpr int kW1Bytes = kKC * kW1Stride * 2;
constexpr int kW2Bytes = kFB * kW2Stride * 2;
constexpr int kHBytes = kRows * kHStride * 2;
static_assert(kXBytes + kW1Bytes <= kW2Bytes, "a stage holds a k chunk");
static_assert(kXBytes % 16 == 0 && kW2Bytes % 16 == 0, "alignment");

// The ring: bf16 chunks as ldmatrix reads them, or int8 chunks raw
// (x stays bf16) and widened into one bf16 buffer of kW2Bytes.
template <typename TW>
struct Ring {
  static constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  static constexpr int kStageBytes = kInt8 ? kFB * kNC : kW2Bytes;
  static constexpr int kSmem = kStages * kStageBytes +
                               (kInt8 ? kW2Bytes : 0) + 2 * kHBytes;
  static_assert(kXBytes + kKC * kFB <= kFB * kNC, "an int8 k chunk fits");
};

struct FfnArgs {
  const void* x;
  const void* w1;
  const float* s1;
  const float* b1;
  const void* w2;
  const float* s2;
  const float* b2;
  void* out;
  float* partial;
  int E, C, H, F, act, nsplit;
};

__device__ __forceinline__ float activation(float v, int code) {
  switch (code) {
    case 0:  // gelu, exact form, as jax.nn.gelu(approximate=False)
      return 0.5f * v * erfcf(-v * 0.70710678118654752440f);
    case 1:
      return fmaxf(v, 0.f);
    case 2:  // silu
      return v / (1.f + expf(-v));
    case 3:
      return 1.f / (1.f + expf(-v));
    default:
      return tanhf(v);
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory (.trans: each transposed).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// -- chunk loads ---------------------------------------------------------------

// A first-product chunk: x rows r0..r0+15, columns k0..k0+kKC-1 (bf16,
// [kRows][kXStride]) and w1 rows k0.., columns f0..f0+kFB-1 (bf16
// [kKC][kW1Stride], or int8 raw [kKC][kFB]) into stage `st`.
template <typename TW, bool kVec>
__device__ __forceinline__ void load_k_chunk(unsigned char* st, const bf16* x,
                                             const TW* w1, int C, int H,
                                             int F, int r0, int f0, int k0) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  bf16* sx = reinterpret_cast<bf16*>(st);
  if (kVec) {
    const int row = threadIdx.x / (kKC / 8), pc = threadIdx.x % (kKC / 8);
    const int k = k0 + pc * 8;
    const bool ok = r0 + row < C && k < H;
    cp_async16(sx + row * kXStride + pc * 8,
               ok ? x + (size_t)(r0 + row) * H + k : x, ok);
  } else {
    for (int i = threadIdx.x; i < kRows * kKC; i += kThreads) {
      const int row = i / kKC, c = i % kKC, k = k0 + c;
      sx[row * kXStride + c] = (r0 + row < C && k < H)
                                   ? x[(size_t)(r0 + row) * H + k]
                                   : __float2bfloat16(0.f);
    }
  }
  if (kInt8) {
    int8_t* sw = reinterpret_cast<int8_t*>(st + kXBytes);
    if (kVec) {
      for (int i = threadIdx.x; i < kKC * kFB / 16; i += kThreads) {
        const int rr = i / (kFB / 16), pc = i % (kFB / 16);
        const int k = k0 + rr, f = f0 + pc * 16;
        const bool ok = k < H && f < F;
        cp_async16(sw + rr * kFB + pc * 16,
                   ok ? reinterpret_cast<const int8_t*>(w1) + (size_t)k * F + f
                      : reinterpret_cast<const int8_t*>(w1),
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < kKC * kFB; i += kThreads) {
        const int rr = i / kFB, c = i % kFB, k = k0 + rr, f = f0 + c;
        sw[i] = (k < H && f < F)
                    ? reinterpret_cast<const int8_t*>(w1)[(size_t)k * F + f]
                    : (int8_t)0;
      }
    }
  } else {
    bf16* sw = reinterpret_cast<bf16*>(st + kXBytes);
    const bf16* w = reinterpret_cast<const bf16*>(w1);
    if (kVec) {
      for (int i = threadIdx.x; i < kKC * kFB / 8; i += kThreads) {
        const int rr = i / (kFB / 8), pc = i % (kFB / 8);
        const int k = k0 + rr, f = f0 + pc * 8;
        const bool ok = k < H && f < F;
        cp_async16(sw + rr * kW1Stride + pc * 8,
                   ok ? w + (size_t)k * F + f : w, ok);
      }
    } else {
      for (int i = threadIdx.x; i < kKC * kFB; i += kThreads) {
        const int rr = i / kFB, c = i % kFB, k = k0 + rr, f = f0 + c;
        sw[rr * kW1Stride + c] =
            (k < H && f < F) ? w[(size_t)k * F + f] : __float2bfloat16(0.f);
      }
    }
  }
}

// A second-product chunk: w2 rows f0..f0+kFB-1, columns n0..n0+kNC-1 (bf16
// [kFB][kW2Stride], or int8 raw [kFB][kNC]) into stage `st`.
template <typename TW, bool kVec>
__device__ __forceinline__ void load_n_chunk(unsigned char* st, const TW* w2,
                                             int H, int F, int f0, int n0) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  if (kInt8) {
    int8_t* sw = reinterpret_cast<int8_t*>(st);
    const int8_t* w = reinterpret_cast<const int8_t*>(w2);
    if (kVec) {
      for (int i = threadIdx.x; i < kFB * kNC / 16; i += kThreads) {
        const int rr = i / (kNC / 16), pc = i % (kNC / 16);
        const int f = f0 + rr, n = n0 + pc * 16;
        const bool ok = f < F && n < H;
        cp_async16(sw + rr * kNC + pc * 16, ok ? w + (size_t)f * H + n : w,
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < kFB * kNC; i += kThreads) {
        const int rr = i / kNC, c = i % kNC, f = f0 + rr, n = n0 + c;
        sw[i] = (f < F && n < H) ? w[(size_t)f * H + n] : (int8_t)0;
      }
    }
  } else {
    bf16* sw = reinterpret_cast<bf16*>(st);
    const bf16* w = reinterpret_cast<const bf16*>(w2);
    if (kVec) {
      for (int i = threadIdx.x; i < kFB * kNC / 8; i += kThreads) {
        const int rr = i / (kNC / 8), pc = i % (kNC / 8);
        const int f = f0 + rr, n = n0 + pc * 8;
        const bool ok = f < F && n < H;
        cp_async16(sw + rr * kW2Stride + pc * 8,
                   ok ? w + (size_t)f * H + n : w, ok);
      }
    } else {
      for (int i = threadIdx.x; i < kFB * kNC; i += kThreads) {
        const int rr = i / kNC, c = i % kNC, f = f0 + rr, n = n0 + c;
        sw[rr * kW2Stride + c] =
            (f < F && n < H) ? w[(size_t)f * H + n] : __float2bfloat16(0.f);
      }
    }
  }
}

// int8 raw [rows][cols] -> bf16 [rows][stride] (exact: |q| <= 127).
__device__ __forceinline__ void widen(const unsigned char* raw, bf16* dst,
                                      int rows, int cols, int stride) {
  for (int i = threadIdx.x; i < rows * cols / 16; i += kThreads) {
    const int rr = i / (cols / 16), pc = i % (cols / 16);
    const int4 v = *reinterpret_cast<const int4*>(raw + rr * cols + pc * 16);
    const int words[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = words[e];
      h[2 * e] = pack_bf16x2((float)(int8_t)(w & 0xff),
                             (float)(int8_t)((w >> 8) & 0xff));
      h[2 * e + 1] = pack_bf16x2((float)(int8_t)((w >> 16) & 0xff),
                                 (float)(int8_t)((w >> 24) & 0xff));
    }
    uint4* d = reinterpret_cast<uint4*>(dst + rr * stride + pc * 16);
    d[0] = make_uint4(h[0], h[1], h[2], h[3]);
    d[1] = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// -- bf16 x: mma.sync ---------------------------------------------------------------

template <typename TW, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) gffn_mma_kernel(const FfnArgs a) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stages = smem;
  constexpr int kStageBytes = Ring<TW>::kStageBytes;
  bf16* wide = reinterpret_cast<bf16*>(smem + kStages * kStageBytes);
  bf16* h_hi = reinterpret_cast<bf16*>(smem + kStages * kStageBytes +
                                       (kInt8 ? kW2Bytes : 0));
  bf16* h_lo = h_hi + kRows * kHStride;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // mma group id
  const int t = lane % 4;  // thread in group
  const int H = a.H, F = a.F, C = a.C;
  const int nslices = (H + kCols - 1) / kCols;
  const int e = blockIdx.y / nslices;
  const int c0 = (blockIdx.y % nslices) * kCols;
  const int r0 = blockIdx.x * kRows;
  const int nfb = (F + kFB - 1) / kFB;
  const int fb0 = (int)((long long)blockIdx.z * nfb / a.nsplit);
  const int fb1 = (int)((long long)(blockIdx.z + 1) * nfb / a.nsplit);
  const int nk = (H + kKC - 1) / kKC;
  const int nn = (min(kCols, H - c0) + kNC - 1) / kNC;
  const int per_fb = nk + nn;
  const int total = (fb1 - fb0) * per_fb;

  const bf16* x = static_cast<const bf16*>(a.x) + (size_t)e * C * H;
  const TW* w1 = static_cast<const TW*>(a.w1) + (size_t)e * H * F;
  const TW* w2 = static_cast<const TW*>(a.w2) + (size_t)e * F * H;
  const float* b1 = a.b1 + (size_t)e * F;
  const float* b2 = a.b2 + (size_t)e * H;
  const float* s1 = kInt8 ? a.s1 + (size_t)e * F : nullptr;
  const float* s2 = kInt8 ? a.s2 + (size_t)e * H : nullptr;

  // chunk `id` of this block's sequence: per F block, nk first-product
  // chunks, then nn second-product chunks
  auto issue = [&](int id) {
    unsigned char* st = stages + (id % kStages) * kStageBytes;
    const int fb = fb0 + id / per_fb;
    const int r = id % per_fb;
    if (r < nk)
      load_k_chunk<TW, kVec>(st, x, w1, C, H, F, r0, fb * kFB, r * kKC);
    else
      load_n_chunk<TW, kVec>(st, w2, H, F, fb * kFB, c0 + (r - nk) * kNC);
  };
  int next = 0, cur = 0;
  // The next chunk in stage order: its copies have landed for every
  // thread, and every thread is done with the previous chunk, whose stage
  // now takes chunk cur + kStages - 1.
  auto step = [&]() -> const unsigned char* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (next < total) issue(next);
    ++next;
    cp_async_commit();
    return stages + (cur++ % kStages) * kStageBytes;
  };

  float acc[kNChunks][4][4];
#pragma unroll
  for (int n = 0; n < kNChunks; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c0 + n * kNC + warp * 32 + i * 8 + 2 * t;
      const float v0 = (a.nsplit == 1 && col < H) ? b2[col] : 0.f;
      const float v1 = (a.nsplit == 1 && col + 1 < H) ? b2[col + 1] : 0.f;
      acc[n][i][0] = v0;
      acc[n][i][1] = v1;
      acc[n][i][2] = v0;
      acc[n][i][3] = v1;
    }

  for (int s = 0; s < kStages - 1; ++s) {
    if (next < total) issue(next);
    ++next;
    cp_async_commit();
  }

  for (int fb = fb0; fb < fb1; ++fb) {
    // 1. h tile of this warp: rows 0..15, F-block columns warp*8..+7
    float hacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kc = 0; kc < nk; ++kc) {
      const unsigned char* st = step();
      const bf16* sx = reinterpret_cast<const bf16*>(st);
      const bf16* sw = reinterpret_cast<const bf16*>(st + kXBytes);
      if (kInt8) {
        widen(st + kXBytes, wide, kKC, kFB, kW1Stride);
        __syncthreads();
        sw = wide;
      }
#pragma unroll
      for (int kp = 0; kp < kKC / 32; ++kp) {
        uint32_t b[4];  // two k16 steps of the n8 tile
        ldsm_x4<true>(b, sw + (kp * 32 + lane) * kW1Stride + warp * 8);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t af[4];
          ldsm_x4<false>(af, sx + (lane % 16) * kXStride + kp * 32 + s * 16 +
                                 (lane / 16) * 8);
          mma_bf16(hacc[s], af, b + 2 * s);
        }
      }
    }
    {  // s1, b1, activation; split into bf16 hi + lo
      const int fl = warp * 8 + 2 * t;
      const int f = fb * kFB + fl;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float hv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p = hacc[0][2 * half + j] + hacc[1][2 * half + j];
          if (f + j < F) {
            if (kInt8) p *= s1[f + j];
            p = activation(p + b1[f + j], a.act);
          } else {
            p = 0.f;
          }
          hv[j] = p;
        }
        const float hi0 = __bfloat162float(__float2bfloat16(hv[0]));
        const float hi1 = __bfloat162float(__float2bfloat16(hv[1]));
        const int off = (g + 8 * half) * kHStride + fl;
        *reinterpret_cast<uint32_t*>(h_hi + off) = pack_bf16x2(hi0, hi1);
        *reinterpret_cast<uint32_t*>(h_lo + off) =
            pack_bf16x2(hv[0] - hi0, hv[1] - hi1);
      }
    }
    // 2. acc += h @ w2[fblk, slice]
    uint32_t ahi[kFB / 16][4], alo[kFB / 16][4];
#pragma unroll
    for (int n = 0; n < kNChunks; ++n) {
      if (n >= nn) break;
      const unsigned char* st = step();
      if (n == 0) {
#pragma unroll
        for (int ks = 0; ks < kFB / 16; ++ks) {
          const int off = (lane % 16) * kHStride + ks * 16 + (lane / 16) * 8;
          ldsm_x4<false>(ahi[ks], h_hi + off);
          ldsm_x4<false>(alo[ks], h_lo + off);
        }
      }
      const bf16* sw = reinterpret_cast<const bf16*>(st);
      if (kInt8) {
        widen(st, wide, kFB, kNC, kW2Stride);
        __syncthreads();
        sw = wide;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nl = warp * 32 + i * 8;
        const int col = c0 + n * kNC + nl;
        if (col >= H) continue;  // the same for the whole warp
        float tmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kp = 0; kp < kFB / 32; ++kp) {
          uint32_t b[4];
          ldsm_x4<true>(b, sw + (kp * 32 + lane) * kW2Stride + nl);
          mma_bf16(tmp, ahi[2 * kp], b);
          mma_bf16(tmp, alo[2 * kp], b);
          mma_bf16(tmp, ahi[2 * kp + 1], b + 2);
          mma_bf16(tmp, alo[2 * kp + 1], b + 2);
        }
        float sc0 = 1.f, sc1 = 1.f;
        if (kInt8) {
          sc0 = col + 2 * t < H ? s2[col + 2 * t] : 0.f;
          sc1 = col + 2 * t + 1 < H ? s2[col + 2 * t + 1] : 0.f;
        }
        acc[n][i][0] += tmp[0] * sc0;
        acc[n][i][1] += tmp[1] * sc1;
        acc[n][i][2] += tmp[2] * sc0;
        acc[n][i][3] += tmp[3] * sc1;
      }
    }
  }
  cp_async_wait<0>();

  const size_t ld = (size_t)H;
  bf16* out = static_cast<bf16*>(a.out) + (size_t)e * C * H;
  float* part = a.partial + ((size_t)blockIdx.z * a.E + e) * C * H;
#pragma unroll
  for (int n = 0; n < kNChunks; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + g + 8 * (r / 2);
        const int col = c0 + n * kNC + warp * 32 + i * 8 + 2 * t + (r % 2);
        if (row >= C || col >= H) continue;
        if (a.nsplit == 1)
          out[row * ld + col] = __float2bfloat16(acc[n][i][r]);
        else
          part[row * ld + col] = acc[n][i][r];
      }
}

// -- f32 x: FMA tiles ---------------------------------------------------------------

constexpr int kFmaKC = 32;                   // depth of a first-product chunk
constexpr int kFmaNC = 128;                  // columns of a second-product chunk
constexpr int kFmaNChunks = kCols / kFmaNC;  // 16

// Thread layout: the first product gives row tid / 16 and F-block columns
// tid % 16 + 16 q (q < 4); the second rows 4 (tid / 64) + i (i < 4) and
// chunk columns tid % 64 + 64 j (j < 2).
template <typename TW>
__global__ void __launch_bounds__(kThreads, 1) gffn_fma_kernel(const FfnArgs a) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  __shared__ float sx[kRows][kFmaKC];
  __shared__ float sw1[kFmaKC][kFB];
  __shared__ float sh[kRows][kFB + 1];
  __shared__ float sw2[kFB][kFmaNC];

  const int tid = threadIdx.x;
  const int H = a.H, F = a.F, C = a.C;
  const int nslices = (H + kCols - 1) / kCols;
  const int e = blockIdx.y / nslices;
  const int c0 = (blockIdx.y % nslices) * kCols;
  const int r0 = blockIdx.x * kRows;
  const int nfb = (F + kFB - 1) / kFB;
  const int fb0 = (int)((long long)blockIdx.z * nfb / a.nsplit);
  const int fb1 = (int)((long long)(blockIdx.z + 1) * nfb / a.nsplit);
  const int nn = (min(kCols, H - c0) + kFmaNC - 1) / kFmaNC;

  const float* x = static_cast<const float*>(a.x) + (size_t)e * C * H;
  const TW* w1 = static_cast<const TW*>(a.w1) + (size_t)e * H * F;
  const TW* w2 = static_cast<const TW*>(a.w2) + (size_t)e * F * H;
  const float* b1 = a.b1 + (size_t)e * F;
  const float* b2 = a.b2 + (size_t)e * H;
  const float* s1 = kInt8 ? a.s1 + (size_t)e * F : nullptr;
  const float* s2 = kInt8 ? a.s2 + (size_t)e * H : nullptr;

  const int hr = tid / 16, hc = tid % 16;
  const int rg = tid / 64, cg = tid % 64;

  float acc[kFmaNChunks][2][4];
#pragma unroll
  for (int n = 0; n < kFmaNChunks; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = c0 + n * kFmaNC + cg + 64 * j;
      const float v = (a.nsplit == 1 && col < H) ? b2[col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][j][i] = v;
    }

  for (int fb = fb0; fb < fb1; ++fb) {
    const int f0 = fb * kFB;
    float hacc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < H; k0 += kFmaKC) {
      __syncthreads();  // every thread is done with the last chunk
      for (int i = tid; i < kRows * kFmaKC; i += kThreads) {
        const int row = i / kFmaKC, k = k0 + i % kFmaKC;
        sx[row][i % kFmaKC] =
            (r0 + row < C && k < H) ? x[(size_t)(r0 + row) * H + k] : 0.f;
      }
      for (int i = tid; i < kFmaKC * kFB; i += kThreads) {
        const int rr = i / kFB, c = i % kFB, k = k0 + rr, f = f0 + c;
        sw1[rr][c] = (k < H && f < F) ? to_float(w1[(size_t)k * F + f]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kFmaKC; ++kk) {
        const float xv = sx[hr][kk];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hacc[q] = fmaf(xv, sw1[kk][hc + 16 * q], hacc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = f0 + hc + 16 * q;
      float p = 0.f;
      if (f < F) {
        p = hacc[q];
        if (kInt8) p *= s1[f];
        p = activation(p + b1[f], a.act);
      }
      sh[hr][hc + 16 * q] = p;
    }
#pragma unroll
    for (int n = 0; n < kFmaNChunks; ++n) {
      if (n >= nn) break;
      const int n0 = c0 + n * kFmaNC;
      __syncthreads();  // h written; every thread done with the last chunk
      for (int i = tid; i < kFB * kFmaNC; i += kThreads) {
        const int rr = i / kFmaNC, c = i % kFmaNC, f = f0 + rr, col = n0 + c;
        sw2[rr][c] =
            (f < F && col < H) ? to_float(w2[(size_t)f * H + col]) : 0.f;
      }
      __syncthreads();
      float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
      for (int kk = 0; kk < kFB; ++kk) {
        float hv[4], wv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = sh[4 * rg + i][kk];
#pragma unroll
        for (int j = 0; j < 2; ++j) wv[j] = sw2[kk][cg + 64 * j];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) tmp[j][i] = fmaf(hv[i], wv[j], tmp[j][i]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + cg + 64 * j;
        const float sc = kInt8 ? (col < H ? s2[col] : 0.f) : 1.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][j][i] += tmp[j][i] * sc;
      }
    }
  }

  const size_t ld = (size_t)H;
  float* out = static_cast<float*>(a.out) + (size_t)e * C * H;
  float* part = a.partial + ((size_t)blockIdx.z * a.E + e) * C * H;
#pragma unroll
  for (int n = 0; n < kFmaNChunks; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 4 * rg + i;
        const int col = c0 + n * kFmaNC + cg + 64 * j;
        if (row >= C || col >= H) continue;
        if (a.nsplit == 1)
          out[row * ld + col] = acc[n][j][i];
        else
          part[row * ld + col] = acc[n][j][i];
      }
}

// out = cast(b2 + partial[0] + partial[1] + ...), splits in order.
template <typename T>
__global__ void gffn_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ b2,
                                   T* __restrict__ out, int E, int C, int H,
                                   int nsplit) {
  const size_t n = (size_t)E * C * H;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t e = i / ((size_t)C * H);
  float s = b2[e * H + i % H];
  for (int z = 0; z < nsplit; ++z) s += partial[(size_t)z * n + i];
  out[i] = from_float<T>(s);
}

template <typename TW, bool kVec>
cudaError_t launch_mma(const FfnArgs& a, dim3 grid, cudaStream_t stream) {
  const int smem = Ring<TW>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      gffn_mma_kernel<TW, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  gffn_mma_kernel<TW, kVec><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches on `stream`, whose device must be the calling thread's current
// one (the Python wrapper selects it).  Returns 0 on success, else the
// CUDA error code of the refused launch (cudaErrorInvalidValue for
// arguments this kernel does not take).  x_dtype: 0 = float32,
// 1 = bfloat16; w_int8: 0 = w1/w2 in x's dtype, 1 = int8 with s1/s2;
// act: 0 gelu, 1 relu, 2 silu, 3 sigmoid, 4 tanh.  nsplit in
// [1, ceil(F / 64)]; above 1, `partial` holds nsplit * E * C * H floats.
extern "C" int grouped_ffn_launch(const void* x, const void* w1,
                                  const void* s1, const void* b1,
                                  const void* w2, const void* s2,
                                  const void* b2, void* out, void* partial,
                                  int E, int C, int H, int F, int x_dtype,
                                  int w_int8, int act, int nsplit,
                                  void* stream) {
  if (E < 1 || C < 1 || H < 1 || F < 1 || act < 0 || act > 4)
    return cudaErrorInvalidValue;
  const int nfb = (F + kFB - 1) / kFB;
  if (nsplit < 1 || nsplit > nfb || (nsplit > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  if (w_int8 && (s1 == nullptr || s2 == nullptr)) return cudaErrorInvalidValue;
  const int nslices = (H + kCols - 1) / kCols;
  if ((long long)E * nslices > 65535 || nsplit > 65535)
    return cudaErrorInvalidValue;
  const FfnArgs a{x,
                  w1,
                  static_cast<const float*>(s1),
                  static_cast<const float*>(b1),
                  w2,
                  static_cast<const float*>(s2),
                  static_cast<const float*>(b2),
                  out,
                  static_cast<float*>(partial),
                  E, C, H, F, act, nsplit};
  const dim3 grid((C + kRows - 1) / kRows, E * nslices, nsplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_dtype == 1) {
    const int wv = w_int8 ? 16 : 8;  // elements per 16-byte weight piece
    const bool vec = H % 8 == 0 && F % wv == 0 && H % wv == 0 &&
                     aligned16(x) && aligned16(w1) && aligned16(w2);
    if (w_int8)
      e = vec ? launch_mma<int8_t, true>(a, grid, st)
              : launch_mma<int8_t, false>(a, grid, st);
    else
      e = vec ? launch_mma<bf16, true>(a, grid, st)
              : launch_mma<bf16, false>(a, grid, st);
  } else if (x_dtype == 0) {
    if (w_int8)
      gffn_fma_kernel<int8_t><<<grid, kThreads, 0, st>>>(a);
    else
      gffn_fma_kernel<float><<<grid, kThreads, 0, st>>>(a);
    e = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || nsplit == 1) return e;
  const size_t n = (size_t)E * C * H;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (x_dtype == 1)
    gffn_reduce_kernel<bf16><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<const float*>(b2),
        static_cast<bf16*>(out), E, C, H, nsplit);
  else
    gffn_reduce_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<const float*>(b2),
        static_cast<float*>(out), E, C, H, nsplit);
  return cudaGetLastError();
}
