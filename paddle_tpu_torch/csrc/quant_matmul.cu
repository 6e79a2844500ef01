// Int8-weight matmul (W8A16) for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_kernels/
// quant_matmul.py (_kernel / _pallas_qmm), the serving-side weight GEMM
// under PT_QUANT=int8, seven calls per layer per forward:
//
//     out[M, N] = cast_to_x_dtype((float(x) @ float(qweight)) * scale)
//
// Layouts (all contiguous, row-major):
//   x        [M, K]  float32 or bfloat16
//   qweight  [K, N]  int8, the repo's [in, out] layout, read as it lies
//                    (never repacked, never widened into device memory)
//   scale    [N]     float32, one per output channel
//   out      [M, N]  x's dtype
//
// Every product of a bf16 (or f32) x and an int8 weight is exact in f32,
// as in the TPU kernel's f32 dot; only the order of summation differs.
// The scale multiplies the f32 sum once, and out is cast once.
//
// Bound.  Decode (M = batch, 1-8) moves K * N weight bytes for 2 * M
// flops each, far below the card's ~295 flop/byte ridge: the weight
// stream sets the pace (13.5 us for gate/up at 3.35 TB/s).  Prefill (M =
// a chunk, up to 512) is above it: 2 * M * K * N flops at the bf16
// tensor-core rate (46.7 us for gate/up at M = 512).
//
// The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid with a
// [128, 256] f32 VMEM accumulator and widens a [512, 256] int8 panel to
// f32 for the MXU.  On Hopper the decode has to spread one weight stream
// over 132 SMs with enough bytes in flight and no per-byte conversion,
// and the prefill has to feed the tensor cores from a TMA ring with the
// widening off their critical path.  Both bf16 routes share one weight
// tile: TMA brings [64 k][128 channels] of int8 (8 KB, 128-byte swizzle)
// into a ring of shared-memory stages (mbarriers expecting the bytes;
// one producer thread, the consumers free a stage by arriving on its
// `empty` barrier), and rows past K, channels past N and x rows past M
// arrive as zeros, so no edge is masked in the main loops.
//
// The widening.  The int-to-float conversion runs at a quarter of the
// FMA rate (16 per clock per SM), as slow as the weight stream itself at
// decode.  Instead: ldmatrix.trans over the int8 tile, read as 8 x 8
// matrices of 16-bit pairs, hands each thread the 32-bit word
// [w(2t, 2g), w(2t, 2g + 1), w(2t + 1, 2g), w(2t + 1, 2g + 1)] (k row,
// channel; g = lane / 4, t = lane % 4), which is the 4 x 4 byte
// transpose an mma A fragment needs: bytes 0 and 2 are channel 2g at k
// 2t and 2t + 1, bytes 1 and 3 channel 2g + 1.  widen_pair turns bytes 0
// and 2 (and, shifted by 8, bytes 1 and 3) into a bf16x2 with two LOP3s
// and one HSUB2: 128 + (b & 127) is exact in bf16 (7 mantissa bits), and
// subtracting 128, or 256 when b's sign bit is set, leaves b exactly.  So
// A-fragment row g of a 16-channel chunk is channel 2g and row g + 8
// channel 2g + 1: the channels are permuted inside each chunk, and the
// epilogues undo it.
//
// 1. bf16 x, M <= 32 (qmm_dec_kernel<MT>, MT = ceil(M / 8) n8 tiles; it
//    takes M <= 64, and qmm_variants.py measures where the wgmma GEMM
//    overtakes it): the tensor-core GEMV.  out^T[N, M] = w^T[N, K] .
//    x^T[K, M] on mma.sync m16n8k16 bf16 -> f32: A is 16 channels x 16 k
//    of the widened weight, B is x^T with its 8 MT rows in n (rows past
//    M arrive as zeros).  A block owns a strip of 256 channels (two
//    weight tiles side by side, so each weight row is read 256 bytes at
//    a time) and a K slice (split z of ksplit, a run of whole 64-row
//    tiles, the first nk % ksplit splits one tile longer): a producer
//    warp streams the slice through a ring of about 64 KB (3 stages of
//    16 KB weight + 1 KB x at MT = 1), and 4 consumer warps each own 32
//    channels of each tile over every k of a stage: per 16 k and 16
//    channels one ldmatrix.trans, 4 widen_pairs and MT mmas.  No FMA per
//    weight byte and no conversion.  The wrapper picks ksplit for about
//    two blocks per SM (three fit), so 132 SMs hold 100-150 KB of weight
//    in flight at N = 4096 (16 splits) as at N = 11008 (6).  With one
//    split the block scales and writes out; otherwise it writes an f32
//    partial [ksplit, M, N] and qmm_reduce_kernel, launched as a
//    programmatic dependent (its blocks are scheduled while the splits
//    run and wait on griddepcontrol.wait), sums the splits in split
//    order, scales and casts: the same bits from run to run, no atomics.
// 2. bf16 x, M > 32 (qmm_wg_kernel): a warp-specialised wgmma GEMM that
//    widens in registers.  out^T = w^T . x^T with the widened weight as
//    wgmma's A operand from registers (its per-warp layout is the mma
//    A fragment above) and x^T as B from shared memory: x [M, K] is
//    K-major for B, so TMA brings [128 rows][64 k] bf16 tiles (16 KB,
//    128-byte swizzle) beside the weight tile, 8 stages of 24 KB.  A
//    block owns 128 channels x 128 rows of x (344 tiles at gate/up and
//    M = 512, 128 at N = 4096); 384 threads: a producer warpgroup
//    (setmaxnreg 24) and two consumer warpgroups (240), each 64 channels
//    x 128 rows in an m64n128 f32 sum (64 registers).  Per stage a
//    consumer warp runs 2 ldmatrix.trans and 16 widen_pairs for its 4
//    k16 A fragments, then 4 wgmma m64n128k16 as one commit group; the
//    widening of stage i overlaps the products of stage i - 1, which
//    are then waited for (wait_group 1) and their stage freed.  The
//    fragments of two consecutive stages are two distinct register
//    arrays: wgmma reads its A registers asynchronously, and one array
//    rewritten every stage corrupted the group still in flight.  A
//    widened weight feeds 128 rows of x; no bf16 copy of a tile is
//    written.  Blocks are ordered row tile first, so the row tiles of one
//    weight panel run together and the panel is read from device memory
//    once.  Epilogue from the registers: x scale, one cast, bf16x2
//    stores of channel pairs.  Per stage the SM's shared memory moves
//    the TMA writes (24 KB), wgmma's reads of x (16 KB a warpgroup) and
//    the ldmatrix reads (8 KB): 64 KB, 512 clocks at 128 B a clock, as
//    long as the stage's 2.1 MFLOP take at the tensor-core peak.
// 3. Shapes TMA cannot describe (N % 16 != 0, K % 8 != 0, or x / qweight
//    not 16-byte aligned) take the SIMT kernels, bf16 and f32 alike:
//    qmm_gemv_kernel for M <= 8 and qmm_mma_kernel (mma.sync tiles fed
//    from registers) for M > 8; they bounds-check every edge.
// 4. f32 x (qmm_gemv_kernel<float>, qmm_fma_kernel) stays on the fp32
//    cores: tensor cores would round f32 x to TF32, which the TPU kernel
//    does not.  qmm_gemv_kernel: a block owns 128 columns and a 512-row
//    slice of K, fp32 FMAs, partials summed by qmm_reduce_kernel in slice
//    order.  qmm_fma_kernel: 64 x 64 tiles, 4 x 4 outputs a thread.
//
// The wrapper (ops/kernels/quant_matmul.py) takes the route from the
// shapes, dtype and alignment alone; a refused launch raises there.
// Times and what bounds each route: PERF.md and
// paddle_tpu_torch/testing/qmm_variants.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// -- f32 x, and bf16 x off the TMA rule, M <= 8: split-K GEMV ---------------

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = 128;   // 32 lanes x 4 columns
constexpr int kGemvRows = 512;   // rows of K per block
constexpr int kSmallM = 8;

// x's slice, transposed to [kGemvRows][MM] floats so a row's MM values
// are one or two 16-byte shared loads; rows past K and x rows past M are 0.
template <typename TX, int MM>
__device__ __forceinline__ void stage_x(const TX* __restrict__ x, float* s_x,
                                        int M, int K, int k0, int kn) {
  constexpr int kVecX = 16 / sizeof(TX);  // x elements per 16-byte load
  if (K % kVecX == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    for (int c = threadIdx.x; c < MM * (kGemvRows / kVecX);
         c += kGemvThreads) {
      const int m = c / (kGemvRows / kVecX);
      const int k = (c % (kGemvRows / kVecX)) * kVecX;
      alignas(16) TX v[kVecX];
      if (m < M && k < kn) {  // kn % kVecX == 0 here
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + k);
      } else {
#pragma unroll
        for (int e = 0; e < kVecX; ++e) v[e] = from_float<TX>(0.f);
      }
#pragma unroll
      for (int e = 0; e < kVecX; ++e) s_x[(k + e) * MM + m] = to_float(v[e]);
    }
  } else {
    for (int i = threadIdx.x; i < MM * kGemvRows; i += kGemvThreads) {
      const int m = i / kGemvRows;
      const int k = i % kGemvRows;
      s_x[k * MM + m] =
          (m < M && k < kn) ? to_float(x[(size_t)m * K + k0 + k]) : 0.f;
    }
  }
}

// The warp's share of the K slice: rows k = warp, warp + 8, ... of w,
// 4 columns a lane.  kFull: all 4 columns exist and rows are 4-byte
// aligned, so each row is one 4-byte load.
template <int MM, bool kFull>
__device__ __forceinline__ void gemv_rows(const int8_t* __restrict__ w,
                                          const float* s_x, float (&acc)[MM][4],
                                          int N, int k0, int kn, int col0,
                                          int warp) {
#pragma unroll 8
  for (int k = warp; k < kn; k += kGemvWarps) {
    const int8_t* row = w + (size_t)(k0 + k) * N + col0;
    float wv[4];
    if (kFull) {
      const char4 c = *reinterpret_cast<const char4*>(row);
      wv[0] = c.x;
      wv[1] = c.y;
      wv[2] = c.z;
      wv[3] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = col0 + j < N ? (float)row[j] : 0.f;
    }
    float xv[MM];
#pragma unroll
    for (int m = 0; m < MM; m += 4) {
      if (MM % 4 == 0) {
        const float4 f = *reinterpret_cast<const float4*>(s_x + k * MM + m);
        xv[m] = f.x;
        xv[m + 1] = f.y;
        xv[m + 2] = f.z;
        xv[m + 3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < MM; ++e) xv[e] = s_x[k * MM + e];
      }
    }
#pragma unroll
    for (int m = 0; m < MM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv[m], wv[j], acc[m][j]);
  }
}

template <typename TX, int MM, bool kVec>
__global__ void __launch_bounds__(kGemvThreads)
qmm_gemv_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, TX* __restrict__ out,
                float* __restrict__ partial, int M, int K, int N) {
  // x's slice [kGemvRows, MM] during the loop, then the warps' sums
  // [kGemvWarps, MM, kGemvCols]
  __shared__ __align__(16) float smem[kGemvWarps * MM * kGemvCols];
  static_assert(MM * kGemvRows <= kGemvWarps * MM * kGemvCols,
                "x slice must fit the reduction buffer");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.y * kGemvRows;
  const int kn = min(kGemvRows, K - k0);
  const int col0 = blockIdx.x * kGemvCols + lane * 4;

  stage_x<TX, MM>(x, smem, M, K, k0, kn);
  __syncthreads();

  float acc[MM][4];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  if (kVec && col0 + 3 < N)
    gemv_rows<MM, true>(w, smem, acc, N, k0, kn, col0, warp);
  else
    gemv_rows<MM, false>(w, smem, acc, N, k0, kn, col0, warp);
  __syncthreads();  // x's slice is no longer read

#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      smem[(warp * MM + m) * kGemvCols + lane * 4 + j] = acc[m][j];
  __syncthreads();

  for (int i = threadIdx.x; i < M * kGemvCols; i += kGemvThreads) {
    const int m = i / kGemvCols;
    const int c = i % kGemvCols;
    const int col = blockIdx.x * kGemvCols + c;
    if (col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kGemvWarps; ++v) s += smem[(v * MM + m) * kGemvCols + c];
    if (gridDim.y == 1)
      out[(size_t)m * N + col] = from_float<TX>(s * scale[col]);
    else
      partial[((size_t)blockIdx.y * M + m) * N + col] = s;
  }
}

// Sums the K slices' partials [ksplit, M, N] in slice order, then scales.
// Launched plainly after qmm_gemv_kernel, and as a programmatic dependent
// of qmm_dec_kernel (the wait is a no-op in a plain launch).
template <typename TX>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  TX* __restrict__ out, int M, int N,
                                  int ksplit) {
  hopper::wait_primary();  // the splits' partials are written
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < ksplit; ++p) s += partial[(size_t)p * mn + i];
  out[i] = from_float<TX>(s * scale[i % N]);
}

// -- bf16 x off the TMA rule, M > 8: mma.sync tiles -------------------------

constexpr int kMmaBM = 64;
constexpr int kMmaBN = 128;
constexpr int kMmaBK = 64;
constexpr int kAStride = kMmaBK + 8;  // bf16 per shared row of the x tile
constexpr int kBStride = kMmaBN + 8;  // ... of the weight tile
constexpr int kMmaThreads = 256;
// 16-byte chunks a thread moves per tile: x [64, 64] bf16 and w [64, 128]
// int8 are 512 chunks each
constexpr int kChunks = kMmaBM * kMmaBK * 2 / 16 / kMmaThreads;
static_assert(kChunks == kMmaBK * kMmaBN / 16 / kMmaThreads, "tile split");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// The next tile's global data, held in registers while the current one
// is multiplied: x as 8 bf16 and w as 16 int8 per 16-byte chunk.
struct MmaStage {
  uint4 a[kChunks];
  int4 b[kChunks];
};

__device__ __forceinline__ void load_stage(MmaStage& st,
                                           const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ w, int M,
                                           int K, int N, int m0, int n0,
                                           int k0, bool vec_x, bool vec_w) {
#pragma unroll
  for (int r = 0; r < kChunks; ++r) {
    const int c = threadIdx.x + r * kMmaThreads;
    {  // x: row m, columns k..k+7
      const int m = m0 + c / (kMmaBK / 8);
      const int k = k0 + (c % (kMmaBK / 8)) * 8;
      if (vec_x && m < M && k < K) {
        st.a[r] = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = (m < M && k + 2 * e < K)
                               ? __bfloat162float(x[(size_t)m * K + k + 2 * e])
                               : 0.f;
          const float hi =
              (m < M && k + 2 * e + 1 < K)
                  ? __bfloat162float(x[(size_t)m * K + k + 2 * e + 1])
                  : 0.f;
          v[e] = pack_bf16x2(lo, hi);
        }
        st.a[r] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    {  // w: row k, columns n..n+15
      const int k = k0 + c / (kMmaBN / 16);
      const int n = n0 + (c % (kMmaBN / 16)) * 16;
      if (vec_w && k < K && n < N) {
        st.b[r] = *reinterpret_cast<const int4*>(w + (size_t)k * N + n);
      } else {
        int v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          unsigned u = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nn = n + 4 * e + j;
            const int8_t b = (k < K && nn < N) ? w[(size_t)k * N + nn] : 0;
            u |= (unsigned)(uint8_t)b << (8 * j);
          }
          v[e] = (int)u;
        }
        st.b[r] = make_int4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// Registers -> shared memory; the int8 weights widen to bf16 (exact).
__device__ __forceinline__ void store_stage(const MmaStage& st,
                                            __nv_bfloat16* s_a,
                                            __nv_bfloat16* s_b) {
#pragma unroll
  for (int r = 0; r < kChunks; ++r) {
    const int c = threadIdx.x + r * kMmaThreads;
    *reinterpret_cast<uint4*>(s_a + (c / (kMmaBK / 8)) * kAStride +
                              (c % (kMmaBK / 8)) * 8) = st.a[r];
    const int words[4] = {st.b[r].x, st.b[r].y, st.b[r].z, st.b[r].w};
    uint32_t h[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = words[e];
      h[2 * e] = pack_bf16x2((float)(int8_t)(v & 0xff),
                             (float)(int8_t)((v >> 8) & 0xff));
      h[2 * e + 1] = pack_bf16x2((float)(int8_t)((v >> 16) & 0xff),
                                 (float)(int8_t)((v >> 24) & 0xff));
    }
    uint4* dst = reinterpret_cast<uint4*>(
        s_b + (c / (kMmaBN / 16)) * kBStride + (c % (kMmaBN / 16)) * 16);
    dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
    dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
qmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ w, const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 s_a[kMmaBM * kAStride];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 s_b[kMmaBK * kBStride];  // [k][n]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // mma group id
  const int t = lane % 4;   // thread in group
  const int wm = (warp / 4) * 32;  // warp's rows within the tile
  const int wn = (warp % 4) * 32;  // warp's columns within the tile
  const int m0 = blockIdx.y * kMmaBM;
  const int n0 = blockIdx.x * kMmaBN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // 16-byte loads where every row starts 16-byte aligned
  const bool vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  MmaStage st;
  load_stage(st, x, w, M, K, N, m0, n0, 0, vec_x, vec_w);
  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    store_stage(st, s_a, s_b);
    __syncthreads();
    if (k0 + kMmaBK < K)  // the next tile's loads overlap this tile's math
      load_stage(st, x, w, M, K, N, m0, n0, k0 + kMmaBK, vec_x, vec_w);
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4<false>(a[i], s_a + (wm + i * 16 + lane % 16) * kAStride + kk +
                                 (lane / 16) * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldsm_x4<true>(r, s_b + (kk + lane % 16) * kBStride + wn +
                             (2 * jj + lane / 16) * 8);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + (r / 2) * 8;
        const int n = n0 + wn + j * 8 + 2 * t + (r % 2);
        if (m < M && n < N)
          out[(size_t)m * N + n] = __float2bfloat16(acc[i][j][r] * scale[n]);
      }
}

// -- bf16 x on the tensor cores: the shared weight tile -----------------------

constexpr int kTK = 64;            // k rows per ring stage
constexpr int kTN = 128;           // channels per block: one swizzled row
constexpr int kWTile = kTK * kTN;  // 8 KB of int8 weights a stage
constexpr int kDecMaxM = 64;       // the GEMV's rows: MT <= 8 n8 tiles

// Bytes 0 and 2 of t as a bf16x2 (byte 0 in the low half), exactly: in
// bf16, 128 + (b & 127) is exact (7 mantissa bits), and subtracting 128,
// or 256 when b's sign bit is set, leaves b.  Two LOP3s and an HSUB2 for
// two weights, in place of two quarter-rate conversions.
__device__ __forceinline__ uint32_t widen_pair(uint32_t t) {
  const uint32_t mag = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t off = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
              *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// The A fragments of k16 steps j and j + 1 (rows 16 j .. 16 j + 31 of the
// stage) for 16-channel chunk `chunk` of the swizzled int8 tile: a[0] for
// step j, a[1] for step j + 1.  Lane l addresses row 16 j + l (lanes
// 8 i .. 8 i + 7 give matrix i's rows); the 128-byte swizzle puts chunk c
// of row r at c ^ (r & 7), which spreads each matrix over all banks.
__device__ __forceinline__ void weight_frags(const uint8_t* wt, int j,
                                             int chunk, int lane,
                                             uint32_t (&a)[2][4]) {
  uint32_t r[4];
  ldsm_x4<true>(r,
                wt + (16 * j + lane) * kTN + ((chunk ^ (lane & 7)) << 4));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h][0] = widen_pair(r[2 * h]);           // channel 2g, k 2t, 2t + 1
    a[h][1] = widen_pair(r[2 * h] >> 8);      // channel 2g + 1
    a[h][2] = widen_pair(r[2 * h + 1]);       // channel 2g, k 2t + 8, + 9
    a[h][3] = widen_pair(r[2 * h + 1] >> 8);  // channel 2g + 1
  }
}

// -- bf16 x, small M: the tensor-core GEMV ------------------------------------

constexpr int kDecWarps = 4;                    // consumer warps
constexpr int kDecThreads = (kDecWarps + 1) * 32;  // + a producer warp
constexpr int kDecRing = 64 * 1024;             // ring bytes a block
constexpr int kDecBoxes = 2;  // weight tiles side by side: 256 channels
constexpr int kDecN = kDecBoxes * kTN;          // channels a block

template <int MT>
struct Dec {
  static constexpr int kXTile = 8 * MT * kTK * 2;  // [8 MT rows][64 k] bf16
  // kDecBoxes weight tiles, then x: multiples of 1024
  static constexpr int kStage = kDecBoxes * kWTile + kXTile;
  static constexpr int kStages = kDecRing / kStage;
  static constexpr int kSmem = 1024 + kStages * kStage + 16 * kStages;
  static_assert(kStages >= 2 && kSmem <= 232448, "ring");
};

// One block: channels n0 .. n0 + kDecN - 1 over the k tiles of split
// blockIdx.y.
template <int MT>
__global__ void __launch_bounds__(kDecThreads)
qmm_dec_kernel(const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tx,
               const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
               int M, int N, int ksplit, int tiles_lo, int tiles_rem) {
  using P = Dec<MT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::kStages * P::kStage);
  uint64_t* empty = full + P::kStages;
  // split z: tiles_lo k tiles, one more for the first tiles_rem splits
  // (the host divides, so the kernel holds no integer division, whose
  // SASS would convert through I2F)
  const int n0 = blockIdx.x * kDecN, z = blockIdx.y;
  const int k0 = z * tiles_lo + min(z, tiles_rem);
  const int steps = tiles_lo + (z < tiles_rem ? 1 : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      hopper::bar_init(full + s, 1);
      hopper::bar_init(empty + s, kDecWarps);  // one arrival per warp
    }
    hopper::bar_fence_init();
  }
  __syncthreads();
  hopper::launch_dependents();  // the split sum may be scheduled

  if (warp == kDecWarps) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % P::kStages;
        if (i >= P::kStages)
          hopper::bar_wait(empty + s, ((i / P::kStages) & 1) ^ 1);
        uint8_t* st = ring + s * P::kStage;
        const int kc = (k0 + i) * kTK;
        hopper::bar_expect(full + s, P::kStage);
#pragma unroll
        for (int b = 0; b < kDecBoxes; ++b)
          hopper::tma_2d(st + b * kWTile, &tw, full + s, n0 + b * kTN, kc);
        hopper::tma_2d(st + kDecBoxes * kWTile, &tx, full + s, kc, 0);
      }
    }
    return;
  }

  // consumer warp w: chunks 2w and 2w + 1 of every weight tile b
  // (channels n0 + 128 b + 32 w ..)
  float acc[kDecBoxes][2][MT][4];
#pragma unroll
  for (int b = 0; b < kDecBoxes; ++b)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int nt = 0; nt < MT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][c][nt][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int s = i % P::kStages;
    hopper::bar_wait(full + s, (i / P::kStages) & 1);
    const uint8_t* st = ring + s * P::kStage;
    const uint8_t* xt = st + kDecBoxes * kWTile;
#pragma unroll
    for (int j = 0; j < kTK / 16; j += 2) {
      // B fragments of steps j, j + 1 for each n8 tile: x rows 8 nt ..
      // 8 nt + 7, 16-byte chunks 2 j .. 2 j + 3 of the swizzled rows
      uint32_t bx[MT][4];
#pragma unroll
      for (int nt = 0; nt < MT; ++nt)
        ldsm_x4<false>(bx[nt], xt + (nt * 8 + lane % 8) * 128 +
                                   (((2 * j + lane / 8) ^ (lane % 8)) << 4));
#pragma unroll
      for (int b = 0; b < kDecBoxes; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t a[2][4];
          weight_frags(st + b * kWTile, j, 2 * warp + c, lane, a);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < MT; ++nt)
              mma_bf16(acc[b][c][nt], a[h], &bx[nt][2 * h]);
        }
    }
    hopper::release(empty + s, lane);
  }

  // C fragment: element e is channel 2g + (e >> 1) of the chunk, x row
  // 8 nt + 2t + (e & 1)
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int b = 0; b < kDecBoxes; ++b)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int nt = 0; nt < MT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n =
              n0 + b * kTN + 16 * (2 * warp + c) + 2 * g + (e >> 1);
          const int m = nt * 8 + 2 * t + (e & 1);
          if (m >= M || n >= N) continue;
          if (ksplit == 1)
            out[(size_t)m * N + n] =
                __float2bfloat16(acc[b][c][nt][e] * scale[n]);
          else
            partial[((size_t)z * M + m) * N + n] = acc[b][c][nt][e];
        }
}

// -- bf16 x, larger M: wgmma, the weight widened in registers -----------------

constexpr int kWgThreads = 384;  // two consumer warpgroups + producer
constexpr int kWgRows = 128;                // x rows per block: wgmma n128
constexpr int kWgXTile = kWgRows * kTK * 2;  // 16 KB, [128 rows][64 k] bf16
constexpr int kWgStage = kWTile + kWgXTile;  // 24 KB
constexpr int kWgStages = 8;
constexpr int kWgSmem = 1024 + kWgStages * kWgStage + 16 * kWgStages;
static_assert(kWgSmem <= 232448, "a block has 227 KB of shared memory");

// One block: x rows m0 .. m0 + 127 (blockIdx.x) by channels n0 .. n0 + 127
// (blockIdx.y), over all of K.
__global__ void __launch_bounds__(kWgThreads, 1)
qmm_wg_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx,
              const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kWgStage);
  uint64_t* empty = full + kWgStages;
  const int m0 = blockIdx.x * kWgRows, n0 = blockIdx.y * kTN;
  const int nk = (K + kTK - 1) / kTK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::bar_init(full + s, 1);
      hopper::bar_init(empty + s, 8);  // one arrival per consumer warp
    }
    hopper::bar_fence_init();
  }
  __syncthreads();

  if (role == 2) {  // producer warpgroup: one thread issues the loads
    hopper::regs_producer();
    if (threadIdx.x == 256) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kWgStages;
        if (i >= kWgStages)
          hopper::bar_wait(empty + s, ((i / kWgStages) & 1) ^ 1);
        uint8_t* st = ring + s * kWgStage;
        const int kc = i * kTK;
        hopper::bar_expect(full + s, kWgStage);
        hopper::tma_2d(st, &tw, full + s, n0, kc);
        hopper::tma_2d(st + kWTile, &tx, full + s, kc, m0);
      }
    }
    return;
  }

  // consumer warp w (0..7): the wgmma rows of chunk w, channels
  // n0 + 16 w ..; warpgroup w / 4 owns chunks 4 (w / 4) .. + 3
  hopper::regs_consumer();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // Stage i: widen its 4 k16 A fragments, run their products as one
  // commit group, then wait for stage i - 1's and free that stage.  The
  // fragments of consecutive stages live in two arrays (aa, ab): wgmma
  // reads its A registers asynchronously, so the products of stage i read
  // theirs while stage i + 1 widens into the other, and they must be
  // distinct registers in the PTX too (one array written every stage
  // corrupts the group still in flight).
  auto stage = [&](int i, uint32_t (&a)[kTK / 32][2][4]) {
    const int s = i % kWgStages;
    hopper::bar_wait(full + s, (i / kWgStages) & 1);
    const uint8_t* wt = ring + s * kWgStage;
#pragma unroll
    for (int j = 0; j < kTK / 32; ++j)
      weight_frags(wt, 2 * j, warp, lane, a[j]);
    hopper::wg_fence();
    const uint64_t db = hopper::kdesc(wt + kWTile);
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      hopper::wgmma_rs_n128(acc, a[kk / 2][kk % 2],
                            db + hopper::kstep(kWgRows, kk));
    hopper::wg_commit();
    hopper::wg_wait1();  // products of stage i - 1 are done: free it
    if (i > 0) hopper::release(empty + (i - 1) % kWgStages, lane);
  };
  uint32_t aa[kTK / 32][2][4], ab[kTK / 32][2][4];
  int i = 0;
  for (; i + 1 < nk; i += 2) {
    stage(i, aa);
    stage(i + 1, ab);
  }
  if (i < nk) stage(i, aa);
  hopper::wg_wait0();
  hopper::fence_regs(acc);

  // acc[4 j + e]: channel 2g + (e >> 1) of the chunk, x row 8 j + 2t +
  // (e & 1); channel pairs leave as bf16x2
  const int g = lane / 4, t = lane % 4;
  const int n = n0 + 16 * warp + 2 * g;
  if (n < N) {  // N % 16 == 0: both channels or neither
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int j = 0; j < kWgRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m < M) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + e] * s0, acc[4 * j + 2 + e] * s1);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) = v;
        }
      }
    }
  }
}

// -- M > 8, f32 x: FMA tiles -----------------------------------------------------

constexpr int kFmaBM = 64;
constexpr int kFmaBN = 64;
constexpr int kFmaBK = 16;
constexpr int kFmaThreads = 256;

__global__ void __launch_bounds__(kFmaThreads)
qmm_fma_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, float* __restrict__ out,
               int M, int K, int N) {
  __shared__ float s_a[kFmaBK][kFmaBM];  // [k][m]
  __shared__ float s_b[kFmaBK][kFmaBN];  // [k][n]
  const int tx = threadIdx.x % 16;  // columns tx + 16 j
  const int ty = threadIdx.x / 16;  // rows ty + 16 i
  const int m0 = blockIdx.y * kFmaBM;
  const int n0 = blockIdx.x * kFmaBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
    for (int e = threadIdx.x; e < kFmaBM * kFmaBK; e += kFmaThreads) {
      const int m = e / kFmaBK;
      const int k = e % kFmaBK;
      s_a[k][m] = (m0 + m < M && k0 + k < K) ? x[(size_t)(m0 + m) * K + k0 + k]
                                             : 0.f;
    }
    for (int e = threadIdx.x; e < kFmaBK * kFmaBN; e += kFmaThreads) {
      const int k = e / kFmaBN;
      const int n = e % kFmaBN;
      s_b[k][n] = (k0 + k < K && n0 + n < N)
                      ? (float)w[(size_t)(k0 + k) * N + n0 + n]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFmaBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i;
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j] * scale[n];
    }
}

struct Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* workspace;
  int M, K, N, ksplit;
  cudaStream_t stream;
};

template <typename TX, int MM, bool kVec>
cudaError_t launch_gemv(const Args& a) {
  const dim3 grid((a.N + kGemvCols - 1) / kGemvCols, a.ksplit);
  qmm_gemv_kernel<TX, MM, kVec><<<grid, kGemvThreads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), a.w, a.scale, static_cast<TX*>(a.out),
      a.workspace, a.M, a.K, a.N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.ksplit == 1) return e;
  const size_t mn = (size_t)a.M * a.N;
  qmm_reduce_kernel<TX><<<(unsigned)((mn + 255) / 256), 256, 0, a.stream>>>(
      a.workspace, a.scale, static_cast<TX*>(a.out), a.M, a.N, a.ksplit);
  return cudaGetLastError();
}

template <typename TX, bool kVec>
cudaError_t by_rows(const Args& a) {
  if (a.M <= 1) return launch_gemv<TX, 1, kVec>(a);
  if (a.M <= 2) return launch_gemv<TX, 2, kVec>(a);
  if (a.M <= 4) return launch_gemv<TX, 4, kVec>(a);
  return launch_gemv<TX, 8, kVec>(a);
}

template <typename TX>
cudaError_t gemv(const Args& a) {
  // 4-byte weight loads where every row starts 4-byte aligned
  const bool vec = a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 4 == 0;
  return vec ? by_rows<TX, true>(a) : by_rows<TX, false>(a);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A [rows, cols] row-major tensor read in boxes of box_rows x box_cols
// with the 128-byte swizzle (box_cols * element size == 128): the int8
// weight [K, N] in [64 k][128 channel] boxes, x [M, K] bf16 in [rows][64 k]
// boxes.  Boxes past the edges are filled with zeros.
bool make_map(CUtensorMap* map, const void* base, bool int8, int rows,
              int cols, int box_rows, int box_cols) {
  const hopper::EncodeTiled fn = hopper::encode_fn();
  if (fn == nullptr) return false;
  const size_t elem = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map,
            int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets a kernel's shared-memory limit once per device.
template <typename Kern>
cudaError_t allow_smem_once(Kern kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  e = hopper::allow_smem(kernel, bytes);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

template <int MT>
cudaError_t launch_dec(const Args& a, const CUtensorMap& tw) {
  using P = Dec<MT>;
  CUtensorMap tx;
  if (!make_map(&tx, a.x, false, a.M, a.K, 8 * MT, kTK))
    return cudaErrorNotSupported;
  static unsigned attrs = 0;
  auto kernel = qmm_dec_kernel<MT>;
  cudaError_t e = allow_smem_once(kernel, P::kSmem, attrs);
  if (e != cudaSuccess) return e;
  auto* out = static_cast<__nv_bfloat16*>(a.out);
  const dim3 grid((a.N + kDecN - 1) / kDecN, a.ksplit);
  const int nk = (a.K + kTK - 1) / kTK;
  kernel<<<grid, kDecThreads, P::kSmem, a.stream>>>(
      tw, tx, a.scale, out, a.workspace, a.M, a.N, a.ksplit, nk / a.ksplit,
      nk % a.ksplit);
  if ((e = cudaGetLastError()) != cudaSuccess || a.ksplit == 1) return e;
  // the split sum, a programmatic dependent: its blocks are scheduled
  // while the last splits run, and wait for them
  const size_t mn = (size_t)a.M * a.N;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)((mn + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = a.stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qmm_reduce_kernel<__nv_bfloat16>,
                         static_cast<const float*>(a.workspace), a.scale, out,
                         a.M, a.N, a.ksplit);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t launch_wg(const Args& a, const CUtensorMap& tw) {
  CUtensorMap tx;
  if (!make_map(&tx, a.x, false, a.M, a.K, kWgRows, kTK))
    return cudaErrorNotSupported;
  static unsigned attrs = 0;
  cudaError_t e = allow_smem_once(qmm_wg_kernel, kWgSmem, attrs);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.M + kWgRows - 1) / kWgRows, (a.N + kTN - 1) / kTN);
  qmm_wg_kernel<<<grid, kWgThreads, kWgSmem, a.stream>>>(
      tw, tx, a.scale, static_cast<__nv_bfloat16*>(a.out), a.M, a.K, a.N);
  return cudaGetLastError();
}

// Routes, chosen by the wrapper from the shapes, dtype and alignment.
enum Route { kSimtGemv = 0, kSimtTiles = 1, kDecode = 2, kPrefill = 3 };

}  // namespace

// Launches on `stream`, whose device must be the calling thread's current
// one (the Python wrapper selects it).  Returns 0 on success, else the CUDA
// error code of the refused launch (cudaErrorInvalidValue for arguments
// this route does not take, cudaErrorNotSupported when a tensor map cannot
// be encoded).  x_dtype: 0 = float32, 1 = bfloat16.  route:
//   0  qmm_gemv_kernel (M <= 8, any dtype): `ksplit` must be
//      ceil(K / 512), and above 1 `workspace` holds ksplit * M * N floats;
//   1  qmm_mma_kernel (bf16) / qmm_fma_kernel (f32) tiles, any M;
//   2  qmm_dec_kernel (bf16, M <= 64): 1 <= ksplit <= ceil(K / 64), and
//      above 1 `workspace` holds ksplit * M * N floats;
//   3  qmm_wg_kernel (bf16, any M).
// Routes 2 and 3 need N % 16 == 0, K % 8 == 0 and x and qweight 16-byte
// aligned (TMA's row strides and base); routes 1 and 3 ignore ksplit and
// workspace.
extern "C" int quant_matmul_launch(const void* x, const void* qweight,
                                   const void* scale, void* out,
                                   void* workspace, int M, int K, int N,
                                   int x_dtype, int route, int ksplit,
                                   void* stream) {
  if (M < 1 || K < 1 || N < 1 || x_dtype < 0 || x_dtype > 1)
    return cudaErrorInvalidValue;
  const Args a{x, static_cast<const int8_t*>(qweight),
               static_cast<const float*>(scale), out,
               static_cast<float*>(workspace), M, K, N, ksplit,
               static_cast<cudaStream_t>(stream)};
  if (route == kSimtGemv) {
    if (M > kSmallM || ksplit != (K + kGemvRows - 1) / kGemvRows ||
        (ksplit > 1 && workspace == nullptr))
      return cudaErrorInvalidValue;
    return x_dtype == 0 ? gemv<float>(a) : gemv<__nv_bfloat16>(a);
  }
  if (route == kSimtTiles) {
    if ((M + kMmaBM - 1) / kMmaBM > 65535) return cudaErrorInvalidValue;
    if (x_dtype == 1) {
      const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
      qmm_mma_kernel<<<grid, kMmaThreads, 0, a.stream>>>(
          static_cast<const __nv_bfloat16*>(x), a.w, a.scale,
          static_cast<__nv_bfloat16*>(out), M, K, N);
    } else {
      const dim3 grid((N + kFmaBN - 1) / kFmaBN, (M + kFmaBM - 1) / kFmaBM);
      qmm_fma_kernel<<<grid, kFmaThreads, 0, a.stream>>>(
          static_cast<const float*>(x), a.w, a.scale,
          static_cast<float*>(out), M, K, N);
    }
    return cudaGetLastError();
  }
  if (route != kDecode && route != kPrefill) return cudaErrorInvalidValue;
  if (x_dtype != 1 || N % 16 != 0 || K % 8 != 0 || !aligned16(x) ||
      !aligned16(qweight))
    return cudaErrorInvalidValue;
  CUtensorMap tw;
  if (!make_map(&tw, qweight, true, K, N, kTK, kTN))
    return cudaErrorNotSupported;
  if (route == kPrefill) {
    if ((N + kTN - 1) / kTN > 65535) return cudaErrorInvalidValue;
    return launch_wg(a, tw);
  }
  const int nk = (K + kTK - 1) / kTK;
  if (M > kDecMaxM || ksplit < 1 || ksplit > nk || ksplit > 65535 ||
      (ksplit > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  if (M <= 8) return launch_dec<1>(a, tw);
  if (M <= 16) return launch_dec<2>(a, tw);
  if (M <= 32) return launch_dec<4>(a, tw);
  return launch_dec<8>(a, tw);
}
