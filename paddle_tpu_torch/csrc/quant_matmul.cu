// Int8-weight matmul (W8A16) for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_kernels/
// quant_matmul.py (_kernel / _pallas_qmm), the serving-side weight GEMM
// under PT_QUANT=int8:
//
//     out[M, N] = cast_to_x_dtype((float(x) @ float(qweight)) * scale)
//
// Layouts (all contiguous, row-major):
//   x        [M, K]  float32 or bfloat16
//   qweight  [K, N]  int8, the repo's [in, out] layout
//   scale    [N]     float32, one per output channel
//   out      [M, N]  x's dtype
//
// int8 becomes float (or bf16, exactly: |q| <= 127) next to the product,
// in registers or shared memory; the weight is never written back to
// device memory widened.  The scale is applied once, to the f32 sum.
//
// Bound.  Decode (M = batch, 1-8) moves K * N weight bytes for 2 * M flops
// each: far below the card's ~295 flop/byte ridge, so the weight stream
// sets the pace (half of bf16's).  Prefill (M = chunk, up to 512) is above
// it: 2 * M * K * N flops at the bf16 tensor-core rate.
//
// Design (simple first; wgmma, TMA and a deeper pipeline come later):
//   * M <= 8, split-K GEMV (qmm_gemv_kernel): a block owns 128 columns
//     and a 512-row slice of K; each lane reads 4 columns of a weight row
//     (a warp reads one 128-byte line per row), the 8 warps take rows
//     k = w, w + 8, ... of the slice, and x's slice sits in shared memory
//     as float, transposed so a row's x values are one or two 16-byte
//     loads.  Products and sums are fp32 FMAs (a bf16 x int8 product is
//     exact in fp32).  The warps' sums meet in shared memory; with one K
//     slice the block scales and writes out, otherwise it writes an fp32
//     partial and qmm_reduce_kernel sums the slices in a fixed order, so
//     results do not change from run to run (no atomics).
//   * M > 8, bf16 x (qmm_mma_kernel): 64 x 128 output tiles, K in steps of
//     64, 8 warps each owning 32 x 32 through mma.sync m16n8k16
//     bf16 x bf16 -> fp32, fragments by ldmatrix (.trans for the [k][n]
//     weight tile).  Each thread moves its share of the next tile with
//     16-byte loads into registers while the current tile is multiplied;
//     the int8 weights are widened to bf16 (exact) as they are stored to
//     shared memory.  Every product is exact in fp32, as in the TPU
//     kernel's f32 dot; only the order of summation differs.
//   * M > 8, f32 x (qmm_fma_kernel): 64 x 64 tiles, K in steps of 16,
//     4 x 4 outputs per thread on the fp32 cores (tensor cores would round
//     f32 x to TF32, which the TPU kernel does not).
// Every tile edge is bounds-checked, so any M, K and N work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// -- M <= 8: split-K GEMV ------------------------------------------------------

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
template <typename TX>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  TX* __restrict__ out, int M, int N,
                                  int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < ksplit; ++p) s += partial[(size_t)p * mn + i];
  out[i] = from_float<TX>(s * scale[i % N]);
}

// -- M > 8, bf16 x: mma.sync tiles ---------------------------------------------

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

}  // namespace

// Launches on `stream`, whose device must be the calling thread's current
// one (the Python wrapper selects it).  Returns 0 on success, else the CUDA
// error code of the refused launch (cudaErrorInvalidValue for arguments
// this kernel does not take).  x_dtype: 0 = float32, 1 = bfloat16.
// For M <= 8, `ksplit` must be ceil(K / 512), and when it is above 1
// `workspace` must hold ksplit * M * N floats; for M > 8 both are unused.
extern "C" int quant_matmul_launch(const void* x, const void* qweight,
                                   const void* scale, void* out,
                                   void* workspace, int M, int K, int N,
                                   int x_dtype, int ksplit, void* stream) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  const Args a{x, static_cast<const int8_t*>(qweight),
               static_cast<const float*>(scale), out,
               static_cast<float*>(workspace), M, K, N, ksplit,
               static_cast<cudaStream_t>(stream)};
  if (M <= kSmallM) {
    if (ksplit != (K + kGemvRows - 1) / kGemvRows ||
        (ksplit > 1 && workspace == nullptr))
      return cudaErrorInvalidValue;
    if (x_dtype == 0) return gemv<float>(a);
    if (x_dtype == 1) return gemv<__nv_bfloat16>(a);
    return cudaErrorInvalidValue;
  }
  if (x_dtype == 1) {
    const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
    qmm_mma_kernel<<<grid, kMmaThreads, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(x), a.w, a.scale,
        static_cast<__nv_bfloat16*>(out), M, K, N);
    return cudaGetLastError();
  }
  if (x_dtype == 0) {
    const dim3 grid((N + kFmaBN - 1) / kFmaBN, (M + kFmaBM - 1) / kFmaBM);
    qmm_fma_kernel<<<grid, kFmaThreads, 0, a.stream>>>(
        static_cast<const float*>(x), a.w, a.scale, static_cast<float*>(out),
        M, K, N);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
