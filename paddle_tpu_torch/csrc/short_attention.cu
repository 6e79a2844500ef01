// Short-sequence attention, forward and backward, with in-kernel hash
// dropout, for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels/
// short_attention.py: _fwd_call_impl (_fwd_kernel) and _bwd_call
// (_bwd_kernel).  Per (batch, head) bh, with q/k/v [S, D] (D = 64 or 128),
// s = (q . k) * scale (causal: j <= i) and keep mask M (below), keep = 1 - p:
//
//     fwd:  lse = logsumexp_j s[i, j]                          fp32
//           out = (softmax(s) * M / keep) @ v                  q's dtype
//     bwd:  p = exp(s - lse);  pd = p * M / keep;  dp = (g @ v^T) * M / keep
//           ds = p * (dp - delta),  delta_i = sum_d g * out    (fp32 out)
//           dv = pd^T @ g;  dq = ds @ k * scale;  dk = ds^T @ q * scale
//
// The keep mask is the TPU kernel's counter hash (_keep_mask), bit for bit:
// x = row * S + col + (seed + bh * 747796405) in uint32, through the
// murmur3 finalizer, kept where x < threshold = min(int(keep * 2^32),
// 2^32 - 1).  Row and column are global indices of the [S, S] matrix, so
// any tiling regenerates the same mask.  The seed is read from device
// memory (an int32 the wrapper draws on the card), so no host sync.
//
// Bound: at BERT-base's B=48, H=12, S=384, D=64, bytes.  The forward's two
// products are 2 * 2 * B H S^2 D = 2.17e10 flops (0.022 ms at 989 TFLOP/s
// bf16), the backward's five 5.44e10 (0.055 ms); q, k, v, out once each in
// bf16 are 113 MB (0.034 ms at 3.35 TB/s), before the fp32 copy of out.
//
// Design (simple first; mma.sync / wgmma and TMA come later):
//   * The TPU kernel keeps one head's whole [S, S] score matrix in VMEM;
//     S = 1024 fp32 scores are 4 MB and a Hopper block has at most 227 KB
//     of shared memory.  So this is flash-style: 64-row q tiles against
//     64-row K/V tiles, an fp32 online softmax (running max m and sum l
//     per row), K tiles above the diagonal never loaded when causal.
//   * Dropout multiplies only the numerator: l sums the undropped
//     exponentials, the tile's probabilities go into P @ V as e * M / keep,
//     and the epilogue divides by l.  That is the TPU's p = e / l followed
//     by the mask, in another rounding order.
//   * Tiles sit in shared memory as fp32 with an odd row stride (D + 1,
//     65), so row- and column-wise reads are free of bank conflicts; 256
//     threads in a 16 x 16 grid each own a 4 x 4 block of scores (rows
//     ty + 16 i, columns tx + 16 j) and a 4 x D/16 block of the [64, D]
//     outputs.  Products run on the fp32 cores; bf16 inputs are widened on
//     load, as the TPU kernel does.
//   * Backward: dK/dV are summed over q tiles by a separate pass over K
//     tiles and dQ by a pass over q tiles: seven products instead of five,
//     but no atomics, so the sums repeat run to run.  A first small kernel
//     forms delta from the fp32 output the forward kept; from a bf16 output
//     it would miss the TPU's rowsum(dp * p) by one rounding of out.
// S must be a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kB = 64;           // rows per q tile and per K/V tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLT = kB + 1;      // padded stride of [64, 64] tiles
constexpr int kSq = kB * kLT;    // floats of one [64, 64] tile

template <int kD>
struct Dims {
  static constexpr int kLD = kD + 1;       // padded stride of [64, D] tiles
  static constexpr int kTile = kB * kLD;   // floats of one [64, D] tile
  static constexpr int kN = kD / 16;       // output columns per thread
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
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

// The TPU kernel's keep decision for element (row, col) of one head's
// [S, S] matrix; `per` is seed + bh * 747796405, wrapped.
__device__ __forceinline__ bool keep_elem(uint32_t per, int row, int col,
                                          int S, uint32_t threshold) {
  uint32_t x = (uint32_t)row * (uint32_t)S + (uint32_t)col + per;
  x *= 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < threshold;
}

// Max / sum over the 16 lanes that share a row (tx = lane % 16).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy 64 rows of [*, D] from `src` into the padded fp32 tile `dst`.
template <int kD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src) {
  constexpr int kLD = Dims<kD>::kLD;
  for (int it = threadIdx.x; it < kB * (kD / 4); it += kThreads) {
    const int r = it / (kD / 4);
    const int c = (it % (kD / 4)) * 4;
    float a[4];
    load4(src + (size_t)r * kD + c, a);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * kLD + c + e] = a[e];
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded
// [64, D] tiles (rows of both index the 64 x 64 result).
template <int kD>
__device__ __forceinline__ void dot_tiles(const float* A, const float* B,
                                          float acc[4][4], int ty, int tx) {
  constexpr int kLD = Dims<kD>::kLD;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kLD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * kLD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// acc[i][j] += sum_c P[ty + 16 i][c] * V[c][tx + 16 j]: a padded [64, 64]
// tile times a padded [64, D] tile into a thread's 4 x D/16 outputs.
template <int kD>
__device__ __forceinline__ void mul_tiles(const float* P, const float* V,
                                          float acc[4][Dims<kD>::kN], int ty,
                                          int tx) {
  constexpr int kLD = Dims<kD>::kLD, kN = Dims<kD>::kN;
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float a[4], b[kN];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * kLT + c];
#pragma unroll
    for (int j = 0; j < kN; ++j) b[j] = V[c * kLD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[i][j] += a[i] * b[j];
  }
}

// Store a thread's 4 x D/16 block of a [64, D] tile.
template <int kD, typename T>
__device__ __forceinline__ void store_rows(T* dst, float acc[4][Dims<kD>::kN],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Dims<kD>::kN; ++j)
      dst[(size_t)(ty + 16 * i) * kD + tx + 16 * j] = from_float<T>(acc[i][j]);
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, batch * head)

template <typename T, int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
sattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seed,
                 T* __restrict__ out, float* __restrict__ out32,
                 float* __restrict__ lse, int S, float scale,
                 uint32_t threshold, float inv) {
  constexpr int kTile = Dims<kD>::kTile, kN = Dims<kD>::kN;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile;
  float* sV = sK + kTile;
  float* sP = sV + kTile;  // [64, 64] dropped exponentials of this K tile
  const int nt = S / kB;
  const int qt = nt - 1 - blockIdx.x;  // longest causal loops first
  const int bh = blockIdx.y;
  const size_t head = (size_t)bh * S * kD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool dropout = seed != nullptr;
  const uint32_t per =
      dropout ? (uint32_t)seed[0] + (uint32_t)bh * 747796405u : 0u;

  load_tile<kD>(sQ, q + head + (size_t)qt * kB * kD);
  float m[4], l[4], o[4][kN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) o[i][j] = 0.f;
  }

  const int nk = kCausal ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
    load_tile<kD>(sK, k + head + (size_t)kt * kB * kD);
    load_tile<kD>(sV, v + head + (size_t)kt * kB * kD);
    __syncthreads();
    float s[4][4] = {};
    dot_tiles<kD>(sQ, sK, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = qt * kB + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kt * kB + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kCausal && c > r) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - mn);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - mn);
        rs += e;  // l sums the undropped exponentials
        float pe = e;
        if (dropout)
          pe = keep_elem(per, r, kt * kB + tx + 16 * j, S, threshold)
                   ? e * inv
                   : 0.f;
        sP[(ty + 16 * i) * kLT + tx + 16 * j] = pe;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < kN; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    mul_tiles<kD>(sP, sV, o, ty, tx);
  }

  const size_t tile = head + (size_t)qt * kB * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float x = o[i][j] / l[i];
      const size_t at = tile + (size_t)r * kD + tx + 16 * j;
      out[at] = from_float<T>(x);
      if (out32 != nullptr) out32[at] = x;
    }
    if (tx == 0) lse[(size_t)bh * S + qt * kB + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward

// delta[row] = sum_d dout[row, d] * out[row, d] in fp32 (out is the
// forward's fp32 output); one warp per row.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
sattn_delta_kernel(const float* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ delta, size_t rows) {
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float d = 0.f;
  for (int c = lane * 4; c < kD; c += 128) {
    float a[4], b[4];
    load4(out + row * kD + c, a);
    load4(dout + row * kD + c, b);
    d += a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  if (lane == 0) delta[row] = d;
}

// dK, dV: one block per (K tile, batch * head), looping over q tiles.
template <typename T, int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
sattn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ seed, T* __restrict__ dk,
                      T* __restrict__ dv, int S, float scale,
                      uint32_t threshold, float inv) {
  constexpr int kTile = Dims<kD>::kTile, kN = Dims<kD>::kN;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile;
  float* sQ = sV + kTile;
  float* sO = sQ + kTile;   // dout tile
  float* sP = sO + kTile;   // [c, r] = pd^T of this q tile
  float* sS = sP + kSq;     // [c, r] = ds^T
  float* sL = sS + kSq;     // lse of the q tile's rows
  float* sD = sL + kB;      // delta of the q tile's rows
  const int nt = S / kB;
  const int kt = blockIdx.x;  // causal: tile kt loops nt - kt times
  const int bh = blockIdx.y;
  const size_t head = (size_t)bh * S * kD;
  const size_t rowh = (size_t)bh * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool dropout = seed != nullptr;
  const uint32_t per =
      dropout ? (uint32_t)seed[0] + (uint32_t)bh * 747796405u : 0u;

  load_tile<kD>(sK, k + head + (size_t)kt * kB * kD);
  load_tile<kD>(sV, v + head + (size_t)kt * kB * kD);
  float gk[4][kN] = {}, gv[4][kN] = {};

  for (int qt = kCausal ? kt : 0; qt < nt; ++qt) {
    __syncthreads();
    load_tile<kD>(sQ, q + head + (size_t)qt * kB * kD);
    load_tile<kD>(sO, dout + head + (size_t)qt * kB * kD);
    if (threadIdx.x < kB) {
      sL[threadIdx.x] = lse[rowh + qt * kB + threadIdx.x];
      sD[threadIdx.x] = delta[rowh + qt * kB + threadIdx.x];
    }
    __syncthreads();
    // s^T and dp^T for K rows c = ty + 16 i and q rows r = tx + 16 j
    float st[4][4] = {}, dpt[4][4] = {};
    dot_tiles<kD>(sK, sQ, st, ty, tx);
    dot_tiles<kD>(sV, sO, dpt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = kt * kB + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = tx + 16 * j;
        const int r = qt * kB + rr;
        const float p = (kCausal && c > r)
                            ? 0.f
                            : expf(st[i][j] * scale - sL[rr]);
        float pd = p, dp = dpt[i][j];
        if (dropout) {
          const bool kept = keep_elem(per, r, c, S, threshold);
          pd = kept ? p * inv : 0.f;
          dp = kept ? dp * inv : 0.f;
        }
        sP[(ty + 16 * i) * kLT + rr] = pd;
        sS[(ty + 16 * i) * kLT + rr] = p * (dp - sD[rr]) * scale;
      }
    }
    __syncthreads();
    mul_tiles<kD>(sP, sO, gv, ty, tx);  // dv += pd^T @ dout
    mul_tiles<kD>(sS, sQ, gk, ty, tx);  // dk += ds^T @ q
  }
  store_rows<kD>(dv + head + (size_t)kt * kB * kD, gv, ty, tx);
  store_rows<kD>(dk + head + (size_t)kt * kB * kD, gk, ty, tx);
}

// dQ: one block per (q tile, batch * head), looping over K tiles.
template <typename T, int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
sattn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seed, T* __restrict__ dq, int S,
                    float scale, uint32_t threshold, float inv) {
  constexpr int kTile = Dims<kD>::kTile, kN = Dims<kD>::kN;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kTile;
  float* sK = sO + kTile;
  float* sV = sK + kTile;
  float* sS = sV + kTile;  // [r, c] = ds
  float* sL = sS + kSq;
  float* sD = sL + kB;
  const int nt = S / kB;
  const int qt = nt - 1 - blockIdx.x;  // longest causal loops first
  const int bh = blockIdx.y;
  const size_t head = (size_t)bh * S * kD;
  const size_t rowh = (size_t)bh * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool dropout = seed != nullptr;
  const uint32_t per =
      dropout ? (uint32_t)seed[0] + (uint32_t)bh * 747796405u : 0u;

  load_tile<kD>(sQ, q + head + (size_t)qt * kB * kD);
  load_tile<kD>(sO, dout + head + (size_t)qt * kB * kD);
  if (threadIdx.x < kB) {
    sL[threadIdx.x] = lse[rowh + qt * kB + threadIdx.x];
    sD[threadIdx.x] = delta[rowh + qt * kB + threadIdx.x];
  }
  float gq[4][kN] = {};

  const int nk = kCausal ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<kD>(sK, k + head + (size_t)kt * kB * kD);
    load_tile<kD>(sV, v + head + (size_t)kt * kB * kD);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_tiles<kD>(sQ, sK, s, ty, tx);
    dot_tiles<kD>(sO, sV, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty + 16 * i;
      const int r = qt * kB + ri;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kt * kB + tx + 16 * j;
        const float p = (kCausal && c > r)
                            ? 0.f
                            : expf(s[i][j] * scale - sL[ri]);
        float d = dp[i][j];
        if (dropout)
          d = keep_elem(per, r, c, S, threshold) ? d * inv : 0.f;
        sS[ri * kLT + tx + 16 * j] = p * (d - sD[ri]) * scale;
      }
    }
    __syncthreads();
    mul_tiles<kD>(sS, sK, gq, ty, tx);  // dq += ds @ k
  }
  store_rows<kD>(dq + head + (size_t)qt * kB * kD, gq, ty, tx);
}

// ---------------------------------------------------------------------------
// launchers

template <int kD>
struct Smem {
  static constexpr size_t kFwd = sizeof(float) * (3 * Dims<kD>::kTile + kSq);
  static constexpr size_t kDkdv =
      sizeof(float) * (4 * Dims<kD>::kTile + 2 * kSq + 2 * kB);
  static constexpr size_t kDq =
      sizeof(float) * (4 * Dims<kD>::kTile + kSq + 2 * kB);
};

struct FwdArgs {
  const void *q, *k, *v;
  const int* seed;
  void* out;
  float *out32, *lse;
  int BH, S;
  float scale;
  uint32_t threshold;
  float inv;
  cudaStream_t stream;
};

template <typename T, int kD, bool kCausal>
cudaError_t fwd(const FwdArgs& a) {
  auto kernel = sattn_fwd_kernel<T, kD, kCausal>;
  constexpr size_t smem = Smem<kD>::kFwd;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.S / kB, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seed, static_cast<T*>(a.out), a.out32,
      a.lse, a.S, a.scale, a.threshold, a.inv);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *q, *k, *v;
  const float* out32;
  const void* dout;
  const float* lse;
  const int* seed;
  float* delta;
  void *dq, *dk, *dv;
  int BH, S;
  float scale;
  uint32_t threshold;
  float inv;
  cudaStream_t stream;
};

template <typename T, int kD, bool kCausal>
cudaError_t bwd(const BwdArgs& a) {
  const size_t rows = (size_t)a.BH * a.S;
  const int per = kThreads / 32;
  sattn_delta_kernel<T, kD><<<(unsigned)((rows + per - 1) / per), kThreads,
                              0, a.stream>>>(
      a.out32, static_cast<const T*>(a.dout), a.delta, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dkdv = sattn_bwd_dkdv_kernel<T, kD, kCausal>;
  constexpr size_t smem_kv = Smem<kD>::kDkdv;
  e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(a.S / kB, a.BH), kThreads, smem_kv, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.seed, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S,
      a.scale, a.threshold, a.inv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dq = sattn_bwd_dq_kernel<T, kD, kCausal>;
  constexpr size_t smem_q = Smem<kD>::kDq;
  e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return e;
  dq<<<dim3(a.S / kB, a.BH), kThreads, smem_q, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.seed, static_cast<T*>(a.dq), a.S, a.scale, a.threshold,
      a.inv);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t fwd_by_causal(const FwdArgs& a, int causal) {
  return causal ? fwd<T, kD, true>(a) : fwd<T, kD, false>(a);
}

template <typename T, int kD>
cudaError_t bwd_by_causal(const BwdArgs& a, int causal) {
  return causal ? bwd<T, kD, true>(a) : bwd<T, kD, false>(a);
}

template <typename T>
cudaError_t fwd_by_dim(const FwdArgs& a, int D, int causal) {
  return D == 64 ? fwd_by_causal<T, 64>(a, causal)
                 : fwd_by_causal<T, 128>(a, causal);
}

template <typename T>
cudaError_t bwd_by_dim(const BwdArgs& a, int D, int causal) {
  return D == 64 ? bwd_by_causal<T, 64>(a, causal)
                 : bwd_by_causal<T, 128>(a, causal);
}

}  // namespace

// Both launch on `stream`, whose device must be the calling thread's
// current one (the Python wrapper selects it), and return 0 on success,
// else the CUDA error code of the refused launch (cudaErrorInvalidValue for
// a shape or dtype these kernels do not take).  dtype code: 0 = float32,
// 1 = bfloat16, the same for every q/k/v/out/dout/dq/dk/dv.  Layout
// [BH, S, D] contiguous, D = 64 or 128; lse and delta [BH, S] fp32; `seed`
// one int32 on the device, read only when not null (null: no dropout);
// `out32`, the fp32 output, is null in the forward when `out` is itself
// fp32 (not written twice), and is read by the backward.  The backward's `delta` is scratch the caller
// allocates.
extern "C" int short_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* seed, void* out,
    void* out32, void* lse, int BH, int S, int D, float scale,
    unsigned int threshold, float inv, int causal, int dtype, void* stream) {
  if ((D != 64 && D != 128) || S <= 0 || S % kB || BH <= 0)
    return cudaErrorInvalidValue;
  const FwdArgs a{q,
                  k,
                  v,
                  static_cast<const int*>(seed),
                  out,
                  static_cast<float*>(out32),
                  static_cast<float*>(lse),
                  BH,
                  S,
                  scale,
                  threshold,
                  inv,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return fwd_by_dim<float>(a, D, causal);
  if (dtype == 1) return fwd_by_dim<__nv_bfloat16>(a, D, causal);
  return cudaErrorInvalidValue;
}

extern "C" int short_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out32,
    const void* dout, const void* lse, const void* seed, void* delta,
    void* dq, void* dk, void* dv, int BH, int S, int D, float scale,
    unsigned int threshold, float inv, int causal, int dtype, void* stream) {
  if ((D != 64 && D != 128) || S <= 0 || S % kB || BH <= 0 || !out32)
    return cudaErrorInvalidValue;
  const BwdArgs a{q,
                  k,
                  v,
                  static_cast<const float*>(out32),
                  dout,
                  static_cast<const float*>(lse),
                  static_cast<const int*>(seed),
                  static_cast<float*>(delta),
                  dq,
                  dk,
                  dv,
                  BH,
                  S,
                  scale,
                  threshold,
                  inv,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return bwd_by_dim<float>(a, D, causal);
  if (dtype == 1) return bwd_by_dim<__nv_bfloat16>(a, D, causal);
  return cudaErrorInvalidValue;
}
