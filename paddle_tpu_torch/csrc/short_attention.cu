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
// The mask is integer work besides: about 10 instructions per score (3
// multiplies), 8.5e7 scores per pass at that shape.
//
// The TPU kernel keeps one head's whole [S, S] score matrix in VMEM; S =
// 1024 fp32 scores are 4 MB and a Hopper block has at most 227 KB of
// shared memory.  So both families below are flash-style: q tiles against
// K/V tiles with an fp32 online softmax whose sum l takes the undropped
// exponentials; the mask and 1/keep multiply only the numerator, and the
// epilogue divides by l (the TPU's p = e / l followed by the mask, in
// another rounding order).  Two families, chosen by dtype (one kernel per
// case, no fallback between them):
//
// 1. bf16: the tensor-core kernels (wg::sattn_*_wg_kernel), the design of
//    long_attention.cu's attn_wg_* with the mask added.
//    * Forward: one block per (128-row q tile, batch * head); 384 threads,
//      two consumer warpgroups of 64 q rows (one wgmma m64 tile each) and a
//      producer warpgroup whose one thread issues every TMA load: Q once,
//      then K and V tiles (128 rows at D = 64, 64 at D = 128, where 128
//      would run a consumer out of registers) through a two-stage mbarrier
//      ring.  S = Q.K^T by wgmma from shared memory; the online softmax in
//      registers with exp2f.  Causal: K tiles above the diagonal are
//      never loaded, and only diagonal tiles are masked, with -1e30 as the
//      plain version.
//    * The mask in the forward and dQ: a thread hashes the global (row,
//      col) of each accumulator element it holds: d[4 j + e] of an m64nN
//      sum is row r0 + 8 (e >> 1), column 8 j + 2 t + (e & 1) of the tile.
//      The numerator e * M / keep enters wgmma as two bf16 terms, hi =
//      bf16(x) and lo = bf16(x - hi), each its own product against V read
//      MN-major; rounded once, early causal rows leave the tolerances.
//    * Backward: a small kernel forms delta = rowsum(g * out32) from the
//      forward's fp32 output (from the bf16 one it would miss the TPU's
//      rowsum(dp * p) by a rounding of out), then a dK/dV pass and a dQ
//      pass, deterministic: no atomics, every output written once.  dK/dV:
//      one block per 64 K rows, looping over 64-row q tiles; warpgroup 0
//      sums dV (S^T = K.Q^T, dV += pd^T.dO), warpgroup 1 sums dK (S^T,
//      dP^T = V.dO^T, dK += dS^T.Q).  Both hold the same elements of S^T
//      in the same registers, so warpgroup 0 hashes each score once, while
//      its S^T product runs, and hands its 32 keep bits per thread to the
//      same thread of warpgroup 1 as one word in shared memory (an
//      mbarrier per ring stage says the words are written).  dQ: one block
//      per 128 q rows, looping over 64-row K/V tiles: S, dP = dO.V^T,
//      dQ += dS.K, dS as hi + lo.
//    * Head dims: a [rows, D] tile is D / 64 swizzled regions of 128-byte
//      rows (one at D = 64, two at D = 128).  Shared memory (+ 1 KB to
//      align tiles): forward Q + 2 x (K + V) = 80 KB at D = 64, 96 KB at
//      D = 128; dK/dV 50 / 98 KB; dQ 64 / 128 KB.
//    * Products: the forward runs 3 where the bound counts 2 (P as hi +
//      lo), the backward 11 where it counts 5 (S^T twice, pd and dS as
//      hi + lo, S and dP again in the dQ pass).
// 2. fp32: the fp32-core kernels of the first port (sattn_*_kernel),
//    exact for fp32 (the card-vs-CPU fp32 BERT parity runs through them).
//    64-row q tiles against 64-row K/V tiles in padded fp32 shared memory
//    (stride D + 1, free of bank conflicts), 256 threads each owning a
//    4 x 4 block of scores, a dK/dV pass over K tiles and a dQ pass over
//    q tiles (seven products instead of five, no atomics).
// S must be a multiple of 128 (the tensor-core tiles; the route sends
// nothing else).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

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

// The TPU kernel's keep decision for hash input x = row * S + col + seed +
// bh * 747796405 (uint32, wrapped): the murmur3 finalizer, below threshold.
__device__ __forceinline__ bool kept(uint32_t x, uint32_t threshold) {
  x *= 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < threshold;
}

// The keep decision for element (row, col) of one head's [S, S] matrix;
// `per` is seed + bh * 747796405, wrapped.
__device__ __forceinline__ bool keep_elem(uint32_t per, int row, int col,
                                          int S, uint32_t threshold) {
  return kept((uint32_t)row * (uint32_t)S + (uint32_t)col + per, threshold);
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
template <int kD>
__device__ __forceinline__ void load_tile(float* dst, const float* src) {
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
template <int kD>
__device__ __forceinline__ void store_rows(float* dst,
                                           float acc[4][Dims<kD>::kN],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Dims<kD>::kN; ++j)
      dst[(size_t)(ty + 16 * i) * kD + tx + 16 * j] = acc[i][j];
}

// ---------------------------------------------------------------------------
// fp32 forward: one block per (q tile, batch * head)

template <int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
sattn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seed,
                 float* __restrict__ out, float* __restrict__ out32,
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
      out[at] = x;
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
template <int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
sattn_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ seed, float* __restrict__ dk,
                      float* __restrict__ dv, int S, float scale,
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
template <int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
sattn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seed, float* __restrict__ dq,
                    int S,
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

template <int kD, bool kCausal>
cudaError_t fp32_fwd(const FwdArgs& a) {
  auto kernel = sattn_fwd_kernel<kD, kCausal>;
  constexpr size_t smem = Smem<kD>::kFwd;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.S / kB, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.seed, static_cast<float*>(a.out),
      a.out32, a.lse, a.S, a.scale, a.threshold, a.inv);
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

template <int kD, bool kCausal>
cudaError_t fp32_bwd(const BwdArgs& a) {
  const size_t rows = (size_t)a.BH * a.S;
  const int per = kThreads / 32;
  sattn_delta_kernel<float, kD><<<(unsigned)((rows + per - 1) / per),
                                  kThreads, 0, a.stream>>>(
      a.out32, static_cast<const float*>(a.dout), a.delta, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dkdv = sattn_bwd_dkdv_kernel<kD, kCausal>;
  constexpr size_t smem_kv = Smem<kD>::kDkdv;
  e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(a.S / kB, a.BH), kThreads, smem_kv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.seed, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.S, a.scale, a.threshold, a.inv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dq = sattn_bwd_dq_kernel<kD, kCausal>;
  constexpr size_t smem_q = Smem<kD>::kDq;
  e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return e;
  dq<<<dim3(a.S / kB, a.BH), kThreads, smem_q, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.seed, static_cast<float*>(a.dq), a.S, a.scale,
      a.threshold, a.inv);
  return cudaGetLastError();
}

template <int kD>
cudaError_t fp32_fwd_by_causal(const FwdArgs& a, int causal) {
  return causal ? fp32_fwd<kD, true>(a) : fp32_fwd<kD, false>(a);
}

template <int kD>
cudaError_t fp32_bwd_by_causal(const BwdArgs& a, int causal) {
  return causal ? fp32_bwd<kD, true>(a) : fp32_bwd<kD, false>(a);
}

// ===========================================================================
// Hopper tensor-core kernels: bf16

namespace wg {

using namespace hopper;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;  // two consumer warpgroups + producer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg = -1e30f;  // the plain version's causal mask value

constexpr int kFM = 128;             // forward: q rows per tile
constexpr int kBN = 64, kBM = 64;    // dK/dV: kv rows, q rows per tile
constexpr int kQM = 128, kQN = 64;   // dQ: q rows, kv rows per tile
constexpr int kStages = 2;           // ring depth of the streamed tiles
constexpr int kMaskWords = 128;      // dK/dV: one per consumer thread

template <int kD>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * kD * 2;
}

// The forward's K/V rows per tile: 128 at D = 64; 64 at D = 128, where a
// consumer holding 128-column scores, their P fragments and the [64, 128]
// sum runs out of registers and ptxas serializes the wgmmas (C7512).
template <int kD>
__host__ __device__ constexpr int fwd_kv_rows() {
  return kD == 64 ? 128 : 64;
}

template <int kD>
constexpr int fwd_smem() {
  return 1024 + tile_bytes<kD>(kFM) +
         2 * kStages * tile_bytes<kD>(fwd_kv_rows<kD>()) +
         8 * (1 + 4 * kStages);
}
template <int kD>
constexpr int dkdv_smem() {
  return 1024 + 2 * tile_bytes<kD>(kBN) +
         kStages * (2 * tile_bytes<kD>(kBM) + 2 * kBM * 4 + kMaskWords * 4) +
         8 * (1 + 3 * kStages);
}
template <int kD>
constexpr int dq_smem() {
  return 1024 + 2 * tile_bytes<kD>(kQM) + 2 * kStages * tile_bytes<kD>(kQN) +
         8 * (1 + 2 * kStages);
}

// Rows [row, row + rows) of a [*, D] tensor, as D / 64 swizzled regions.
template <int kD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* b, int row, int rows) {
#pragma unroll
  for (int r = 0; r < kD / 64; ++r)
    tma_2d(dst + r * rows * kRow, map, b, 64 * r, row);
}

// d += A * B, A from registers, B MN-major with N = D (64 or 128).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  wgmma_rs_n64t(d, a, b);
}
__device__ __forceinline__ void wgmma_rs_t(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  wgmma_rs_n128t(d, a, b);
}

// The hash offset of one head: seed + bh * 747796405, wrapped (0 without
// dropout, when `seed` is null).
__device__ __forceinline__ uint32_t head_offset(const int* seed, int bh) {
  return seed != nullptr ? (uint32_t)seed[0] + (uint32_t)bh * 747796405u
                         : 0u;
}

// A consumer thread's place in an m64 accumulator: rows `row` and row + 8
// of its warpgroup's 64, columns 8 j + 2 t (+1); d[4 j + e] is (row + 8
// (e >> 1), 8 j + 2 t + (e & 1)), and the A fragment of k step kk takes
// d[8 kk .. 8 kk + 7] in that order.

// Store a warpgroup's [64, D] fp32 sum as bf16 rows r0 and r0 + 8.
template <int kD>
__device__ __forceinline__ void store_rows(bf16* dst0,
                                           const float (&d)[kD / 2]) {
  bf16* dst1 = dst0 + 8 * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * j) =
        __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * j) =
        __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (128-row q tile, batch * head)

template <int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
sattn_fwd_wg_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const int* __restrict__ seed, bf16* __restrict__ out,
                    float* __restrict__ out32, float* __restrict__ lse,
                    int S, float scale, uint32_t threshold, float inv) {
  constexpr int kFN = fwd_kv_rows<kD>();
  constexpr int kTq = tile_bytes<kD>(kFM), kTkv = tile_bytes<kD>(kFN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + kTq;
  uint8_t* sV = sK + kStages * kTkv;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kTkv);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int qt = S / kFM - 1 - blockIdx.x;  // longest causal loops first
  const int bh = blockIdx.y;
  const int nk = kCausal ? (qt + 1) * kFM / kFN : S / kFN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full + s, 1);
      bar_init(v_full + s, 1);
      bar_init(k_empty + s, 8);
      bar_init(v_empty + s, 8);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (role == 2) {  // producer warpgroup: one thread issues the loads
    regs_producer();
    if (threadIdx.x == 256) {
      const int row = bh * S;
      bar_expect(q_full, kTq);
      load_tile<kD>(sQ, &tq, q_full, row + qt * kFM, kFM);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        if (i >= kStages) bar_wait(k_empty + s, ph ^ 1);
        bar_expect(k_full + s, kTkv);
        load_tile<kD>(sK + s * kTkv, &tk, k_full + s, row + i * kFN, kFN);
        if (i >= kStages) bar_wait(v_empty + s, ph ^ 1);
        bar_expect(v_full + s, kTkv);
        load_tile<kD>(sV + s * kTkv, &tv, v_full + s, row + i * kFN, kFN);
      }
    }
  } else {  // consumer warpgroups 0 and 1
    regs_consumer();
    const int wgi = warp / 4, t = lane % 4;
    const int r0 = qt * kFM + wgi * 64 + (warp % 4) * 16 + lane / 4;
    const float sl2 = scale * kLog2e;
    const bool dropout = seed != nullptr;
    // hash inputs of (r0, 2 t) and (r0 + 8, 2 t); column c adds c
    const uint32_t x0 =
        (uint32_t)r0 * (uint32_t)S + 2 * t + head_offset(seed, bh);
    const uint32_t x8 = x0 + 8u * (uint32_t)S;
    const uint8_t* qa = sQ + wgi * 64 * kRow;
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    bar_wait(q_full, 0);
    __syncwarp();

    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint8_t* kb = sK + s * kTkv;
      const uint8_t* vb = sV + s * kTkv;
      float sc[kFN / 2];
      bar_wait(k_full + s, ph);
      __syncwarp();
      wg_fence();
      const uint64_t q_km = kdesc(qa), k_km = kdesc(kb);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(sc, q_km + kstep(kFM, kk), k_km + kstep(kFN, kk), kk);
      wg_commit();
      wg_wait0();
      fence_regs(sc);
      release(k_empty + s, lane);

      // online softmax in log2 units
      const int c0 = i * kFN;
      const bool edge = kCausal && c0 + kFN - 1 > qt * kFM;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kFN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * sl2;
          if (edge && c0 + 8 * j + 2 * t + (e & 1) > r0 + 8 * (e >> 1))
            x = kNeg;
          sc[4 * j + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);  // 0 at first
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
      // l sums the undropped exponentials; e * M / keep enters P.V
      uint32_t phi[kFN / 16][4], plo[kFN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFN / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = 2 * kk + (f >> 1), e = (f & 1) * 2;
          const float m = e ? m1 : m0;
          float p0 = exp2f(sc[4 * j + e] - m);
          float p1 = exp2f(sc[4 * j + e + 1] - m);
          if (e)
            l1 += p0 + p1;
          else
            l0 += p0 + p1;
          if (dropout) {
            const uint32_t x = (e ? x8 : x0) + c0 + 8 * j;
            p0 = kept(x, threshold) ? p0 * inv : 0.f;
            p1 = kept(x + 1, threshold) ? p1 * inv : 0.f;
          }
          split_bf16(p0, p1, phi[kk][f], plo[kk][f]);
        }
      }
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }

      bar_wait(v_full + s, ph);
      __syncwarp();
      wg_fence();
      const uint64_t v_mn = tdesc(vb, kFN);
#pragma unroll
      for (int kk = 0; kk < kFN / 16; ++kk) {
        wgmma_rs_t(o, phi[kk], v_mn + tstep(kk));
        wgmma_rs_t(o, plo[kk], v_mn + tstep(kk));
      }
      wg_commit();
      wg_wait0();
      fence_regs(o);
      release(v_empty + s, lane);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float s0 = 1.f / l0, s1 = 1.f / l1;
    const size_t at = ((size_t)bh * S + r0) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const float2 v0 = make_float2(o[4 * j] * s0, o[4 * j + 1] * s0);
      const float2 v1 = make_float2(o[4 * j + 2] * s1, o[4 * j + 3] * s1);
      *reinterpret_cast<float2*>(out32 + at + 8 * j) = v0;
      *reinterpret_cast<float2*>(out32 + at + 8 * kD + 8 * j) = v1;
      *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * j) =
          __float22bfloat162_rn(v0);
      *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * kD + 8 * j) =
          __float22bfloat162_rn(v1);
    }
    if (t == 0) {
      lse[(size_t)bh * S + r0] = (m0 + log2f(l0)) * kLn2;
      lse[(size_t)bh * S + r0 + 8] = (m1 + log2f(l1)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (64 K rows, batch * head); loops over
// the 64-row q tiles (causal: those at or below the diagonal).  Warpgroup
// 0 sums dV and hashes the mask, warpgroup 1 sums dK and reads it.

template <int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
sattn_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seed, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int S, float scale,
                         uint32_t threshold, float inv) {
  constexpr int kTkv = tile_bytes<kD>(kBN), kTq = tile_bytes<kD>(kBM);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + kTkv;
  uint8_t* sQ = sV + kTkv;             // kStages tiles
  uint8_t* sO = sQ + kStages * kTq;    // dout, kStages tiles
  float* sL = reinterpret_cast<float*>(sO + kStages * kTq);
  float* sD = sL + kStages * kBM;
  uint32_t* sM = reinterpret_cast<uint32_t*>(sD + kStages * kBM);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sM + kStages * kMaskWords);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* mask_full = empty + kStages;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = kCausal ? kt * kBN / kBM : 0;
  const int n = S / kBM - q0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);
      bar_init(mask_full + s, kMaskWords);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (role == 2) {  // producer warpgroup: one thread issues the loads
    regs_producer();
    if (threadIdx.x == 256) {
      bar_expect(kv_full, 2 * kTkv);
      load_tile<kD>(sK, &tk, kv_full, bh * S + kt * kBN, kBN);
      load_tile<kD>(sV, &tv, kv_full, bh * S + kt * kBN, kBN);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int row = bh * S + (q0 + i) * kBM;
        if (i >= kStages) bar_wait(empty + s, ph ^ 1);
        bar_expect(full + s, 2 * kTq + 2 * kBM * 4);
        load_tile<kD>(sQ + s * kTq, &tq, full + s, row, kBM);
        load_tile<kD>(sO + s * kTq, &tdo, full + s, row, kBM);
        bulk_copy(sL + s * kBM, lse + row, kBM * 4, full + s);
        bulk_copy(sD + s * kBM, delta + row, kBM * 4, full + s);
      }
    }
  } else {  // consumer warpgroups: 0 sums dV, 1 sums dK
    regs_consumer();
    const bool sums_dk = role == 1;
    const int t = lane % 4, wt = threadIdx.x % 128;
    const int c0 = kt * kBN + (warp % 4) * 16 + lane / 4;  // K position
    const float sl2 = scale * kLog2e;
    const bool dropout = seed != nullptr;
    // hash input of (q row 2 t, K column c0); q row r adds r * S
    const uint32_t x0 =
        2u * t * (uint32_t)S + (uint32_t)c0 + head_offset(seed, bh);
    const uint64_t k_km = kdesc(sK), v_km = kdesc(sV);
    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    bar_wait(kv_full, 0);
    __syncwarp();

    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int qp = (q0 + i) * kBM;  // first q position of the tile
      const uint8_t* qb = sQ + s * kTq;
      const uint8_t* ob = sO + s * kTq;
      const float* L = sL + s * kBM;
      const float* Dl = sD + s * kBM;
      float st[kBM / 2], dpt[kBM / 2];  // S^T, dP^T: rows K, columns q
      bar_wait(full + s, ph);
      __syncwarp();
      const uint64_t q_km = kdesc(qb), o_km = kdesc(ob);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(st, k_km + kstep(kBN, kk), q_km + kstep(kBM, kk), kk);
      if (sums_dk) {
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_ss(dpt, v_km + kstep(kBN, kk), o_km + kstep(kBM, kk), kk);
      }
      wg_commit();
      // keep bit 4 j + e of S^T element d[4 j + e]: K row c0 + 8 (e >> 1),
      // q row qp + 8 j + 2 t + (e & 1); hashed by warpgroup 0 while its
      // product runs, read by warpgroup 1 from the same thread's word
      uint32_t bits = ~0u;
      if (dropout && !sums_dk) {
        const uint32_t x = x0 + (uint32_t)qp * (uint32_t)S;
        bits = 0u;
#pragma unroll
        for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            bits |= (uint32_t)kept(x + (8 * j + (e & 1)) * (uint32_t)S +
                                       8 * (e >> 1),
                                   threshold)
                    << (4 * j + e);
        sM[s * kMaskWords + wt] = bits;
        bar_arrive(mask_full + s);
      }
      wg_wait0();
      fence_regs(st);
      if (sums_dk) fence_regs(dpt);
      if (dropout && sums_dk) {
        bar_wait(mask_full + s, ph);
        bits = sM[s * kMaskWords + wt];
      }

      // pd^T (dV) or dS^T (dK) as bf16 hi + lo A fragments
      const bool edge = kCausal && qp < kt * kBN + kBN - 1;
      uint32_t hi[kBM / 16][4], lo[kBM / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = 2 * kk + (f >> 1), e = (f & 1) * 2;
          const int qc = 8 * j + 2 * t;
          const int kp = c0 + 8 * (e >> 1);
          const float2 lv = *reinterpret_cast<const float2*>(L + qc);
          float p0 = exp2f(st[4 * j + e] * sl2 - lv.x * kLog2e);
          float p1 = exp2f(st[4 * j + e + 1] * sl2 - lv.y * kLog2e);
          if (edge && kp > qp + qc) p0 = 0.f;
          if (edge && kp > qp + qc + 1) p1 = 0.f;
          const float k0 = (bits >> (4 * j + e)) & 1u ? inv : 0.f;
          const float k1 = (bits >> (4 * j + e + 1)) & 1u ? inv : 0.f;
          if (sums_dk) {
            const float2 dl = *reinterpret_cast<const float2*>(Dl + qc);
            p0 *= (dpt[4 * j + e] * k0 - dl.x) * scale;
            p1 *= (dpt[4 * j + e + 1] * k1 - dl.y) * scale;
          } else {
            p0 *= k0;
            p1 *= k1;
          }
          split_bf16(p0, p1, hi[kk][f], lo[kk][f]);
        }
      }
      const uint64_t b_mn = tdesc(sums_dk ? qb : ob, kBM);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) {
        wgmma_rs_t(acc, hi[kk], b_mn + tstep(kk));
        wgmma_rs_t(acc, lo[kk], b_mn + tstep(kk));
      }
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      release(empty + s, lane);
    }

    store_rows<kD>((sums_dk ? dk : dv) + ((size_t)bh * S + c0) * kD + 2 * t,
                   acc);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: one block per (128-row q tile, batch * head); loops over
// 64-row K/V tiles

template <int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
sattn_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ seed, bf16* __restrict__ dq,
                       int S, float scale, uint32_t threshold, float inv) {
  constexpr int kTq = tile_bytes<kD>(kQM), kTkv = tile_bytes<kD>(kQN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sO = sQ + kTq;
  uint8_t* sK = sO + kTq;              // kStages tiles
  uint8_t* sV = sK + kStages * kTkv;   // kStages tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kTkv);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int qt = S / kQM - 1 - blockIdx.x;  // longest causal loops first
  const int bh = blockIdx.y;
  const int nk = kCausal ? (qt + 1) * kQM / kQN : S / kQN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (role == 2) {  // producer warpgroup: one thread issues the loads
    regs_producer();
    if (threadIdx.x == 256) {
      const int row = bh * S;
      bar_expect(q_full, 2 * kTq);
      load_tile<kD>(sQ, &tq, q_full, row + qt * kQM, kQM);
      load_tile<kD>(sO, &tdo, q_full, row + qt * kQM, kQM);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        if (i >= kStages) bar_wait(empty + s, ph ^ 1);
        bar_expect(full + s, 2 * kTkv);
        load_tile<kD>(sK + s * kTkv, &tk, full + s, row + i * kQN, kQN);
        load_tile<kD>(sV + s * kTkv, &tv, full + s, row + i * kQN, kQN);
      }
    }
  } else {  // consumer warpgroups 0 and 1
    regs_consumer();
    const int wgi = warp / 4, t = lane % 4;
    const int r0 = qt * kQM + wgi * 64 + (warp % 4) * 16 + lane / 4;
    const size_t rb = (size_t)bh * S;
    const float sl2 = scale * kLog2e;
    const bool dropout = seed != nullptr;
    const uint32_t x0 =
        (uint32_t)r0 * (uint32_t)S + 2 * t + head_offset(seed, bh);
    const uint32_t x8 = x0 + 8u * (uint32_t)S;
    const float L0 = lse[rb + r0] * kLog2e, L1 = lse[rb + r0 + 8] * kLog2e;
    const float D0 = delta[rb + r0], D1 = delta[rb + r0 + 8];
    const uint8_t* qa = sQ + wgi * 64 * kRow;
    const uint8_t* oa = sO + wgi * 64 * kRow;
    float gq[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) gq[i] = 0.f;
    bar_wait(q_full, 0);
    __syncwarp();

    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint8_t* kb = sK + s * kTkv;
      const uint8_t* vb = sV + s * kTkv;
      float sc[kQN / 2], dp[kQN / 2];
      bar_wait(full + s, ph);
      __syncwarp();
      wg_fence();
      const uint64_t q_km = kdesc(qa), o_km = kdesc(oa);
      const uint64_t k_km = kdesc(kb), v_km = kdesc(vb);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(sc, q_km + kstep(kQM, kk), k_km + kstep(kQN, kk), kk);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(dp, o_km + kstep(kQM, kk), v_km + kstep(kQN, kk), kk);
      wg_commit();
      wg_wait0();
      fence_regs(sc);
      fence_regs(dp);

      const int c0 = i * kQN;
      const bool edge = kCausal && c0 + kQN - 1 > qt * kQM;
      uint32_t shi[kQN / 16][4], slo[kQN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQN / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = 2 * kk + (f >> 1), e = (f & 1) * 2;
          const int c = c0 + 8 * j + 2 * t, r = r0 + 8 * (e >> 1);
          const float L = e ? L1 : L0, Dr = e ? D1 : D0;
          float p0 = exp2f(sc[4 * j + e] * sl2 - L);
          float p1 = exp2f(sc[4 * j + e + 1] * sl2 - L);
          if (edge && c > r) p0 = 0.f;
          if (edge && c + 1 > r) p1 = 0.f;
          float d0 = dp[4 * j + e], d1 = dp[4 * j + e + 1];
          if (dropout) {
            const uint32_t x = (e ? x8 : x0) + c0 + 8 * j;
            d0 = kept(x, threshold) ? d0 * inv : 0.f;
            d1 = kept(x + 1, threshold) ? d1 * inv : 0.f;
          }
          split_bf16(p0 * (d0 - Dr) * scale, p1 * (d1 - Dr) * scale,
                     shi[kk][f], slo[kk][f]);
        }
      }
      wg_fence();
      const uint64_t k_mn = tdesc(kb, kQN);
#pragma unroll
      for (int kk = 0; kk < kQN / 16; ++kk) {
        wgmma_rs_t(gq, shi[kk], k_mn + tstep(kk));
        wgmma_rs_t(gq, slo[kk], k_mn + tstep(kk));
      }
      wg_commit();
      wg_wait0();
      fence_regs(gq);
      release(empty + s, lane);
    }

    store_rows<kD>(dq + (rb + r0) * kD + 2 * t, gq);
  }
}

// -- host: tensor maps and launches ----------------------------------------

// A [rows, D] bf16 tensor read in boxes of `box` rows x 64 columns.
bool make_map(CUtensorMap* map, const void* base, size_t rows, int D,
              int box) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t boxd[2] = {64, (cuuint32_t)box};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, boxd, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, bool kCausal>
cudaError_t fwd(const FwdArgs& a) {
  CUtensorMap mq, mk, mv;
  const size_t rows = (size_t)a.BH * a.S;
  if (!make_map(&mq, a.q, rows, kD, kFM) ||
      !make_map(&mk, a.k, rows, kD, fwd_kv_rows<kD>()) ||
      !make_map(&mv, a.v, rows, kD, fwd_kv_rows<kD>()))
    return cudaErrorNotSupported;
  auto kernel = sattn_fwd_wg_kernel<kD, kCausal>;
  constexpr int smem = fwd_smem<kD>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.S / kFM, a.BH), kThreads, smem, a.stream>>>(
      mq, mk, mv, a.seed, static_cast<bf16*>(a.out), a.out32, a.lse, a.S,
      a.scale, a.threshold, a.inv);
  return cudaGetLastError();
}

template <int kD, bool kCausal>
cudaError_t bwd(const BwdArgs& a) {
  const size_t rows = (size_t)a.BH * a.S;
  const int per = ::kThreads / 32;
  sattn_delta_kernel<bf16, kD>
      <<<(unsigned)((rows + per - 1) / per), ::kThreads, 0, a.stream>>>(
          a.out32, static_cast<const bf16*>(a.dout), a.delta, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, a.q, rows, kD, kBM) ||
      !make_map(&mk, a.k, rows, kD, kBN) ||
      !make_map(&mv, a.v, rows, kD, kBN) ||
      !make_map(&mo, a.dout, rows, kD, kBM))
    return cudaErrorNotSupported;
  auto dkdv = sattn_bwd_dkdv_wg_kernel<kD, kCausal>;
  constexpr int smem_kv = dkdv_smem<kD>();
  e = allow_smem(dkdv, smem_kv);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(a.S / kBN, a.BH), kThreads, smem_kv, a.stream>>>(
      mq, mk, mv, mo, a.lse, a.delta, a.seed, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, a.scale, a.threshold, a.inv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  if (!make_map(&mq, a.q, rows, kD, kQM) ||
      !make_map(&mk, a.k, rows, kD, kQN) ||
      !make_map(&mv, a.v, rows, kD, kQN) ||
      !make_map(&mo, a.dout, rows, kD, kQM))
    return cudaErrorNotSupported;
  auto dq = sattn_bwd_dq_wg_kernel<kD, kCausal>;
  constexpr int smem_q = dq_smem<kD>();
  e = allow_smem(dq, smem_q);
  if (e != cudaSuccess) return e;
  dq<<<dim3(a.S / kQM, a.BH), kThreads, smem_q, a.stream>>>(
      mq, mk, mv, mo, a.lse, a.delta, a.seed, static_cast<bf16*>(a.dq), a.S,
      a.scale, a.threshold, a.inv);
  return cudaGetLastError();
}

template <int kD>
cudaError_t fwd_by_causal(const FwdArgs& a, int causal) {
  return causal ? fwd<kD, true>(a) : fwd<kD, false>(a);
}

template <int kD>
cudaError_t bwd_by_causal(const BwdArgs& a, int causal) {
  return causal ? bwd<kD, true>(a) : bwd<kD, false>(a);
}

}  // namespace wg

}  // namespace

// Both launch on `stream`, whose device must be the calling thread's
// current one (the Python wrapper selects it), and return 0 on success,
// else the CUDA error code of the refused launch (cudaErrorInvalidValue for
// a shape or dtype these kernels do not take, cudaErrorNotSupported when a
// tensor map cannot be encoded).  dtype code: 0 = float32 (the fp32-core
// kernels), 1 = bfloat16 (the tensor-core kernels), the same for every
// q/k/v/out/dout/dq/dk/dv.  Layout [BH, S, D] contiguous, D = 64 or 128, S
// a multiple of 128; lse and delta [BH, S] fp32; `seed` one int32 on the
// device, read only when not null (null: no dropout); `out32`, the fp32
// output, is null in the forward when `out` is itself fp32 (not written
// twice), and is read by the backward.  The backward's `delta` is scratch
// the caller allocates.
extern "C" int short_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* seed, void* out,
    void* out32, void* lse, int BH, int S, int D, float scale,
    unsigned int threshold, float inv, int causal, int dtype, void* stream) {
  if ((D != 64 && D != 128) || S <= 0 || S % wg::kFM || BH <= 0 ||
      (dtype == 1 && !out32))
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
  if (dtype == 0)
    return D == 64 ? fp32_fwd_by_causal<64>(a, causal)
                   : fp32_fwd_by_causal<128>(a, causal);
  if (dtype == 1)
    return D == 64 ? wg::fwd_by_causal<64>(a, causal)
                   : wg::fwd_by_causal<128>(a, causal);
  return cudaErrorInvalidValue;
}

extern "C" int short_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out32,
    const void* dout, const void* lse, const void* seed, void* delta,
    void* dq, void* dk, void* dv, int BH, int S, int D, float scale,
    unsigned int threshold, float inv, int causal, int dtype, void* stream) {
  if ((D != 64 && D != 128) || S <= 0 || S % wg::kFM || BH <= 0 || !out32)
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
  if (dtype == 0)
    return D == 64 ? fp32_bwd_by_causal<64>(a, causal)
                   : fp32_bwd_by_causal<128>(a, causal);
  if (dtype == 1)
    return D == 64 ? wg::bwd_by_causal<64>(a, causal)
                   : wg::bwd_by_causal<128>(a, causal);
  return cudaErrorInvalidValue;
}
