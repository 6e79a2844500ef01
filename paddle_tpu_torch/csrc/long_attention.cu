// Causal (or full) attention, forward and backward, for Hopper (sm_90a),
// with a plain C interface, GQA and optional fused RoPE.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels/
// long_attention.py: _fwd_call (_fwd_kernel) and _bwd_call (_bwd_kernel),
// and serves the region paddle_tpu/ops/nn_ops.py sends to the stock
// Pallas flash kernel (_flash_attention_tpu: GQA, S > 2048, non-causal).
// Per (batch, q head h) with kv head h / G (G = H / Hkv q heads share one
// K/V head), q/k/v [S, D] (D = 128) and s = (q . k) * scale:
//
//     fwd:  lse = logsumexp_j s[i, j]  (j <= i when causal)   fp32
//           out = softmax(s) @ v                              q's dtype
//     bwd:  p  = exp(s - lse);  dp = dout @ v^T
//           ds = p * (dp - delta) * scale,  delta_i = sum_d dout * out
//           dv = p^T @ dout;  dq = ds @ k;  dk = ds^T @ q
//           (dk, dv of a kv head summed over its G q heads)
//
// Bound: operations.  The causal half of QK^T and PV is S^2 * D / 2
// multiply-adds per head and product: 1.37e11 flops in the forward at
// B=4, H=32, S=2048, D=128 (0.139 ms at 989 TFLOP/s bf16), five such
// products in the backward (0.347 ms).  The bytes (q, k, v, out once
// each, bf16) are 268 MB, 0.080 ms at 3.35 TB/s.
//
// Two families of kernels, chosen by dtype (one kernel per case, no
// fallback between them):
//
// 1. bf16 q/k/v without RoPE: the tensor-core kernels (wg::attn_wg_*), a
//    FlashAttention-3-shaped design.
//    * Work split.  Forward: one block per (128-row q tile, batch * q
//      head); 384 threads, three warpgroups: two consumers of 64 q rows
//      each (one wgmma m64 tile) and a producer whose one thread issues
//      every load.  setmaxnreg gives the producer 24 registers and each
//      consumer 240 (the block launches at 168).  Q tiles are numbered
//      so the longest causal loops start first.
//    * Loads.  TMA (tensor maps of [rows, 128] bf16, boxes of 64 columns
//      = 128-byte rows, 128-byte swizzle, so a tile is two regions): Q
//      once, then K and V tiles of 128 rows into a ring of two
//      buffers, each guarded by a full and an empty mbarrier (K and V
//      apart, so Q.K^T starts before V lands).  The tensor maps are
//      encoded on the host by cuTensorMapEncodeTiled, reached through
//      cudaGetDriverEntryPoint(ByVersion): the library is loaded with
//      ctypes and not linked against -lcuda.
//    * S = Q.K^T: wgmma m64n128k16, both operands in shared memory
//      (K-major), fp32 sums in registers.
//    * Softmax: online, in registers (running max and sum per row, the
//      sum reduced across the row's four lanes once at the end), exp2f
//      with scale * log2(e) folded in.  Causal: K tiles wholly above the
//      diagonal are never loaded; only diagonal tiles are masked, with
//      the TPU kernel's mask value (-2.3819763e38).
//    * O += P.V: P stays in registers as wgmma's A operand (the fp32
//      accumulator's layout is the bf16 A fragment's, two columns per
//      register), V is read from shared memory MN-major (transposed B).
//    * The rounding point.  P is carried as two bf16 terms, hi = bf16(p)
//      and lo = bf16(p - hi), each its own product (about 16 bits of p),
//      never rounded once; the backward carries P and dS the same way.
//      Rounded once (2^-8 relative), out, dq, dk and dv leave the
//      tolerances the kernels are held to in causal cases (early rows
//      average few keys); paddle_tpu_torch/testing/attention_rounding.py
//      shows it on the card.
//    * Backward: a small kernel forms delta = rowsum(dout * out) (the
//      port's delta rule), then a dK/dV pass and a dQ pass.  dK/dV: one
//      block per 64 K rows and kv head, looping over the group's q heads
//      and their 64-row q tiles at or below the diagonal, streamed with
//      their lse and delta rows by TMA.  Warpgroup 0 sums dV (S^T =
//      K.Q^T, dV += P^T.dO), warpgroup 1 sums dK (S^T, dP^T = V.dO^T,
//      dK += dS^T.Q): one 64-register fp32 sum per warpgroup.  Both sums
//      in one warpgroup (128 of its registers) made ptxas serialize
//      the wgmmas, which cost more than forming S^T twice.  dQ: one
//      block per 128 q rows, looping over 64-row K/V tiles: S = Q.K^T,
//      dP = dO.V^T, dQ += dS.K.  Deterministic: no atomics, every output
//      written once, the GQA sum over q heads inside one block.
//    * Products: the forward runs 3 (S, P_hi.V, P_lo.V) where the bound
//      counts 2; the backward 11 (dK/dV 7, dQ 4) where it counts 5.
//    * GQA by indexing: q head h reads kv head h / G; K/V are never
//      repeated in memory.
//    * Shared memory (dynamic, + 1 KB to align tiles to 1024 bytes):
//      forward Q 32 KB + 2 x (K 32 + V 32) = 160 KB; dK/dV K 16 + V 16 +
//      2 x (Q 16 + dO 16 + lse, delta 0.5) = 97 KB; dQ Q 32 + dO 32 +
//      2 x (K 16 + V 16) = 128 KB.
//    * Shapes: D = 128, S a multiple of 128, H a multiple of Hkv.  D =
//      256 is not instantiated: a warpgroup's [64, 256] fp32 sum takes
//      128 of its 240 registers, so every pass would need 64-row K
//      tiles and the forward 192 KB of shared memory; the wrapper raises
//      (ROADMAP.md Queue 3).
//
// 2. fp32 inputs, and bf16 with fused RoPE: the fp32-core kernels (attn_*)
//    of the first port, exact for fp32 (the card-vs-CPU fp32 training
//    parity runs through them) and rotating q/k in fp32 on load, which a
//    bf16 tensor-core operand cannot hold (one bf16 rounding of the
//    rotated q and k would move the scores, and lse with them, by about
//    2e-3, twice the lse tolerance: an estimate, not measured).  64-row
//    q tiles against 64-row K/V tiles
//    in padded fp32 shared memory (strides 129 / 65), 256 threads each
//    owning a 4 x 4 block of scores, a separate dK/dV pass and dQ pass.
//    They take Hkv == H (the wrapper repeats K/V for GQA) and S a
//    multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kD = 128;          // head dim
constexpr int kH2 = kD / 2;      // RoPE pairs
constexpr int kB = 64;           // rows per q tile and per K/V tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLD = kD + 1;      // padded stride of [64, 128] tiles
constexpr int kLT = kB + 1;      // padded stride of [64, 64] tiles
constexpr int kTile = kB * kLD;  // floats of one [64, 128] tile
constexpr int kSq = kB * kLT;    // floats of one [64, 64] tile

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

// Copy 64 rows of [*, 128] from `src` (row 0 of the tile) into the padded
// fp32 tile `dst`, rotating each row by its position when kRope (cos/sin
// point at the tile's first row of the [S, 64] tables).
template <bool kRope, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const float* cos,
                                          const float* sin) {
  for (int it = threadIdx.x; it < kB * (kH2 / 4); it += kThreads) {
    const int r = it / (kH2 / 4);
    const int c = (it % (kH2 / 4)) * 4;
    float a[4], b[4];
    load4(src + (size_t)r * kD + c, a);
    load4(src + (size_t)r * kD + c + kH2, b);
    if (kRope) {
      float cs[4], sn[4];
      load4(cos + r * kH2 + c, cs);
      load4(sin + r * kH2 + c, sn);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x1 = a[e], x2 = b[e];
        a[e] = x1 * cs[e] - x2 * sn[e];
        b[e] = x1 * sn[e] + x2 * cs[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[r * kLD + c + e] = a[e];
      dst[r * kLD + c + kH2 + e] = b[e];
    }
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded
// [64, 128] tiles (rows of both index the 64 x 64 result).
__device__ __forceinline__ void dot_tiles(const float* A, const float* B,
                                          float acc[4][4], int ty, int tx) {
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
// tile times a padded [64, 128] tile into a thread's 4 x 8 outputs.
__device__ __forceinline__ void mul_tiles(const float* P, const float* V,
                                          float acc[4][8], int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * kLT + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = V[c * kLD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
  }
}

// De-rotate (kRope) and store a thread's 4 x 8 block of a [64, 128] tile
// whose first row is at sequence position `pos0`.  Columns tx + 16 j and
// tx + 16 (j + 4) are a RoPE pair.
template <bool kRope, typename T>
__device__ __forceinline__ void store_rows(T* dst, float acc[4][8], int pos0,
                                           const float* cos,
                                           const float* sin, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (kRope) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = (pos0 + r) * kH2 + tx + 16 * j;
        const float cs = cos[t], sn = sin[t];
        const float x1 = acc[i][j], x2 = acc[i][j + 4];
        acc[i][j] = x1 * cs + x2 * sn;
        acc[i][j + 4] = x2 * cs - x1 * sn;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[(size_t)r * kD + tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, batch * head)

template <typename T, bool kCausal, bool kRope>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ cos,
                const float* __restrict__ sin, T* __restrict__ out,
                float* __restrict__ lse, int S, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile;
  float* sV = sK + kTile;
  float* sP = sV + kTile;  // [64, 64] probabilities of this K tile
  const int nt = S / kB;
  const int qt = nt - 1 - blockIdx.x;  // longest causal loops first
  const size_t head = (size_t)blockIdx.y * S * kD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<kRope>(sQ, q + head + (size_t)qt * kB * kD, cos + qt * kB * kH2,
                   sin + qt * kB * kH2);
  float m[4], l[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }

  const int nk = kCausal ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
    load_tile<kRope>(sK, k + head + (size_t)kt * kB * kD,
                     cos + kt * kB * kH2, sin + kt * kB * kH2);
    load_tile<false>(sV, v + head + (size_t)kt * kB * kD, cos, sin);
    __syncthreads();
    float s[4][4] = {};
    dot_tiles(sQ, sK, s, ty, tx);
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
        const float p = expf(s[i][j] - mn);
        rs += p;
        sP[(ty + 16 * i) * kLT + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    mul_tiles(sP, sV, o, ty, tx);
  }

  T* dst = out + head + (size_t)qt * kB * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[(size_t)r * kD + tx + 16 * j] = from_float<T>(o[i][j] / l[i]);
    if (tx == 0)
      lse[(size_t)blockIdx.y * S + qt * kB + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward

// delta[row] = sum_d dout[row, d] * out[row, d] in fp32; one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                  float* __restrict__ delta, size_t rows) {
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float a[4], b[4];
  load4(out + row * kD + lane * 4, a);
  load4(dout + row * kD + lane * 4, b);
  float d = a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  if (lane == 0) delta[row] = d;
}

// dK, dV: one block per (K tile, batch * head), looping over q tiles.
template <typename T, bool kCausal, bool kRope>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ cos,
                     const float* __restrict__ sin,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, float scale) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile;
  float* sQ = sV + kTile;
  float* sO = sQ + kTile;   // dout tile
  float* sP = sO + kTile;   // [c, r] = p^T of this q tile
  float* sS = sP + kSq;     // [c, r] = ds^T
  float* sL = sS + kSq;     // lse of the q tile's rows
  float* sD = sL + kB;      // delta of the q tile's rows
  const int nt = S / kB;
  const int kt = blockIdx.x;  // causal: tile kt loops nt - kt times
  const size_t head = (size_t)blockIdx.y * S * kD;
  const size_t rowh = (size_t)blockIdx.y * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<kRope>(sK, k + head + (size_t)kt * kB * kD, cos + kt * kB * kH2,
                   sin + kt * kB * kH2);
  load_tile<false>(sV, v + head + (size_t)kt * kB * kD, cos, sin);
  float gk[4][8] = {}, gv[4][8] = {};

  for (int qt = kCausal ? kt : 0; qt < nt; ++qt) {
    __syncthreads();
    load_tile<kRope>(sQ, q + head + (size_t)qt * kB * kD,
                     cos + qt * kB * kH2, sin + qt * kB * kH2);
    load_tile<false>(sO, dout + head + (size_t)qt * kB * kD, cos, sin);
    if (threadIdx.x < kB) {
      sL[threadIdx.x] = lse[rowh + qt * kB + threadIdx.x];
      sD[threadIdx.x] = delta[rowh + qt * kB + threadIdx.x];
    }
    __syncthreads();
    // s^T and dp^T for K rows c = ty + 16 i and q rows r = tx + 16 j
    float st[4][4] = {}, dpt[4][4] = {};
    dot_tiles(sK, sQ, st, ty, tx);
    dot_tiles(sV, sO, dpt, ty, tx);
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
        sP[(ty + 16 * i) * kLT + rr] = p;
        sS[(ty + 16 * i) * kLT + rr] = p * (dpt[i][j] - sD[rr]) * scale;
      }
    }
    __syncthreads();
    mul_tiles(sP, sO, gv, ty, tx);  // dv += p^T @ dout
    mul_tiles(sS, sQ, gk, ty, tx);  // dk += ds^T @ q
  }
  store_rows<false>(dv + head + (size_t)kt * kB * kD, gv, kt * kB, cos, sin,
                    ty, tx);
  store_rows<kRope>(dk + head + (size_t)kt * kB * kD, gk, kt * kB, cos, sin,
                    ty, tx);
}

// dQ: one block per (q tile, batch * head), looping over K tiles.
template <typename T, bool kCausal, bool kRope>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ cos,
                   const float* __restrict__ sin,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   float scale) {
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
  const size_t head = (size_t)blockIdx.y * S * kD;
  const size_t rowh = (size_t)blockIdx.y * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<kRope>(sQ, q + head + (size_t)qt * kB * kD, cos + qt * kB * kH2,
                   sin + qt * kB * kH2);
  load_tile<false>(sO, dout + head + (size_t)qt * kB * kD, cos, sin);
  if (threadIdx.x < kB) {
    sL[threadIdx.x] = lse[rowh + qt * kB + threadIdx.x];
    sD[threadIdx.x] = delta[rowh + qt * kB + threadIdx.x];
  }
  float gq[4][8] = {};

  const int nk = kCausal ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<kRope>(sK, k + head + (size_t)kt * kB * kD,
                     cos + kt * kB * kH2, sin + kt * kB * kH2);
    load_tile<false>(sV, v + head + (size_t)kt * kB * kD, cos, sin);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_tiles(sQ, sK, s, ty, tx);
    dot_tiles(sO, sV, dp, ty, tx);
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
        sS[ri * kLT + tx + 16 * j] = p * (dp[i][j] - sD[ri]) * scale;
      }
    }
    __syncthreads();
    mul_tiles(sS, sK, gq, ty, tx);  // dq += ds @ k
  }
  store_rows<kRope>(dq + head + (size_t)qt * kB * kD, gq, qt * kB, cos, sin,
                    ty, tx);
}

// ---------------------------------------------------------------------------
// launchers

constexpr size_t kFwdSmem = sizeof(float) * (3 * kTile + kSq);
constexpr size_t kDkdvSmem = sizeof(float) * (4 * kTile + 2 * kSq + 2 * kB);
constexpr size_t kDqSmem = sizeof(float) * (4 * kTile + kSq + 2 * kB);

struct FwdArgs {
  const void *q, *k, *v;
  const float *cos, *sin;
  void* out;
  float* lse;
  int BH, S;
  float scale;
  cudaStream_t stream;
};

template <typename T, bool kCausal, bool kRope>
cudaError_t fwd(const FwdArgs& a) {
  auto kernel = attn_fwd_kernel<T, kCausal, kRope>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.S / kB, a.BH), kThreads, kFwdSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.cos, a.sin, static_cast<T*>(a.out),
      a.lse, a.S, a.scale);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float *cos, *sin, *lse;
  float* delta;
  void *dq, *dk, *dv;
  int BH, S;
  float scale;
  cudaStream_t stream;
};

template <typename T, bool kCausal, bool kRope>
cudaError_t bwd(const BwdArgs& a) {
  const size_t rows = (size_t)a.BH * a.S;
  const int per = kThreads / 32;
  attn_delta_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads, 0,
                         a.stream>>>(static_cast<const T*>(a.out),
                                     static_cast<const T*>(a.dout), a.delta,
                                     rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dkdv = attn_bwd_dkdv_kernel<T, kCausal, kRope>;
  e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDkdvSmem);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(a.S / kB, a.BH), kThreads, kDkdvSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.cos,
      a.sin, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.S, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dq = attn_bwd_dq_kernel<T, kCausal, kRope>;
  e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDqSmem);
  if (e != cudaSuccess) return e;
  dq<<<dim3(a.S / kB, a.BH), kThreads, kDqSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.cos,
      a.sin, a.lse, a.delta, static_cast<T*>(a.dq), a.S, a.scale);
  return cudaGetLastError();
}

template <typename T, typename A>
cudaError_t fwd_by_flags(const A& a, int causal, int rope) {
  if (causal && rope) return fwd<T, true, true>(a);
  if (causal) return fwd<T, true, false>(a);
  if (rope) return fwd<T, false, true>(a);
  return fwd<T, false, false>(a);
}

template <typename T, typename A>
cudaError_t bwd_by_flags(const A& a, int causal, int rope) {
  if (causal && rope) return bwd<T, true, true>(a);
  if (causal) return bwd<T, true, false>(a);
  if (rope) return bwd<T, false, true>(a);
  return bwd<T, false, false>(a);
}


// ===========================================================================
// Hopper tensor-core kernels: bf16 q/k/v, no RoPE

namespace wg {

using namespace hopper;

constexpr int kD = 128;            // head dim: two 64-column regions
constexpr int kThreads = 384;      // two consumer warpgroups + producer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg = -2.3819763e38f;  // the TPU kernel's mask value

constexpr int kFM = 128, kFN = 128;  // forward: q rows, kv rows per tile
constexpr int kBN = 64, kBM = 64;    // dK/dV: kv rows, q rows per tile
constexpr int kQM = 128, kQN = 64;   // dQ: q rows, kv rows per tile

// A [rows, 128] bf16 tile is two regions of [rows, 64] (128-byte rows,
// 128-byte swizzle), region r at r * rows * kRow bytes.
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * kD * 2;
}

constexpr int kStages = 2;  // ring depth of the streamed tiles

constexpr int kFwdSmem = 1024 + tile_bytes(kFM) +
                         2 * kStages * tile_bytes(kFN) +
                         8 * (1 + 4 * kStages);
constexpr int kDkdvSmem = 1024 + 2 * tile_bytes(kBN) +
                          kStages * (2 * tile_bytes(kBM) + 2 * kBM * 4) +
                          8 * (1 + 2 * kStages);
constexpr int kDqSmem = 1024 + 2 * tile_bytes(kQM) +
                        2 * kStages * tile_bytes(kQN) +
                        8 * (1 + 2 * kStages);

// Rows [row, row + rows) of a [*, 128] tensor, as two swizzled regions.
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* b, int row, int rows) {
  tma_2d(dst, map, b, 0, row);
  tma_2d(dst + rows * kRow, map, b, 64, row);
}

// -- small helpers (the descriptors and m64 products are in hopper.cuh) --

__device__ __forceinline__ int kv_head(int bh, int H, int G) {
  return (bh / H) * (H / G) + (bh % H) / G;
}

// A consumer thread's place in an m64 accumulator: warpgroup `wgi`, rows
// `row` and row + 8 of the warpgroup's 64, columns 8 j + 2 t (+1).  For
// m64nN, d[4 j + e] is (row + 8 (e >> 1), 8 j + 2 t + (e & 1)); the A
// fragment of k step kk takes d[8 kk .. 8 kk + 7] in that order.

// Store a warpgroup's [64, 128] fp32 sum as bf16 rows r0 and r0 + 8.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst0,
                                           const float (&d)[64], float s0,
                                           float s1) {
  __nv_bfloat16* dst1 = dst0 + 8 * kD;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * j) =
        __floats2bfloat162_rn(d[4 * j] * s0, d[4 * j + 1] * s0);
    *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * j) =
        __floats2bfloat162_rn(d[4 * j + 2] * s1, d[4 * j + 3] * s1);
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (128-row q tile, batch * q head)

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
attn_wg_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int S, int H, int G, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + tile_bytes(kFM);
  uint8_t* sV = sK + kStages * tile_bytes(kFN);
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(sV + kStages * tile_bytes(kFN));
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
      const int kvrow = kv_head(bh, H, G) * S;
      bar_expect(q_full, tile_bytes(kFM));
      load_tile(sQ, &tq, q_full, bh * S + qt * kFM, kFM);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        if (i >= kStages) bar_wait(k_empty + s, ph ^ 1);
        bar_expect(k_full + s, tile_bytes(kFN));
        load_tile(sK + s * tile_bytes(kFN), &tk, k_full + s, kvrow + i * kFN,
                  kFN);
        if (i >= kStages) bar_wait(v_empty + s, ph ^ 1);
        bar_expect(v_full + s, tile_bytes(kFN));
        load_tile(sV + s * tile_bytes(kFN), &tv, v_full + s, kvrow + i * kFN,
                  kFN);
      }
    }
  } else {  // consumer warpgroups 0 and 1
    regs_consumer();
    const int wgi = warp / 4, t = lane % 4;
    const int r0 = qt * kFM + wgi * 64 + (warp % 4) * 16 + lane / 4;
    const float sl2 = scale * kLog2e;
    const uint8_t* qa = sQ + wgi * 64 * kRow;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    bar_wait(q_full, 0);
    __syncwarp();

    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint8_t* kb = sK + s * tile_bytes(kFN);
      const uint8_t* vb = sV + s * tile_bytes(kFN);
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
      uint32_t phi[kFN / 16][4], plo[kFN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFN / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = 2 * kk + (f >> 1), e = (f & 1) * 2;
          const float m = e ? m1 : m0;
          const float p0 = exp2f(sc[4 * j + e] - m);
          const float p1 = exp2f(sc[4 * j + e + 1] - m);
          if (e)
            l1 += p0 + p1;
          else
            l0 += p0 + p1;
          split_bf16(p0, p1, phi[kk][f], plo[kk][f]);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
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
        wgmma_rs_n128t(o, phi[kk], v_mn + tstep(kk));
        wgmma_rs_n128t(o, plo[kk], v_mn + tstep(kk));
      }
      wg_commit();
      wg_wait0();
      fence_regs(o);
      release(v_empty + s, lane);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    store_rows(out + ((size_t)bh * S + r0) * kD + 2 * t, o, 1.f / l0,
               1.f / l1);
    if (t == 0) {
      lse[(size_t)bh * S + r0] = (m0 + log2f(l0)) * kLn2;
      lse[(size_t)bh * S + r0 + 8] = (m1 + log2f(l1)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (64 K rows, batch * kv head); loops
// over the group's q heads and their kBM-row q tiles.  Warpgroup 0 sums
// dV (S^T, then dV += P^T.dO), warpgroup 1 sums dK (S^T and dP^T, then
// dK += dS^T.Q): one 64-register accumulator each, so neither runs short
// of registers (both sums in one warpgroup made ptxas serialize its
// wgmmas), at the price of S^T computed twice.

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
attn_wg_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int S, int H, int G,
                    float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + tile_bytes(kBN);
  uint8_t* sQ = sV + tile_bytes(kBN);            // kStages tiles
  uint8_t* sO = sQ + kStages * tile_bytes(kBM);  // dout, kStages tiles
  float* sL = reinterpret_cast<float*>(sO + kStages * tile_bytes(kBM));
  float* sD = sL + kStages * kBM;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + kStages * kBM);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x;  // causal: G (S - 64 kt) / kBM steps
  const int kvh = blockIdx.y;
  const int Hkv = H / G;
  const int b = kvh / Hkv, hk = kvh % Hkv;
  const int q0 = kCausal ? kt * kBN / kBM : 0;
  const int per = S / kBM - q0;
  const int n = G * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
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
      bar_expect(kv_full, 2 * tile_bytes(kBN));
      load_tile(sK, &tk, kv_full, kvh * S + kt * kBN, kBN);
      load_tile(sV, &tv, kv_full, kvh * S + kt * kBN, kBN);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int row =
            (b * H + hk * G + i / per) * S + (q0 + i % per) * kBM;
        if (i >= kStages) bar_wait(empty + s, ph ^ 1);
        bar_expect(full + s, 2 * tile_bytes(kBM) + 2 * kBM * 4);
        load_tile(sQ + s * tile_bytes(kBM), &tq, full + s, row, kBM);
        load_tile(sO + s * tile_bytes(kBM), &tdo, full + s, row, kBM);
        bulk_copy(sL + s * kBM, lse + row, kBM * 4, full + s);
        bulk_copy(sD + s * kBM, delta + row, kBM * 4, full + s);
      }
    }
  } else {  // consumer warpgroups: 0 sums dV, 1 sums dK
    regs_consumer();
    const bool sums_dk = role == 1;
    const int t = lane % 4;
    const int c0 = kt * kBN + (warp % 4) * 16 + lane / 4;  // K position
    const float sl2 = scale * kLog2e;
    const uint64_t k_km = kdesc(sK), v_km = kdesc(sV);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    bar_wait(kv_full, 0);
    __syncwarp();

    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int qp = (q0 + i % per) * kBM;  // first q position of the tile
      const uint8_t* qb = sQ + s * tile_bytes(kBM);
      const uint8_t* ob = sO + s * tile_bytes(kBM);
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
      wg_wait0();
      fence_regs(st);
      if (sums_dk) fence_regs(dpt);

      // P^T (dV) or dS^T (dK) as bf16 hi + lo A fragments
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
          if (sums_dk) {
            const float2 dl = *reinterpret_cast<const float2*>(Dl + qc);
            p0 *= (dpt[4 * j + e] - dl.x) * scale;
            p1 *= (dpt[4 * j + e + 1] - dl.y) * scale;
          }
          split_bf16(p0, p1, hi[kk][f], lo[kk][f]);
        }
      }
      const uint64_t b_mn = tdesc(sums_dk ? qb : ob, kBM);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) {
        wgmma_rs_n128t(acc, hi[kk], b_mn + tstep(kk));
        wgmma_rs_n128t(acc, lo[kk], b_mn + tstep(kk));
      }
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      release(empty + s, lane);
    }

    store_rows((sums_dk ? dk : dv) + ((size_t)kvh * S + c0) * kD + 2 * t,
               acc, 1.f, 1.f);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: one block per (128-row q tile, batch * q head); loops over
// 64-row K/V tiles

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
attn_wg_dq_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int S, int H, int G,
                  float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sO = sQ + tile_bytes(kQM);
  uint8_t* sK = sO + tile_bytes(kQM);            // kStages tiles
  uint8_t* sV = sK + kStages * tile_bytes(kQN);  // kStages tiles
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(sV + kStages * tile_bytes(kQN));
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
      const int kvrow = kv_head(bh, H, G) * S;
      bar_expect(q_full, 2 * tile_bytes(kQM));
      load_tile(sQ, &tq, q_full, bh * S + qt * kQM, kQM);
      load_tile(sO, &tdo, q_full, bh * S + qt * kQM, kQM);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        if (i >= kStages) bar_wait(empty + s, ph ^ 1);
        bar_expect(full + s, 2 * tile_bytes(kQN));
        load_tile(sK + s * tile_bytes(kQN), &tk, full + s, kvrow + i * kQN,
                  kQN);
        load_tile(sV + s * tile_bytes(kQN), &tv, full + s, kvrow + i * kQN,
                  kQN);
      }
    }
  } else {  // consumer warpgroups 0 and 1
    regs_consumer();
    const int wgi = warp / 4, t = lane % 4;
    const int r0 = qt * kQM + wgi * 64 + (warp % 4) * 16 + lane / 4;
    const size_t rb = (size_t)bh * S;
    const float sl2 = scale * kLog2e;
    const float L0 = lse[rb + r0] * kLog2e, L1 = lse[rb + r0 + 8] * kLog2e;
    const float D0 = delta[rb + r0], D1 = delta[rb + r0 + 8];
    const uint8_t* qa = sQ + wgi * 64 * kRow;
    const uint8_t* oa = sO + wgi * 64 * kRow;
    float gq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) gq[i] = 0.f;
    bar_wait(q_full, 0);
    __syncwarp();

    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint8_t* kb = sK + s * tile_bytes(kQN);
      const uint8_t* vb = sV + s * tile_bytes(kQN);
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
          split_bf16(p0 * (dp[4 * j + e] - Dr) * scale,
                     p1 * (dp[4 * j + e + 1] - Dr) * scale, shi[kk][f],
                     slo[kk][f]);
        }
      }
      wg_fence();
      const uint64_t k_mn = tdesc(kb, kQN);
#pragma unroll
      for (int kk = 0; kk < kQN / 16; ++kk) {
        wgmma_rs_n128t(gq, shi[kk], k_mn + tstep(kk));
        wgmma_rs_n128t(gq, slo[kk], k_mn + tstep(kk));
      }
      wg_commit();
      wg_wait0();
      fence_regs(gq);
      release(empty + s, lane);
    }

    store_rows(dq + (rb + r0) * kD + 2 * t, gq, 1.f, 1.f);
  }
}

// -- host: tensor maps and launches ----------------------------------------

// A [rows, 128] bf16 tensor read in boxes of `box` rows x 64 columns.
bool make_map(CUtensorMap* map, const void* base, size_t rows, int box) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)kD, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kD * 2};
  const cuuint32_t boxd[2] = {64, (cuuint32_t)box};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, boxd, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  float *lse, *delta;
  void *o, *dq, *dk, *dv;
  int B, H, Hkv, S;
  float scale;
  cudaStream_t stream;
};

template <bool kCausal>
cudaError_t fwd(const Args& a) {
  CUtensorMap mq, mk, mv;
  const size_t nq = (size_t)a.B * a.H * a.S, nkv = (size_t)a.B * a.Hkv * a.S;
  if (!make_map(&mq, a.q, nq, kFM) || !make_map(&mk, a.k, nkv, kFN) ||
      !make_map(&mv, a.v, nkv, kFN))
    return cudaErrorNotSupported;
  auto kernel = attn_wg_fwd_kernel<kCausal>;
  cudaError_t e = allow_smem(kernel, kFwdSmem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.S / kFM, a.B * a.H), kThreads, kFwdSmem, a.stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), a.lse, a.S, a.H,
      a.H / a.Hkv, a.scale);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd(const Args& a) {
  const size_t rows = (size_t)a.B * a.H * a.S;
  const int per = ::kThreads / 32;
  attn_delta_kernel<__nv_bfloat16>
      <<<(unsigned)((rows + per - 1) / per), ::kThreads, 0, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.out),
          static_cast<const __nv_bfloat16*>(a.dout), a.delta, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t nkv = (size_t)a.B * a.Hkv * a.S;
  const int G = a.H / a.Hkv;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, a.q, rows, kBM) || !make_map(&mk, a.k, nkv, kBN) ||
      !make_map(&mv, a.v, nkv, kBN) || !make_map(&mo, a.dout, rows, kBM))
    return cudaErrorNotSupported;
  auto dkdv = attn_wg_dkdv_kernel<kCausal>;
  e = allow_smem(dkdv, kDkdvSmem);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(a.S / kBN, a.B * a.Hkv), kThreads, kDkdvSmem, a.stream>>>(
      mq, mk, mv, mo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.S, a.H, G, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  if (!make_map(&mq, a.q, rows, kQM) || !make_map(&mk, a.k, nkv, kQN) ||
      !make_map(&mv, a.v, nkv, kQN) || !make_map(&mo, a.dout, rows, kQM))
    return cudaErrorNotSupported;
  auto dq = attn_wg_dq_kernel<kCausal>;
  e = allow_smem(dq, kDqSmem);
  if (e != cudaSuccess) return e;
  dq<<<dim3(a.S / kQM, a.B * a.H), kThreads, kDqSmem, a.stream>>>(
      mq, mk, mv, mo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.S, a.H, G, a.scale);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// Both launch on `stream`, whose device must be the calling thread's
// current one (the Python wrapper selects it), and return 0 on success,
// else the CUDA error code of the refused launch (cudaErrorInvalidValue
// for a shape or dtype these kernels do not take, cudaErrorNotSupported
// when a tensor map cannot be encoded).  dtype code: 0 = float32, 1 =
// bfloat16, the same for every q/k/v/out/dout/dq/dk/dv.  q, out, dout,
// dq [B, H, S, 128] and k, v, dk, dv [B, Hkv, S, 128], contiguous; lse
// and delta [B, H, S] fp32; cos/sin [S, 64] fp32 (read only when
// use_rope; may be null otherwise).  bf16 without RoPE takes the
// tensor-core kernels (S % 128 == 0, H % Hkv == 0); fp32, and bf16 with
// RoPE, the fp32-core kernels (S % 64 == 0, Hkv == H).  The backward's
// `delta` is scratch the caller allocates.
extern "C" int long_attention_fwd_launch(const void* q, const void* k,
                                         const void* v, const void* cos,
                                         const void* sin, void* out,
                                         void* lse, int B, int H, int Hkv,
                                         int S, int D, float scale,
                                         int causal, int use_rope,
                                         int dtype, void* stream) {
  if (D != kD || S <= 0 || B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && !use_rope) {
    if (S % wg::kFM) return cudaErrorInvalidValue;
    const wg::Args a{q,       k,       v,       nullptr, nullptr,
                     static_cast<float*>(lse), nullptr, out, nullptr,
                     nullptr, nullptr, B,       H,       Hkv,     S,
                     scale,   st};
    return causal ? wg::fwd<true>(a) : wg::fwd<false>(a);
  }
  if (S % kB || Hkv != H) return cudaErrorInvalidValue;
  const FwdArgs a{q,   k,  v, static_cast<const float*>(cos),
                  static_cast<const float*>(sin),
                  out, static_cast<float*>(lse), B * H, S, scale, st};
  if (dtype == 0) return fwd_by_flags<float>(a, causal, use_rope);
  if (dtype == 1) return causal ? fwd<__nv_bfloat16, true, true>(a)
                                : fwd<__nv_bfloat16, false, true>(a);
  return cudaErrorInvalidValue;
}

extern "C" int long_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* cos, const void* sin, const void* lse,
    void* delta, void* dq, void* dk, void* dv, int B, int H, int Hkv,
    int S, int D, float scale, int causal, int use_rope, int dtype,
    void* stream) {
  if (D != kD || S <= 0 || B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && !use_rope) {
    if (S % wg::kQM) return cudaErrorInvalidValue;
    const wg::Args a{q,
                     k,
                     v,
                     out,
                     dout,
                     const_cast<float*>(static_cast<const float*>(lse)),
                     static_cast<float*>(delta),
                     nullptr,
                     dq,
                     dk,
                     dv,
                     B,
                     H,
                     Hkv,
                     S,
                     scale,
                     st};
    return causal ? wg::bwd<true>(a) : wg::bwd<false>(a);
  }
  if (S % kB || Hkv != H) return cudaErrorInvalidValue;
  const BwdArgs a{q,
                  k,
                  v,
                  out,
                  dout,
                  static_cast<const float*>(cos),
                  static_cast<const float*>(sin),
                  static_cast<const float*>(lse),
                  static_cast<float*>(delta),
                  dq,
                  dk,
                  dv,
                  B * H,
                  S,
                  scale,
                  st};
  if (dtype == 0) return bwd_by_flags<float>(a, causal, use_rope);
  if (dtype == 1) return causal ? bwd<__nv_bfloat16, true, true>(a)
                                : bwd<__nv_bfloat16, false, true>(a);
  return cudaErrorInvalidValue;
}
