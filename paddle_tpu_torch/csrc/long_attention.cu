// Causal attention, forward and backward, for Hopper (sm_90a), with a
// plain C interface and optional fused RoPE.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels/
// long_attention.py: _fwd_call (_fwd_kernel) and _bwd_call (_bwd_kernel).
// Per (batch, head), with q/k/v [S, D] (D = 128) and s = (q . k) * scale:
//
//     fwd:  lse = logsumexp_j s[i, j]  (j <= i when causal)   fp32
//           out = softmax(s) @ v                              q's dtype
//     bwd:  p  = exp(s - lse);  dp = dout @ v^T
//           ds = p * (dp - delta) * scale,  delta_i = sum_d dout * out
//           dv = p^T @ dout;  dq = ds @ k;  dk = ds^T @ q
//
// With RoPE, q and k rotate on load (half-split pairs, angle pos * inv_freq
// from fp32 cos/sin tables [S, D/2] the wrapper builds), and dq/dk
// de-rotate with the transposed rotation before the store.
//
// Bound: operations.  The causal half of QK^T and PV is S^2 * D
// multiply-adds per head and product: 1.37e11 flops in the forward at
// B=4, H=32, S=2048, D=128 (0.139 ms at 989 TFLOP/s bf16), five such
// products in the backward (0.347 ms).  The bytes (q, k, v, out once
// each, bf16) are 268 MB, 0.080 ms at 3.35 TB/s.
//
// Design (simple first; wgmma, TMA and pipelining come later):
//   * The TPU kernel holds one head's whole K/V and a [block_q, S] score
//     row in VMEM.  A Hopper block has at most 227 KB of shared memory, so
//     this is a flash-style kernel instead: 64-row q tiles against 64-row
//     K/V tiles, fp32 online softmax (running max and sum per row), fp32
//     accumulation, K tiles above the diagonal never loaded.
//   * Tiles sit in shared memory as fp32 with a padded row stride (129 /
//     65 floats), so both row-wise and column-wise reads are free of bank
//     conflicts; 256 threads in a 16 x 16 grid each own a 4 x 4 block of
//     scores (rows ty + 16 i, columns tx + 16 j) and a 4 x 8 block of the
//     [64, 128] outputs.  Products run on the fp32 cores; bf16 inputs are
//     widened on load, exactly as the TPU kernel does.
//   * Backward: dK/dV are summed over q tiles by a SEPARATE pass over K
//     tiles (one block owns a K tile and loops over the q tiles at or
//     below the diagonal), and dQ by a pass over q tiles.  That costs two
//     extra products (7 instead of 5) but needs no atomics: the sums are
//     deterministic run to run, and nothing is written twice.  A small
//     first kernel forms delta = rowsum(dout * out).
//   * Causal tiles do unequal work; blocks are numbered so the longest
//     loops start first.
// S must be a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

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

}  // namespace

// Both launch on `stream`, whose device must be the calling thread's
// current one (the Python wrapper selects it), and return 0 on success,
// else the CUDA error code of the refused launch (cudaErrorInvalidValue
// for a shape or dtype this kernel does not take).  dtype code: 0 =
// float32, 1 = bfloat16, the same for every q/k/v/out/dout/dq/dk/dv.
// Layout [BH, S, 128] contiguous; lse and delta [BH, S] fp32; cos/sin
// [S, 64] fp32 (read only when use_rope; may be null otherwise).  The
// backward's `delta` is scratch the caller allocates.
extern "C" int long_attention_fwd_launch(const void* q, const void* k,
                                         const void* v, const void* cos,
                                         const void* sin, void* out,
                                         void* lse, int BH, int S, int D,
                                         float scale, int causal,
                                         int use_rope, int dtype,
                                         void* stream) {
  if (D != kD || S <= 0 || S % kB || BH <= 0) return cudaErrorInvalidValue;
  const FwdArgs a{q,   k,  v, static_cast<const float*>(cos),
                  static_cast<const float*>(sin),
                  out, static_cast<float*>(lse), BH, S, scale,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return fwd_by_flags<float>(a, causal, use_rope);
  if (dtype == 1) return fwd_by_flags<__nv_bfloat16>(a, causal, use_rope);
  return cudaErrorInvalidValue;
}

extern "C" int long_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* cos, const void* sin, const void* lse,
    void* delta, void* dq, void* dk, void* dv, int BH, int S, int D,
    float scale, int causal, int use_rope, int dtype, void* stream) {
  if (D != kD || S <= 0 || S % kB || BH <= 0) return cudaErrorInvalidValue;
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
                  BH,
                  S,
                  scale,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return bwd_by_flags<float>(a, causal, use_rope);
  if (dtype == 1) return bwd_by_flags<__nv_bfloat16>(a, causal, use_rope);
  return cudaErrorInvalidValue;
}
