// Paged-decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_kernels/
// paged_decode.py (_kernel / _call): single-token decode attention over a
// block-table (paged) KV cache.  For each (sequence b, kv head):
//
//     s[g, t] = (q[b, kv, g] * scale) . K[page_indices[b, t / ps], t % ps]
//     p       = softmax over t < lengths[b]   (fp32, max-subtracted)
//     out[g]  = sum_t p[g, t] * V[...]        (fp32 accumulate)
//
// Layouts (all contiguous):
//   q, out        [B, KV, G, D]   (== [B, H, D] with h = kv * G + g)
//   k/v_pages     [KV, P, ps, D]  one layer of the pool
//   lengths       [B]      int32  valid tokens per sequence
//   page_indices  [B, pps] int32  each sequence's page-table row
//
// Bound: the bytes of K and V read, 2 * sum_b(len_b) * KV * D * sizeof(T);
// everything else (q, out, the table) is small.  Decode attention does
// 4 flops per byte of bf16 K/V, far below the card's ~295 flop/byte
// ridge, so the memory system sets the pace.
//
// Design (simple first; wgmma, TMA and split-K come later):
//   * one block of 8 warps per (b, kv head); the G = H / KV query rows of
//     that head are served from the same K/V loads (GQA for free);
//   * pages are read through page_indices only for t < len: pages past
//     the length are never touched, so garbage or NaN there cannot leak
//     into the output (the TPU kernel zero-fills its window tail instead);
//   * pass 1: warp w takes tokens t = w, w + 8, ...; each lane holds
//     D / 32 consecutive elements of the K row (a coalesced row read per
//     warp), dots them with its slice of every q row and reduces across
//     the warp; scores land in shared memory ([G, pps * ps] floats);
//   * softmax: block-wide max, exp in place, block-wide sum, all fp32;
//   * pass 2: the same token split over V rows, per-lane fp32
//     accumulators for every q row, then one cross-warp sum in shared
//     memory and the division by the softmax sum; out is written in q's
//     dtype.
// A length of 0 writes zeros.  Lengths above pps * ps are clamped.
//
// The int8 entry point (paged_decode_quant_launch) replaces the Pallas
// TPU kernel's int8 variant (_kernel_quant / _call_quant, PT_QUANT=int8):
// the same body over int8 pools, each K/V row multiplied by its page's
// f32 scale (k_scales / v_scales [KV, P]) as it is widened, before the
// dot and the weighted sum, as the TPU kernel dequantizes its window.
// It moves half the K/V bytes of a bf16 pool.  The TPU gate
// page_size % 32 == 0 is int8 sublane tiling; here any page size works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// One lane's EPL elements of a K or V row, widened to float; an int8 row
// is multiplied by its page's scale `s` (4-byte loads where they align).
template <bool kQuant, typename TKV, int EPL>
__device__ __forceinline__ void load_row(const TKV* p, float s,
                                         float (&r)[EPL]) {
  if constexpr (kQuant && EPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < EPL / 4; ++i) {
      const char4 c = reinterpret_cast<const char4*>(p)[i];
      r[4 * i] = c.x * s;
      r[4 * i + 1] = c.y * s;
      r[4 * i + 2] = c.z * s;
      r[4 * i + 3] = c.w * s;
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      r[e] = kQuant ? to_float(p[e]) * s : to_float(p[e]);
  }
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction; every thread gets the result.  `red` is
// kWarps floats of shared memory.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // the previous call may still be reading `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// The body of both entry points; kQuant selects int8 pools with per-page
// scales (k_scales / v_scales are unread otherwise).
template <typename TQ, typename TKV, int D, int GMAX, bool kQuant>
__device__ __forceinline__ void paged_decode_body(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ lengths,
    const int* __restrict__ page_indices, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, TQ* __restrict__ out, int KV, int G,
    int P, int ps, int pps, float scale) {
  constexpr int EPL = D / 32;  // K/V row elements per lane
  const int b = blockIdx.x / KV;
  const int kv = blockIdx.x % KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int window = pps * ps;

  extern __shared__ float smem[];
  float* s_q = smem;                   // [G, D]   scaled q rows
  float* s_p = s_q + G * D;            // [G, window] scores, then exp
  float* s_acc = s_p + G * window;     // [kWarps, G, D] partial outputs
  __shared__ float s_red[kWarps];
  __shared__ float s_sum[GMAX];

  int len = lengths[b];
  len = len < 0 ? 0 : (len > window ? window : len);
  const size_t head = (size_t)(b * KV + kv) * G * D;

  if (len == 0) {
    for (int i = threadIdx.x; i < G * D; i += kThreads)
      out[head + i] = from_float<TQ>(0.f);
    return;
  }

  for (int i = threadIdx.x; i < G * D; i += kThreads)
    s_q[i] = to_float(q[head + i]) * scale;
  __syncthreads();

  float qr[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = g < G ? s_q[g * D + lane * EPL + e] : 0.f;

  const int* table = page_indices + (size_t)b * pps;
  const size_t pool = (size_t)kv * P * ps * D;
  // this head's page scales (null for a float pool)
  const float* ksc = kQuant ? k_scales + (size_t)kv * P : nullptr;
  const float* vsc = kQuant ? v_scales + (size_t)kv * P : nullptr;

  // pass 1: scores
#pragma unroll 4
  for (int t = warp; t < len; t += kWarps) {
    const int pid = table[t / ps];
    const size_t row = ((size_t)pid * ps + t % ps) * D;
    float kr[EPL];
    load_row<kQuant>(k_pages + pool + row + lane * EPL,
                     kQuant ? ksc[pid] : 1.f, kr);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qr[g][e] * kr[e];
        d = warp_sum(d);
        if (lane == 0) s_p[g * window + t] = d;
      }
    }
  }
  __syncthreads();

  // softmax statistics; s_p turns into exp(s - max) in place
  for (int g = 0; g < G; ++g) {
    float* sp = s_p + g * window;
    float m = -INFINITY;
    for (int t = threadIdx.x; t < len; t += kThreads) m = fmaxf(m, sp[t]);
    m = block_reduce<true>(m, s_red);
    float sum = 0.f;
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float e = expf(sp[t] - m);
      sp[t] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, s_red);
    if (threadIdx.x == 0) s_sum[g] = sum;
  }
  __syncthreads();

  // pass 2: weighted sum of V rows
  float acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;

#pragma unroll 4
  for (int t = warp; t < len; t += kWarps) {
    const int pid = table[t / ps];
    const size_t row = ((size_t)pid * ps + t % ps) * D;
    float vr[EPL];
    load_row<kQuant>(v_pages + pool + row + lane * EPL,
                     kQuant ? vsc[pid] : 1.f, vr);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float p = s_p[g * window + t];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p * vr[e];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        s_acc[(warp * G + g) * D + lane * EPL + e] = acc[g][e];
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += s_acc[(w * G + g) * D + d];
    out[head + i] = from_float<TQ>(o / s_sum[g]);
  }
}

template <typename TQ, typename TKV, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ page_indices,
                    TQ* __restrict__ out, int KV, int G, int P, int ps,
                    int pps, float scale) {
  paged_decode_body<TQ, TKV, D, GMAX, false>(q, k_pages, v_pages, lengths,
                                             page_indices, nullptr, nullptr,
                                             out, KV, G, P, ps, pps, scale);
}

template <typename TQ, typename TKV, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
paged_decode_quant_kernel(const TQ* __restrict__ q,
                          const TKV* __restrict__ k_pages,
                          const TKV* __restrict__ v_pages,
                          const int* __restrict__ lengths,
                          const int* __restrict__ page_indices,
                          const float* __restrict__ k_scales,
                          const float* __restrict__ v_scales,
                          TQ* __restrict__ out, int KV, int G, int P, int ps,
                          int pps, float scale) {
  paged_decode_body<TQ, TKV, D, GMAX, true>(q, k_pages, v_pages, lengths,
                                            page_indices, k_scales, v_scales,
                                            out, KV, G, P, ps, pps, scale);
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* page_indices;
  const float* k_scales;  // int8 pools only
  const float* v_scales;
  void* out;
  int B, KV, G, D, P, ps, pps;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GMAX>
cudaError_t launch(const Args& a) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  const size_t smem =
      sizeof(float) * ((size_t)a.G * D * (1 + kWarps) +
                       (size_t)a.G * a.pps * a.ps);
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* kp = static_cast<const TKV*>(a.k_pages);
  const TKV* vp = static_cast<const TKV*>(a.v_pages);
  TQ* out = static_cast<TQ*>(a.out);
  if constexpr (kQuant) {
    auto kernel = paged_decode_quant_kernel<TQ, TKV, D, GMAX>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<a.B * a.KV, kThreads, smem, a.stream>>>(
        q, kp, vp, a.lengths, a.page_indices, a.k_scales, a.v_scales, out,
        a.KV, a.G, a.P, a.ps, a.pps, a.scale);
  } else {
    auto kernel = paged_decode_kernel<TQ, TKV, D, GMAX>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<a.B * a.KV, kThreads, smem, a.stream>>>(
        q, kp, vp, a.lengths, a.page_indices, out, a.KV, a.G, a.P, a.ps,
        a.pps, a.scale);
  }
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t by_group(const Args& a) {
  if (a.G <= 1) return launch<TQ, TKV, D, 1>(a);
  if (a.G <= 2) return launch<TQ, TKV, D, 2>(a);
  if (a.G <= 4) return launch<TQ, TKV, D, 4>(a);
  if (a.G <= 8) return launch<TQ, TKV, D, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t by_head_dim(const Args& a) {
  if (a.D == 64) return by_group<TQ, TKV, 64>(a);
  if (a.D == 128) return by_group<TQ, TKV, 128>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream`, whose device must be the calling thread's
// current one (the Python wrapper selects it).  Returns 0 on success,
// else the CUDA error code of the refused launch (cudaErrorInvalidValue
// for a shape or dtype this kernel does not take).  dtype codes:
// 0 = float32, 1 = bfloat16.  Takes (q, pool) dtype pairs (f32, f32),
// (f32, bf16) and (bf16, bf16).
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* lengths,
                                   const void* page_indices, void* out,
                                   int B, int KV, int G, int D, int P, int ps,
                                   int pps, float scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  const Args a{q,  k_pages, v_pages, static_cast<const int*>(lengths),
               static_cast<const int*>(page_indices), nullptr, nullptr,
               out, B, KV, G, D, P, ps, pps, scale,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_head_dim<float, float>(a);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_head_dim<float, __nv_bfloat16>(a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

// The int8-pool twin: k/v_pages int8 [KV, P, ps, D], k/v_scales float32
// [KV, P].  Takes q float32 or bfloat16 (q_dtype 0 or 1); otherwise as
// paged_decode_launch.
extern "C" int paged_decode_quant_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* page_indices, const void* k_scales,
    const void* v_scales, void* out, int B, int KV, int G, int D, int P,
    int ps, int pps, float scale, int q_dtype, void* stream) {
  const Args a{q,  k_pages, v_pages, static_cast<const int*>(lengths),
               static_cast<const int*>(page_indices),
               static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               out, B, KV, G, D, P, ps, pps, scale,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return by_head_dim<float, int8_t>(a);
  if (q_dtype == 1) return by_head_dim<__nv_bfloat16, int8_t>(a);
  return cudaErrorInvalidValue;
}
