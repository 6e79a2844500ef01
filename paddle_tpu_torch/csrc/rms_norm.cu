// Fused RMSNorm forward and backward (dx) for Hopper (sm_90a), with a plain
// C interface.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels/
// rms_norm.py: _fused_fwd_2d (_fwd_kernel) and _fused_bwd_2d (_bwd_kernel).
// For each row of x [N, h]:
//
//     fwd:  rstd = 1 / sqrt(mean(x^2) + eps)         (fp32, saved)
//           out  = x * rstd * w                      (fp32, ONE cast to x's
//                                                     dtype at the store)
//     bwd:  dxhat = dy * w;  xhat = x * rstd
//           dx    = rstd * (dxhat - xhat * mean(dxhat * xhat))
//
// dw = sum over rows of dy * xhat stays a plain tensor contraction in the
// caller, as in the TPU version.
//
// Bound: bytes.  The forward reads x and w and writes out and rstd; the
// backward reads x, dy, w and rstd and writes dx.  At N = 8192, h = 4096,
// bf16 x and fp32 w that is ~134 MB and ~201 MB, against ~2 flops per
// byte, far below the card's ridge.
//
// Design (simple first): one block of 256 threads per row.  x, out, dy and
// dx may be fp32, bf16 or fp16, and w any of the three (the reference sends
// every such pair to its kernel).  Any h: a row is walked as a scalar head
// up to the first element whose address is aligned to four elements, a
// body of four-element vector loads, and a scalar tail; w is read four at a
// time where its columns line up with the body (no head) and element by
// element otherwise.  A row that fits in shared memory (h fp32 values in
// the forward, 2h in the backward) is read from device memory ONCE into
// shared memory as fp32 while each thread sums its squares (or its
// dxhat * xhat), and the output pass reads shared memory only; above that
// limit (the forward past h = 58112, the backward past h = 29056) the
// output pass reads the row from device memory a second time.  A
// warp-shuffle plus shared-memory reduction gives the row sum to every
// thread.  Any N works: there is no padding to a row-block size (the TPU
// version pads rows to 256).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;  // bytes a block may take (sm_90)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// Four consecutive elements, the first at an address aligned to four
// elements (16 bytes for fp32, 8 for the 16-bit types).
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

__device__ __forceinline__ void load4(const __half* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ void store4(__half* p, const float v[4]) {
  uint2 t;
  *reinterpret_cast<__half2*>(&t.x) = __floats2half2_rn(v[0], v[1]);
  *reinterpret_cast<__half2*>(&t.y) = __floats2half2_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

// w[c .. c + 3]: one vector load when the columns line up with w's own
// alignment (the row has no head), else four scalar loads.
template <typename TW>
__device__ __forceinline__ void load_w4(const TW* w, int c, bool vec,
                                        float v[4]) {
  if (vec) {
    load4(w + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = to_f(w[c + e]);
  }
}

// v[0..3] to / from the fp32 row staged in shared memory at column c: one
// 16-byte access where c is a multiple of four (the row has no head).
__device__ __forceinline__ void stage4(float* s, int c, bool vec,
                                       const float v[4]) {
  if (vec) {
    store4(s + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[c + e] = v[e];
  }
}

__device__ __forceinline__ void unstage4(const float* s, int c, bool vec,
                                         float v[4]) {
  if (vec) {
    load4(s + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = s[c + e];
  }
}

// Block-wide sum; every thread gets the result.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += red[w];
  return r;
}

// The row's split: elements [0, head) and [head + 4 * nvec, h) one at a
// time, [head, head + 4 * nvec) four at a time.
template <typename TX>
__device__ __forceinline__ int row_head(const TX* row, int h) {
  const uintptr_t e = reinterpret_cast<uintptr_t>(row) / sizeof(TX);
  const int head = (int)((4 - (e & 3)) & 3);
  return head < h ? head : h;
}

template <typename TX, typename TW, bool kStage>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ out, float* __restrict__ rstd, int h,
                    float eps) {
  extern __shared__ float s_x[];  // [h] the row in fp32 (kStage)
  __shared__ float s_red[kWarps];
  const TX* xr = x + (size_t)blockIdx.x * h;
  TX* orow = out + (size_t)blockIdx.x * h;
  const int head = row_head(xr, h);
  const int nvec = (h - head) / 4;
  const int tail = head + 4 * nvec;
  const bool vec = head == 0;  // w and shared memory line up with x
  float ss = 0.f;
  for (int c = threadIdx.x; c < head; c += kThreads) {
    const float v = to_f(xr[c]);
    ss += v * v;
    if (kStage) s_x[c] = v;
  }
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int c = head + 4 * i;
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) ss += v[e] * v[e];
    if (kStage) stage4(s_x, c, vec, v);
  }
  for (int c = tail + threadIdx.x; c < h; c += kThreads) {
    const float v = to_f(xr[c]);
    ss += v * v;
    if (kStage) s_x[c] = v;
  }
  const float r = 1.f / sqrtf(block_sum(ss, s_red) / (float)h + eps);
  for (int c = threadIdx.x; c < head; c += kThreads) {
    const float v = kStage ? s_x[c] : to_f(xr[c]);
    orow[c] = from_f<TX>(v * r * to_f(w[c]));
  }
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int c = head + 4 * i;
    float v[4], wv[4];
    if (kStage) {
      unstage4(s_x, c, vec, v);
    } else {
      load4(xr + c, v);
    }
    load_w4(w, c, vec, wv);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = v[e] * r * wv[e];
    store4(orow + c, v);
  }
  for (int c = tail + threadIdx.x; c < h; c += kThreads) {
    const float v = kStage ? s_x[c] : to_f(xr[c]);
    orow[c] = from_f<TX>(v * r * to_f(w[c]));
  }
  if (threadIdx.x == 0) rstd[blockIdx.x] = r;
}

template <typename TX, typename TW, bool kStage>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ rstd,
                    const TX* __restrict__ dy, TX* __restrict__ dx, int h) {
  extern __shared__ float smem[];
  float* s_xhat = smem;       // [h] x * rstd   (kStage)
  float* s_dxhat = smem + h;  // [h] dy * w     (kStage)
  __shared__ float s_red[kWarps];
  const size_t off = (size_t)blockIdx.x * h;
  const TX* xr = x + off;
  const TX* gr = dy + off;
  TX* dr = dx + off;
  const float r = rstd[blockIdx.x];
  // x, dy and dx rows share their offset, so one head serves all three
  const int head = row_head(xr, h);
  const int nvec = (h - head) / 4;
  const int tail = head + 4 * nvec;
  const bool vec = head == 0;  // w and s_xhat line up with x
  // s_dxhat starts h floats in: 16-byte aligned only when h % 4 == 0
  const bool svec = vec && h % 4 == 0;
  float dot = 0.f;
  for (int c = threadIdx.x; c < head; c += kThreads) {
    const float xv = to_f(xr[c]) * r, gv = to_f(gr[c]) * to_f(w[c]);
    dot += gv * xv;
    if (kStage) {
      s_xhat[c] = xv;
      s_dxhat[c] = gv;
    }
  }
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int c = head + 4 * i;
    float xv[4], gv[4], wv[4];
    load4(xr + c, xv);
    load4(gr + c, gv);
    load_w4(w, c, vec, wv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xv[e] = xv[e] * r;
      gv[e] = gv[e] * wv[e];
      dot += gv[e] * xv[e];
    }
    if (kStage) {
      stage4(s_xhat, c, svec, xv);
      stage4(s_dxhat, c, svec, gv);
    }
  }
  for (int c = tail + threadIdx.x; c < h; c += kThreads) {
    const float xv = to_f(xr[c]) * r, gv = to_f(gr[c]) * to_f(w[c]);
    dot += gv * xv;
    if (kStage) {
      s_xhat[c] = xv;
      s_dxhat[c] = gv;
    }
  }
  const float m = block_sum(dot, s_red) / (float)h;
  for (int c = threadIdx.x; c < head; c += kThreads) {
    const float xv = kStage ? s_xhat[c] : to_f(xr[c]) * r;
    const float gv = kStage ? s_dxhat[c] : to_f(gr[c]) * to_f(w[c]);
    dr[c] = from_f<TX>(r * (gv - xv * m));
  }
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int c = head + 4 * i;
    float xv[4], gv[4];
    if (kStage) {
      unstage4(s_xhat, c, svec, xv);
      unstage4(s_dxhat, c, svec, gv);
    } else {
      float wv[4];
      load4(xr + c, xv);
      load4(gr + c, gv);
      load_w4(w, c, vec, wv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[e] = xv[e] * r;
        gv[e] = gv[e] * wv[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[e] = r * (gv[e] - xv[e] * m);
    store4(dr + c, gv);
  }
  for (int c = tail + threadIdx.x; c < h; c += kThreads) {
    const float xv = kStage ? s_xhat[c] : to_f(xr[c]) * r;
    const float gv = kStage ? s_dxhat[c] : to_f(gr[c]) * to_f(w[c]);
    dr[c] = from_f<TX>(r * (gv - xv * m));
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename TX, typename TW>
cudaError_t fwd(const void* x, const void* w, void* out, float* rstd, int n,
                int h, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)h;
  const bool stage = smem <= kSmemLimit;
  auto kernel = stage ? rms_norm_fwd_kernel<TX, TW, true>
                      : rms_norm_fwd_kernel<TX, TW, false>;
  const size_t dyn = stage ? smem : 0;
  cudaError_t e = allow_smem(kernel, dyn);
  if (e != cudaSuccess) return e;
  kernel<<<n, kThreads, dyn, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), rstd, h, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t bwd(const void* x, const void* w, const float* rstd,
                const void* dy, void* dx, int n, int h,
                cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)h;
  const bool stage = smem <= kSmemLimit;
  auto kernel = stage ? rms_norm_bwd_kernel<TX, TW, true>
                      : rms_norm_bwd_kernel<TX, TW, false>;
  const size_t dyn = stage ? smem : 0;
  cudaError_t e = allow_smem(kernel, dyn);
  if (e != cudaSuccess) return e;
  kernel<<<n, kThreads, dyn, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), rstd,
      static_cast<const TX*>(dy), static_cast<TX*>(dx), h);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.
template <typename TX>
cudaError_t fwd_w(int w_dtype, const void* x, const void* w, void* out,
                  float* rstd, int n, int h, float eps, cudaStream_t s) {
  if (w_dtype == 0) return fwd<TX, float>(x, w, out, rstd, n, h, eps, s);
  if (w_dtype == 1)
    return fwd<TX, __nv_bfloat16>(x, w, out, rstd, n, h, eps, s);
  if (w_dtype == 2) return fwd<TX, __half>(x, w, out, rstd, n, h, eps, s);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t bwd_w(int w_dtype, const void* x, const void* w,
                  const float* rstd, const void* dy, void* dx, int n, int h,
                  cudaStream_t s) {
  if (w_dtype == 0) return bwd<TX, float>(x, w, rstd, dy, dx, n, h, s);
  if (w_dtype == 1)
    return bwd<TX, __nv_bfloat16>(x, w, rstd, dy, dx, n, h, s);
  if (w_dtype == 2) return bwd<TX, __half>(x, w, rstd, dy, dx, n, h, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Both launch on `stream`, whose device must be the calling thread's
// current one (the Python wrapper selects it), and return 0 on success,
// else the CUDA error code of the refused launch (cudaErrorInvalidValue
// for a shape or dtype this kernel does not take).  dtype codes:
// 0 = float32, 1 = bfloat16, 2 = float16, for x and w each.  x, out, dy,
// dx are [n, h] contiguous (x, dy and dx at the same element offset
// modulo 4); w is [h]; rstd [n].
extern "C" int rms_norm_fwd_launch(const void* x, const void* w, void* out,
                                   void* rstd, int n, int h, float eps,
                                   int x_dtype, int w_dtype, void* stream) {
  if (n <= 0 || h <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<float*>(rstd);
  if (x_dtype == 0) return fwd_w<float>(w_dtype, x, w, out, r, n, h, eps, s);
  if (x_dtype == 1)
    return fwd_w<__nv_bfloat16>(w_dtype, x, w, out, r, n, h, eps, s);
  if (x_dtype == 2) return fwd_w<__half>(w_dtype, x, w, out, r, n, h, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" int rms_norm_bwd_launch(const void* x, const void* w,
                                   const void* rstd, const void* dy,
                                   void* dx, int n, int h, int x_dtype,
                                   int w_dtype, void* stream) {
  if (n <= 0 || h <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rstd);
  if (x_dtype == 0) return bwd_w<float>(w_dtype, x, w, r, dy, dx, n, h, s);
  if (x_dtype == 1)
    return bwd_w<__nv_bfloat16>(w_dtype, x, w, r, dy, dx, n, h, s);
  if (x_dtype == 2) return bwd_w<__half>(w_dtype, x, w, r, dy, dx, n, h, s);
  return cudaErrorInvalidValue;
}
