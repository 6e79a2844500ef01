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
// Design (simple first): one block of 256 threads per row.  The row is
// read from device memory ONCE, four elements per thread per load, into
// shared memory as fp32 (h floats; x and dy in the backward), while each
// thread sums its squares (or its dxhat * xhat) in fp32; a warp-shuffle
// plus shared-memory reduction gives the row sum to every thread; the
// output pass then reads shared memory only.  Any N works: there is no
// padding to a row-block size (the TPU version pads rows to 256).
// h must be a multiple of 4 and 8 * h bytes must fit in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
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

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ out, float* __restrict__ rstd, int h,
                    float eps) {
  extern __shared__ float s_x[];  // [h] the row in fp32
  __shared__ float s_red[kWarps];
  const size_t row = (size_t)blockIdx.x * h;
  float ss = 0.f;
  for (int c = threadIdx.x * 4; c < h; c += kThreads * 4) {
    float v[4];
    load4(x + row + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) ss += v[e] * v[e];
    store4(s_x + c, v);
  }
  const float r = 1.f / sqrtf(block_sum(ss, s_red) / (float)h + eps);
  for (int c = threadIdx.x * 4; c < h; c += kThreads * 4) {
    float v[4], wv[4];
    load4(s_x + c, v);
    load4(w + c, wv);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = v[e] * r * wv[e];
    store4(out + row + c, v);
  }
  if (threadIdx.x == 0) rstd[blockIdx.x] = r;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ rstd,
                    const TX* __restrict__ dy, TX* __restrict__ dx, int h) {
  extern __shared__ float smem[];
  float* s_xhat = smem;      // [h] x * rstd
  float* s_dxhat = smem + h; // [h] dy * w
  __shared__ float s_red[kWarps];
  const size_t row = (size_t)blockIdx.x * h;
  const float r = rstd[blockIdx.x];
  float dot = 0.f;
  for (int c = threadIdx.x * 4; c < h; c += kThreads * 4) {
    float xv[4], gv[4], wv[4];
    load4(x + row + c, xv);
    load4(dy + row + c, gv);
    load4(w + c, wv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xv[e] = xv[e] * r;
      gv[e] = gv[e] * wv[e];
      dot += gv[e] * xv[e];
    }
    store4(s_xhat + c, xv);
    store4(s_dxhat + c, gv);
  }
  const float m = block_sum(dot, s_red) / (float)h;
  for (int c = threadIdx.x * 4; c < h; c += kThreads * 4) {
    float xv[4], gv[4];
    load4(s_xhat + c, xv);
    load4(s_dxhat + c, gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[e] = r * (gv[e] - xv[e] * m);
    store4(dx + row + c, gv);
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
  auto kernel = rms_norm_fwd_kernel<TX, TW>;
  const size_t smem = sizeof(float) * (size_t)h;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<n, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), rstd, h, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t bwd(const void* x, const void* w, const float* rstd,
                const void* dy, void* dx, int n, int h,
                cudaStream_t stream) {
  auto kernel = rms_norm_bwd_kernel<TX, TW>;
  const size_t smem = 2 * sizeof(float) * (size_t)h;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<n, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), rstd,
      static_cast<const TX*>(dy), static_cast<TX*>(dx), h);
  return cudaGetLastError();
}

}  // namespace

// Both launch on `stream`, whose device must be the calling thread's
// current one (the Python wrapper selects it), and return 0 on success,
// else the CUDA error code of the refused launch (cudaErrorInvalidValue
// for a shape or dtype this kernel does not take).  dtype codes:
// 0 = float32, 1 = bfloat16; (x, w) pairs (f32, f32), (bf16, f32) and
// (bf16, bf16).  x, out, dy, dx are [n, h] contiguous; w is [h]; rstd [n].
extern "C" int rms_norm_fwd_launch(const void* x, const void* w, void* out,
                                   void* rstd, int n, int h, float eps,
                                   int x_dtype, int w_dtype, void* stream) {
  if (n <= 0 || h <= 0 || h % 4) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<float*>(rstd);
  if (x_dtype == 0 && w_dtype == 0)
    return fwd<float, float>(x, w, out, r, n, h, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return fwd<__nv_bfloat16, float>(x, w, out, r, n, h, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return fwd<__nv_bfloat16, __nv_bfloat16>(x, w, out, r, n, h, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" int rms_norm_bwd_launch(const void* x, const void* w,
                                   const void* rstd, const void* dy,
                                   void* dx, int n, int h, int x_dtype,
                                   int w_dtype, void* stream) {
  if (n <= 0 || h <= 0 || h % 4) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rstd);
  if (x_dtype == 0 && w_dtype == 0)
    return bwd<float, float>(x, w, r, dy, dx, n, h, s);
  if (x_dtype == 1 && w_dtype == 0)
    return bwd<__nv_bfloat16, float>(x, w, r, dy, dx, n, h, s);
  if (x_dtype == 1 && w_dtype == 1)
    return bwd<__nv_bfloat16, __nv_bfloat16>(x, w, r, dy, dx, n, h, s);
  return cudaErrorInvalidValue;
}
