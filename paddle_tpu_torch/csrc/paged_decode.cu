// Paged-decode attention for Hopper (sm_90a): split-K flash-decoding over
// pages brought into shared memory by bulk copies.  Plain C interface.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels/
// paged_decode.py: _kernel / _call (f32 and bf16 pools) and
// _kernel_quant / _call_quant (int8 pools with per-page f32 scales,
// PT_QUANT=int8).  Single-token decode attention over a block-table
// (paged) KV cache; for each (sequence b, kv head, query row g):
//
//     s[t]   = (q[b, kv, g] * scale) . K[page_indices[b, t / ps], t % ps]
//     p      = softmax over t < lengths[b]   (fp32)
//     out[g] = sum_t p[t] * V[...]           (fp32 accumulate)
//
// Layouts (all contiguous):
//   q, out        [B, KV, G, D]   (== [B, H, D] with h = kv * G + g)
//   k/v_pages     [KV, P, ps, D]  one layer of the pool
//   k/v_scales    [KV, P]  f32    (int8 pools only)
//   lengths       [B]      int32  valid tokens per sequence
//   page_indices  [B, pps] int32  each sequence's page-table row
//
// Bound: the K/V bytes under the lengths, 2 * sum_b(len_b) * KV * D *
// itemsize, at 3.35 TB/s.  A decode step does 2-4 flops per K/V byte, far
// below the card's ~295 flop/byte ridge, so tensor cores do not pay (and
// rounding q to bf16 for them would leave fp32's tolerance): the math is
// fp32 on the CUDA cores and the design is about keeping bytes in flight
// on every SM.  The TPU kernel DMAs a head's whole window into VMEM and
// takes one dense softmax; an SM holds 227 KB, a 1024-token bf16 window
// 512 KB.  So the window is split over blocks and only a ring of pages
// lives in shared memory:
//
//   * split-K: the grid is (b * KV + kv, split, q-row tile).  A split is a
//     fixed run of `split_pages` whole pages; the host takes it from the
//     shapes, never from the lengths (no host sync: the launch can be
//     captured by a CUDA graph).  A block whose split starts at or past its
//     sequence's length returns at once and writes nothing; the combine
//     reads only the splits under the length, so no merge reads scratch
//     that no block wrote.
//   * bulk copies through an mbarrier ring: a page of one kv head is
//     contiguous in the pool (ps * D * itemsize bytes), so one producer
//     thread streams the split's pages, K and V, into kStages stages with
//     cp.async.bulk, each stage's `full` barrier expecting the bytes and its
//     `empty` barrier counting the consumer warps out.  Only rows under the
//     length are copied; table entries past ceil(len / ps) are never read.
//     A page wider than kTileBytes is streamed in tiles of rows.
//   * one pass, a warp per page: tile u goes to consumer warp
//     u % kConsumers, so the kConsumers warps work on different stages at
//     once and each stage has one consumer (its `empty` barrier counts one
//     arrival).  A warp splits into lane groups of LPT lanes, one token row
//     per group; a lane holds EPL = D / LPT elements of the row in 16-byte
//     chunks (conflict-free shared-memory reads).  A group takes R rows a
//     step: their dots are reduced across the group by shuffles together,
//     the running max m raised once, and the group's sum l and fp32
//     accumulator over its columns (per query row of its tile) rescaled
//     only when m grows (the online softmax, exp2 with log2(e) folded into
//     q's scale).  K and V of a stage are used together.  Rows at or past
//     the length are skipped, never multiplied by p = 0: the tail of a
//     last page may hold anything, NaN included.
//   * int8: the page's k scale multiplies the dot and its v scale the
//     probability, read once per page; a byte widens exactly as the float
//     2^23 + (b + 128) built by one byte permute, less 2^23 + 128 (the
//     int-to-float conversion runs at a quarter of the FMA rate).
//   * the groups' (m, l, acc) merge by shuffles within a warp and through
//     shared memory across warps, in a fixed order; the block writes its
//     split's partial:
//     acc [B, KV, n_split, G, D], m and l [B, KV, n_split, G] (f32 scratch
//     the wrapper allocates).
//   * a second kernel merges each (b, kv, g)'s partials in fixed split
//     order, out = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s (so results
//     are deterministic), and casts once to q's dtype.  It is launched as
//     a programmatic dependent of the first (its blocks are scheduled
//     while the last splits run and wait on griddepcontrol.wait).  A
//     length of 0 writes zeros.  Lengths above pps * ps are clamped.
//
// No cap on the window (shared memory holds only the ring) or on the group
// (q-row tiles of at most 8 rows, 4 at D = 256, on the grid).  D is 64,
// 128 or 256.  Every kernel of the int8 route has paged_decode_quant in its
// name, so a profile that bills device time by name keeps the two apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 4;                    // consumer warps
constexpr int kThreads = (kConsumers + 1) * 32;  // + one producer warp
constexpr int kStages = 4;                       // ring depth
// a stage is only ever consumed by one warp (tile u goes to warp
// u % kConsumers), so a warp never waits on a phase a round ahead
static_assert(kStages % kConsumers == 0, "stages per consumer warp");
constexpr int kMaxSplitPages = 64;               // split_pages cap
constexpr int kTileBytes = 16384;                // K (and V) bytes a stage
constexpr int kMaxSmem = 232448;                 // a block's shared memory
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* page_indices;
  const float* k_scales;  // int8 pools only
  const float* v_scales;
  float* part_acc;  // [B, KV, n_split, G, D]
  float* part_m;    // [B, KV, n_split, G]
  float* part_l;    // [B, KV, n_split, G]
  void* out;
  int B, KV, G, P, ps, pps;
  int split_pages, n_split, tile_rows;
  float scale;  // softmax scale times log2(e)
};

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

// How a warp's lanes cover K/V rows for D and a q-row tile of GT rows.
template <typename TKV, int D, int GT>
struct Shape {
  // lanes per token row: 8 to 32, so that q and the accumulators of the
  // tile take GT * EPL <= 32 registers each
  static constexpr int LPT =
      D * GT / 32 < 8 ? 8 : (D * GT / 32 > 32 ? 32 : D * GT / 32);
  static constexpr int TPW = 32 / LPT;            // rows per warp step
  static constexpr int EPL = D / LPT;             // row elements per lane
  static constexpr int ISZ = (int)sizeof(TKV);
  static constexpr int CB = EPL * ISZ < 16 ? EPL * ISZ : 16;  // chunk bytes
  static constexpr int VEC = CB / ISZ;  // elements per chunk
  static constexpr int NCH = EPL / VEC;  // chunks per lane
  static constexpr int WORDS = CB / 4;
  static_assert(CB % 4 == 0 && EPL % VEC == 0, "chunking");
  // column of a lane's element i: chunks lig, lig + LPT, ... of the row
  static __device__ __forceinline__ int col(int lig, int i) {
    return (lig + LPT * (i / VEC)) * VEC + i % VEC;
  }
};

// Widens one lane's EPL elements of a K/V row in shared memory.
template <typename TKV, typename S>
__device__ __forceinline__ void load_row(const TKV* row, int lig,
                                         float (&r)[S::EPL]) {
#pragma unroll
  for (int j = 0; j < S::NCH; ++j) {
    const void* p = row + (lig + S::LPT * j) * S::VEC;
    uint32_t w[S::WORDS];
    if constexpr (S::WORDS == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (S::WORDS == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    float* o = r + j * S::VEC;
#pragma unroll
    for (int i = 0; i < S::WORDS; ++i) {
      if constexpr (std::is_same<TKV, float>::value) {
        o[i] = __uint_as_float(w[i]);
      } else if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {  // int8: 2^23 + (b + 128) built by a byte permute, exact
        const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o[4 * i + k] =
              __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + k)) -
              8388736.f;
      }
    }
  }
}

__host__ __device__ constexpr size_t header_bytes(int GT, int D) {
  return 2 * kStages * sizeof(uint64_t) +
         3 * kMaxSplitPages * sizeof(float) +
         (size_t)kConsumers * GT * (D + 2) * sizeof(float);
}

// Merge weight of a partial with max m against the merged max mx; an
// empty partial (m = -inf) weighs 0.
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

// One block: split blockIdx.y of (b, kv) = blockIdx.x, q rows
// [blockIdx.z * GT, + GT) of the group.
template <typename TQ, typename TKV, int D, int GT, bool kQuant>
__device__ __forceinline__ void split_body(const Params& a, uint8_t* smem) {
  using S = Shape<TKV, D, GT>;
  const int bk = blockIdx.x;
  const int b = bk / a.KV;
  const int kv = bk % a.KV;
  const int split = blockIdx.y;
  const int g0 = blockIdx.z * GT;
  const int window = a.pps * a.ps;
  const int page0 = split * a.split_pages;
  // the split's table entries load beside the length (entries inside the
  // row are safe to read; only pages under the length are dereferenced)
  const int* row = a.page_indices + (size_t)b * a.pps + page0;
  const int t = threadIdx.x;
  const int pid = t < a.split_pages && page0 + t < a.pps ? row[t] : 0;
  int len = a.lengths[b];
  len = len < 0 ? 0 : (len > window ? window : len);
  const int tok0 = page0 * a.ps;
  hopper::launch_dependents();  // the combine may be scheduled
  if (tok0 >= len) return;  // the combine reads only splits under len

  // tiles of this split under the length (a tile is one page unless a
  // page is wider than kTileBytes)
  const int ntok = min(a.split_pages * a.ps, len - tok0);
  const int npages = (ntok + a.ps - 1) / a.ps;
  const int tpp = (a.ps + a.tile_rows - 1) / a.tile_rows;  // tiles a page
  const int last_rows = ntok - (npages - 1) * a.ps;
  const int ntiles =
      (npages - 1) * tpp + (last_rows + a.tile_rows - 1) / a.tile_rows;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  int* s_pid = reinterpret_cast<int*>(empty + kStages);
  float* s_ksc = reinterpret_cast<float*>(s_pid + kMaxSplitPages);
  float* s_vsc = s_ksc + kMaxSplitPages;
  float* s_m = s_vsc + kMaxSplitPages;  // [kConsumers, GT]
  float* s_l = s_m + kConsumers * GT;   // [kConsumers, GT]
  float* s_acc = s_l + kConsumers * GT;  // [kConsumers, GT, D]
  uint8_t* ring = smem + header_bytes(GT, D);
  ring += (128u - (hopper::su32(ring) & 127u)) & 127u;
  const size_t stage = (size_t)a.tile_rows * D;  // elements of K (or V)
  TKV* ring_kv = reinterpret_cast<TKV*>(ring);   // [kStages, 2, stage]

  const size_t head = (size_t)kv * a.P;  // this head's first pool page
  if (t < npages) {
    s_pid[t] = pid;
    if constexpr (kQuant) {
      s_ksc[t] = a.k_scales[head + pid];
      s_vsc[t] = a.v_scales[head + pid];
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::bar_init(full + s, 1);
      hopper::bar_init(empty + s, 1);  // the tile's one consumer warp
    }
    hopper::bar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumers) {  // the producer
    if (lane == 0) {
      const TKV* kp = static_cast<const TKV*>(a.k_pages);
      const TKV* vp = static_cast<const TKV*>(a.v_pages);
      for (int u = 0; u < ntiles; ++u) {
        const int s = u % kStages;
        if (u >= kStages) hopper::bar_wait(empty + s, (u / kStages - 1) & 1);
        const int pi = u / tpp;
        const int r0 = (u % tpp) * a.tile_rows;
        const int rows = min(min(a.tile_rows, a.ps - r0),
                             len - (tok0 + pi * a.ps + r0));
        const uint32_t bytes = (uint32_t)(rows * D * sizeof(TKV));
        const size_t off = ((head + s_pid[pi]) * a.ps + r0) * D;
        hopper::bar_expect(full + s, 2 * bytes);
        hopper::bulk_copy(ring_kv + 2 * s * stage, kp + off, bytes, full + s);
        hopper::bulk_copy(ring_kv + (2 * s + 1) * stage, vp + off, bytes,
                          full + s);
      }
    }
    return;
  }

  const int grp = lane / S::LPT;
  const int lig = lane % S::LPT;
  float qr[GT][S::EPL];
  const TQ* q = static_cast<const TQ*>(a.q) + (size_t)bk * a.G * D;
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int i = 0; i < S::EPL; ++i)
      qr[g][i] = g0 + g < a.G
                     ? to_float(q[(g0 + g) * D + S::col(lig, i)]) * a.scale
                     : 0.f;
  float m[GT], l[GT], acc[GT][S::EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < S::EPL; ++i) acc[g][i] = 0.f;
  }

  // warp w consumes tiles w, w + kConsumers, ...: the warps work on
  // different stages at once; a group takes R rows a step, their scores
  // reduced together and the max raised once
  constexpr int R = S::EPL >= 32 ? 2 : 4;
  for (int u = warp; u < ntiles; u += kConsumers) {
    const int s = u % kStages;
    hopper::bar_wait(full + s, (u / kStages) & 1);
    const int pi = u / tpp;
    const int r0 = (u % tpp) * a.tile_rows;
    const int rows =
        min(min(a.tile_rows, a.ps - r0), len - (tok0 + pi * a.ps + r0));
    const float ksc = kQuant ? s_ksc[pi] : 1.f;
    const float vsc = kQuant ? s_vsc[pi] : 1.f;
    const TKV* kt = ring_kv + 2 * s * stage;
    const TKV* vt = kt + stage;
    for (int rb = 0; rb < rows; rb += R * S::TPW) {
      float sc[R][GT];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = rb + j * S::TPW + grp;
        float kr[S::EPL];
        if (r < rows) {
          load_row<TKV, S>(kt + r * D, lig, kr);
        } else {
#pragma unroll
          for (int i = 0; i < S::EPL; ++i) kr[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int i = 0; i < S::EPL; i += 2) {
            d0 += qr[g][i] * kr[i];
            d1 += qr[g][i + 1] * kr[i + 1];
          }
          sc[j][g] = d0 + d1;
        }
      }
#pragma unroll
      for (int o = S::LPT / 2; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int g = 0; g < GT; ++g)
            sc[j][g] += __shfl_xor_sync(0xffffffffu, sc[j][g], o);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float mx = m[g];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sc[j][g] *= ksc;
          if (rb + j * S::TPW + grp < rows) mx = fmaxf(mx, sc[j][g]);
        }
        if (mx > m[g]) {  // the max grew: rescale what was summed
          const float c = exp2f(m[g] - mx);
          l[g] *= c;
#pragma unroll
          for (int i = 0; i < S::EPL; ++i) acc[g][i] *= c;
          m[g] = mx;
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = rb + j * S::TPW + grp;
        if (r < rows) {  // a row past the length is skipped
          float vr[S::EPL];
          load_row<TKV, S>(vt + r * D, lig, vr);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float p = exp2f(sc[j][g] - m[g]);
            l[g] += p;
            const float pv = p * vsc;
#pragma unroll
            for (int i = 0; i < S::EPL; ++i) acc[g][i] += pv * vr[i];
          }
        }
      }
    }
    hopper::release(empty + s, lane);
  }

  // merge the warp's row groups (lane lig of every group holds the same
  // columns), then the warps through shared memory, in a fixed order
#pragma unroll
  for (int o = S::LPT; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], m2);
      const float c1 = weight(m[g], mx);
      const float c2 = weight(m2, mx);
      l[g] = c1 * l[g] + c2 * l2;
#pragma unroll
      for (int i = 0; i < S::EPL; ++i) {
        const float x2 = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = c1 * acc[g][i] + c2 * x2;
      }
      m[g] = mx;
    }
  }
  if (lane < S::LPT) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        s_m[warp * GT + g] = m[g];
        s_l[warp * GT + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < S::EPL; ++i)
        s_acc[(warp * GT + g) * D + S::col(lig, i)] = acc[g][i];
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 32) : "memory");
  const size_t base = ((size_t)bk * a.n_split + split) * a.G + g0;
  for (int i = threadIdx.x; i < GT * D; i += kConsumers * 32) {
    const int g = i / D;
    const int d = i % D;
    if (g0 + g >= a.G) break;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, s_m[w * GT + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float c = weight(s_m[w * GT + g], mx);
      num += c * s_acc[(w * GT + g) * D + d];
      den += c * s_l[w * GT + g];
    }
    a.part_acc[(base + g) * D + d] = num;
    if (d == 0) {
      a.part_m[base + g] = mx;
      a.part_l[base + g] = den;
    }
  }
}

// One block of D threads per (b, kv, g): the splits under the length,
// merged in split order.
template <typename TQ>
__device__ __forceinline__ void combine_body(const Params& a) {
  hopper::wait_primary();  // the split kernel's partials are written
  const int D = blockDim.x;
  const int bkg = blockIdx.x;  // (b * KV + kv) * G + g
  const int g = bkg % a.G;
  const int bk = bkg / a.G;
  const int b = bk / a.KV;
  const int window = a.pps * a.ps;
  int len = a.lengths[b];
  len = len < 0 ? 0 : (len > window ? window : len);
  const int split_tokens = a.split_pages * a.ps;
  const int n = (len + split_tokens - 1) / split_tokens;
  const size_t row0 = (size_t)bk * a.n_split * a.G + g;  // split 0's row
  float mx = -INFINITY;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, a.part_m[row0 + s * a.G]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n; ++s) {
    const size_t row = row0 + (size_t)s * a.G;
    const float c = exp2f(a.part_m[row] - mx);
    num += c * a.part_acc[row * D + threadIdx.x];
    den += c * a.part_l[row];
  }
  static_cast<TQ*>(a.out)[(size_t)bkg * D + threadIdx.x] =
      from_float<TQ>(n == 0 ? 0.f : num / den);
}

template <typename TQ, typename TKV, int D, int GT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const Params a) {
  extern __shared__ __align__(128) uint8_t smem[];
  split_body<TQ, TKV, D, GT, false>(a, smem);
}

template <typename TQ, int D, int GT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_quant_split_kernel(const Params a) {
  extern __shared__ __align__(128) uint8_t smem[];
  split_body<TQ, int8_t, D, GT, true>(a, smem);
}

template <typename TQ>
__global__ void __launch_bounds__(256)
    paged_decode_combine_kernel(const Params a) {
  combine_body<TQ>(a);
}

template <typename TQ>
__global__ void __launch_bounds__(256)
    paged_decode_quant_combine_kernel(const Params a) {
  combine_body<TQ>(a);
}

// Allows the largest shared memory and the largest carveout (the ring is
// filled by bulk copies, not through L1).
template <typename K>
cudaError_t prefer_shared(K kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename TQ, typename TKV, int D, int GT>
cudaError_t launch(Params a, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  const int row_bytes = D * (int)sizeof(TKV);
  a.tile_rows = kTileBytes / row_bytes < a.ps ? kTileBytes / row_bytes : a.ps;
  const size_t smem = header_bytes(GT, D) + 128 +
                      (size_t)kStages * 2 * a.tile_rows * row_bytes;
  const dim3 grid(a.B * a.KV, a.n_split, (a.G + GT - 1) / GT);
  static unsigned attrs_set = 0;  // a bit per device, for this kernel
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool set = dev < 32 && (attrs_set >> dev & 1u);
  // the combine launches as a programmatic dependent of the split kernel:
  // its blocks are scheduled while the last splits run, and wait for them
  cudaLaunchConfig_t combine{};
  combine.gridDim = dim3(a.B * a.KV * a.G);
  combine.blockDim = dim3(D);
  combine.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  combine.attrs = pdl;
  combine.numAttrs = 1;
  if constexpr (kQuant) {
    auto split = paged_decode_quant_split_kernel<TQ, D, GT>;
    if (!set && (e = prefer_shared(split)) != cudaSuccess) return e;
    split<<<grid, kThreads, smem, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&combine, paged_decode_quant_combine_kernel<TQ>, a);
  } else {
    auto split = paged_decode_split_kernel<TQ, TKV, D, GT>;
    if (!set && (e = prefer_shared(split)) != cudaSuccess) return e;
    split<<<grid, kThreads, smem, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&combine, paged_decode_combine_kernel<TQ>, a);
  }
  if (e != cudaSuccess) return e;
  if (dev < 32) attrs_set |= 1u << dev;
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t by_tile(const Params& a, int q_tile, cudaStream_t stream) {
  if (q_tile == 1) return launch<TQ, TKV, D, 1>(a, stream);
  if (q_tile == 2) return launch<TQ, TKV, D, 2>(a, stream);
  if (q_tile == 4) return launch<TQ, TKV, D, 4>(a, stream);
  if constexpr (D <= 128) {
    if (q_tile == 8) return launch<TQ, TKV, D, 8>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t by_head_dim(const Params& a, int D, int q_tile,
                        cudaStream_t stream) {
  if (a.B <= 0 || a.KV <= 0 || a.G <= 0) return cudaSuccess;  // no work
  if (a.split_pages < 1 || a.split_pages > kMaxSplitPages ||
      a.n_split < 1 || a.n_split > 65535 ||
      (long long)a.n_split * a.split_pages < a.pps)
    return cudaErrorInvalidValue;
  if (D == 64) return by_tile<TQ, TKV, 64>(a, q_tile, stream);
  if (D == 128) return by_tile<TQ, TKV, 128>(a, q_tile, stream);
  if (D == 256) return by_tile<TQ, TKV, 256>(a, q_tile, stream);
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k_pages, const void* v_pages,
                   const void* lengths, const void* page_indices,
                   const void* k_scales, const void* v_scales, void* out,
                   void* scratch, int B, int KV, int G, int D, int P, int ps,
                   int pps, int split_pages, int n_split, float scale) {
  const size_t rows = (size_t)B * KV * n_split * G;
  float* part = static_cast<float*>(scratch);
  return Params{q,
                k_pages,
                v_pages,
                static_cast<const int*>(lengths),
                static_cast<const int*>(page_indices),
                static_cast<const float*>(k_scales),
                static_cast<const float*>(v_scales),
                part,
                part + rows * D,
                part + rows * (D + 1),
                out,
                B,
                KV,
                G,
                P,
                ps,
                pps,
                split_pages,
                n_split,
                0,
                scale * kLog2e};
}

}  // namespace

// Launches both kernels on `stream`, whose device must be the calling
// thread's current one (the Python wrapper selects it).  `scratch` is
// B * KV * n_split * G * (D + 2) floats: the partial accumulators, then m,
// then l.  split_pages and n_split come from the wrapper's split plan (n_split
// * split_pages >= pps), q_tile is 1, 2, 4 or 8 (at most 4 at D = 256).
// Returns 0 on success, else the CUDA error code of the refused launch
// (cudaErrorInvalidValue for a shape or dtype this kernel does not take).
// dtype codes: 0 = float32, 1 = bfloat16.  Takes (q, pool) dtype pairs
// (f32, f32), (f32, bf16) and (bf16, bf16).
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* lengths,
                                   const void* page_indices, void* out,
                                   void* scratch, int B, int KV, int G, int D,
                                   int P, int ps, int pps, int split_pages,
                                   int n_split, int q_tile, float scale,
                                   int q_dtype, int kv_dtype, void* stream) {
  const Params a = make_params(q, k_pages, v_pages, lengths, page_indices,
                               nullptr, nullptr, out, scratch, B, KV, G, D, P,
                               ps, pps, split_pages, n_split, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return by_head_dim<float, float>(a, D, q_tile, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_head_dim<float, __nv_bfloat16>(a, D, q_tile, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(a, D, q_tile, st);
  return cudaErrorInvalidValue;
}

// The int8-pool twin: k/v_pages int8 [KV, P, ps, D], k/v_scales float32
// [KV, P].  Takes q float32 or bfloat16 (q_dtype 0 or 1); otherwise as
// paged_decode_launch.
extern "C" int paged_decode_quant_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* page_indices, const void* k_scales,
    const void* v_scales, void* out, void* scratch, int B, int KV, int G,
    int D, int P, int ps, int pps, int split_pages, int n_split, int q_tile,
    float scale, int q_dtype, void* stream) {
  const Params a = make_params(q, k_pages, v_pages, lengths, page_indices,
                               k_scales, v_scales, out, scratch, B, KV, G, D,
                               P, ps, pps, split_pages, n_split, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return by_head_dim<float, int8_t>(a, D, q_tile, st);
  if (q_dtype == 1) return by_head_dim<__nv_bfloat16, int8_t>(a, D, q_tile, st);
  return cudaErrorInvalidValue;
}
