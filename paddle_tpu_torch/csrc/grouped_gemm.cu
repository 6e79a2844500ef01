// Grouped expert FFN for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_kernels/
// grouped_gemm.py: _pallas_ffn (_kernel), the expert FFN of the MoE block
// on sort-dispatched buckets, and _pallas_ffn_q (_qkernel), the same over
// int8 expert weights:
//
//     out[e] = cast_to_x_dtype(act(x[e] @ w1[e] + b1[e]) @ w2[e] + b2[e])
//     int8:    h = act((x[e] @ q1[e]) * s1[e] + b1[e])
//              out[e] = cast((h @ q2[e]) * s2[e] + b2[e])
//
// Layouts (all contiguous, row-major):
//   x   [E, C, H]  float32 or bfloat16       out [E, C, H]  x's dtype
//   w1  [E, H, F]  x's dtype, or int8        s1  [E, F]     float32 (int8)
//   w2  [E, F, H]  x's dtype, or int8        s2  [E, H]     float32 (int8)
//   b1  [E, F]     float32                   b2  [E, H]     float32
// (the wrapper casts the biases to float32.)
//
// As in the TPU kernel, x and the weights are widened to f32 products
// (bf16 x bf16 and int8 -> bf16 x bf16 products are exact in f32), s1
// scales the f32 first product before b1 and the activation, the hidden
// h = act(...) is f32 and never rounded to bf16 once, and the f32 sum is
// cast once.
//
// Bound.  4 * E * C * H * F flops: at MoE training sizes (C in the
// thousands) that is the bf16 tensor-core rate (0.93 ms at E = 8,
// C = 2560, H = 2048, F = 5504); at a decode-sized C the expert weights,
// read once, over the memory rate.
//
// 1. bf16 x: two warp-specialised grouped GEMMs on the tensor cores
//    (gffn_wg_kernel<weight type, pass>), each out[M, N] = A[M, K] . B[K, N]
//    per expert with B row-major ([K, N], so MN-major for wgmma):
//      pass 1: A = x, B = w1 (K = H, N = F).  Epilogue in f32: x s1, + b1,
//              the activation, then h split into two bf16 terms,
//              hi = bf16(h) and lo = bf16(h - hi) (about 16 bits of h),
//              stored to two [E, C, F] bf16 scratch tensors.
//      pass 2: A = h_hi and h_lo, B = w2 (K = F, N = H): every k step runs
//              h_hi . w2 and h_lo . w2 into one f32 sum, so w2 is loaded
//              once per F chunk.  Epilogue: x s2 (int8), + b2, one cast.
//              _qkernel scales each F block's contribution by s2 before
//              adding it; scaling the f32 sum once is the same in exact
//              arithmetic, since s2 is constant over F.
//    Why h leaves the SM.  The TPU kernel kept a [bc, H] f32 row block in
//    VMEM across the F blocks (1 MB at bc = 128, H = 2048).  An SM has
//    227 KB of shared memory and 256 KB of registers, so a tile of 64 rows
//    or more cannot hold all H columns while it walks F; 16 rows can (the
//    first port did that), but then every weight byte moves through the
//    SM's load path for only 16 rows of products, which bounded it at 5%
//    of the tensor cores.  Here h makes one round trip through device
//    memory instead: 4 E C F bytes (hi + lo; 451 MB at the bench bucket,
//    about 0.27 ms at 3.35 TB/s, under both GEMMs' compute) and every
//    weight byte feeds 128 rows.  The later alternative that keeps h on
//    chip: a cluster of 8 blocks sharing one row block's h through
//    distributed shared memory, with x multicast to them by TMA.
//    Shape of each kernel.  One block per (256 output columns, 128 rows,
//    expert[, K split]), ordered expert-major with the column tiles of one
//    row block adjacent, so an expert's weight panels and a row block's
//    x / h stay in the 50 MB L2.  384 threads: a producer warpgroup
//    (setmaxnreg 24) whose one thread issues every TMA load, and two
//    consumer warpgroups (240 registers) that each own 64 rows, an
//    m64 x n256 f32 sum (128 registers), and run wgmma m64n256k16 with
//    both operands in shared memory: A K-major, B MN-major, 128-byte
//    swizzle.  K steps of 64 stream through an mbarrier ring (full /
//    empty per stage): pass 1 four stages of x 16 KB + w1 32 KB, pass 2
//    three of h_hi 16 + h_lo 16 + w2 32 KB.  Each step's products are
//    one commit group; the stage of step i - 1 is freed once group i - 1
//    is done (wait_group 1).  TMA reads x, h and the weights through 3-D
//    tensor maps ([E, rows, cols]), so rows past C, columns past N and k
//    past K arrive as zeros and no edge is masked in the main loop.
//    Epilogue: the f32 tile is staged through the idle ring ([128][264]
//    floats), then each thread takes 8 adjacent columns (bias and scale
//    loaded once) of every 8th row, in a loop that is not unrolled, and
//    writes 16-byte stores; only rows < C and columns < N are stored.
//    (An epilogue straight from the registers inlines the activation's
//    five-way switch 128 times in the unrolled loop; that was slower.)
//    Int8 weights.  TMA brings the raw int8 tile ([64, 256], 16 KB, no
//    swizzle); the consumer warpgroups widen it into a bf16 tile in the
//    swizzled layout TMA would have written (exact: v = (128 + (v & 127))
//    - (128 or 256 by the sign bit), all in bf16), fence.proxy.async, a
//    named barrier over the 256 consumer threads, and wgmma reads the
//    widened tile.  No bf16 copy of the weights exists in device memory.
//    The widening of step i overlaps the products of step i - 1, which
//    are then waited for (wait_group 0) before the barrier; the widened
//    tiles are double-buffered (64 KB).  Pass 1 int8: four stages of
//    x 16 + q1 16 KB; pass 2: three of h_hi 16 + h_lo 16 + q2 16 KB.
//    Decode-sized C.  When the pass-2 blocks are too few to fill the
//    card the wrapper splits its K (the F chunks) over `nsplit` blocks,
//    each writing an f32 partial sum, and gffn_reduce_kernel adds them in
//    split order, then x s2 and + b2 (deterministic, no atomics).  Both
//    consumer warpgroups multiply even when the second one's rows all
//    lie past C: a branch around the wgmmas makes ptxas serialize every
//    one of them (its note C7520), which cost more at the bench bucket
//    than the idle rows cost at C = 20.
//    Shapes.  TMA needs 16-byte row strides: H and F multiples of 8 (16
//    for int8 weights) and 16-byte aligned bases; the wrapper zero-pads
//    other shapes (padded F columns give act(0) times zero rows of w2,
//    padded H columns zero products and are sliced away).
//    Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 3f,
//    E = 8, C = 2560, H = 2048, F = 5504, gelu): dense 2.55 ms (GEMM 1
//    1.32, GEMM 2 1.33; the einsum route 2.60; the first port's 16-row
//    kernel 19.0), int8 3.10 ms (einsum over bf16 weights 2.63); at
//    C = 20 0.22 / 0.25 ms.  paddle_tpu_torch/testing/grouped_variants.py
//    takes the kernel apart: without the loads the products and the
//    epilogue alone take about 80% of the time, without the products the
//    loads and the epilogue about 75%, so neither side bounds it alone.
//    Tried and not kept, each slower on the card: clusters of two blocks
//    sharing each B tile by TMA multicast (both blocks then wait for the
//    slower one's consumers), a persistent grid, k steps of 32, and for
//    int8 a third widened buffer in place of the wait before each
//    barrier.  Int8 pays for the widening (its shared-memory writes and
//    reads, and that wait); the next step is the route that widens in
//    registers: out^T = w^T . act^T, the widened weight as wgmma's A
//    operand.
//
// 2. f32 x: gffn_fma_kernel, on the fp32 cores (the tensor cores would
//    round x to TF32, which the TPU kernel does not).  A block owns
//    kRows = 16 rows of one expert and up to kCols = 2048 output columns,
//    keeps their f32 sum in registers and walks the F blocks (kFB = 64):
//    h[16, 64] = x @ w1[:, fblk] with s1, b1 and the activation, then
//    acc += (h @ w2[fblk, :]) (x s2 for int8).  H above 2048 takes more
//    column slices, each recomputing h; a decode-sized C splits the F
//    blocks over blocks whose partials gffn_reduce_kernel adds.
//
// Times and the kernels' history: PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // gffn_fma_kernel
constexpr int kRows = 16;      // rows of x per fma block
constexpr int kFB = 64;        // F block of the fma kernel; K split unit
constexpr int kCols = 2048;    // output columns per fma block

struct FfnArgs {
  const void* x;
  const void* w1;
  const float* s1;
  const float* b1;
  const void* w2;
  const float* s2;
  const float* b2;
  void* out;
  float* partial;
  int E, C, H, F, act, nsplit;
};

__device__ __forceinline__ float activation(float v, int code) {
  switch (code) {
    case 0:  // gelu, exact form, as jax.nn.gelu(approximate=False)
      return 0.5f * v * erfcf(-v * 0.70710678118654752440f);
    case 1:
      return fmaxf(v, 0.f);
    case 2:  // silu
      return v / (1.f + expf(-v));
    case 3:
      return 1.f / (1.f + expf(-v));
    default:
      return tanhf(v);
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// -- bf16 x: the tensor-core GEMMs --------------------------------------------

constexpr int kWgThreads = 384;  // two consumer warpgroups + producer
constexpr int kBM = 128;         // rows per tile: one m64 per consumer
constexpr int kBN = 256;         // columns per tile: wgmma n256
constexpr int kBK = 64;          // k per stage: one 128-byte bf16 row
constexpr int kATile = kBM * kBK * 2;  // 16 KB, [128 rows][64 k]
constexpr int kBTile = kBK * kBN * 2;  // 32 KB, 4 regions of [64 k][64 n]
constexpr int kRegion = kBK * 128;     // bytes of one B region
constexpr int kRawTile = kBK * kBN;    // 16 KB, int8 [64 k][256 n]
constexpr int kRingBudget = 208 * 1024;  // ring + widened tiles

template <typename TW, int kPass>
struct Plan {
  static constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  static constexpr int kA = kPass == 2 ? 2 : 1;  // A tiles a stage (hi, lo)
  static constexpr int kStageBytes =
      kA * kATile + (kInt8 ? kRawTile : kBTile);
  static constexpr int kWide = kInt8 ? 2 : 0;  // widened B tiles
  static constexpr int kStages = (kRingBudget - kWide * kBTile) / kStageBytes;
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kWide * kBTile + 8 * 2 * kStages;
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
};

struct WgArgs {
  const float* s1;  // pass 1 (int8)
  const float* b1;  // pass 1
  const float* s2;  // pass 2 (int8)
  const float* b2;  // pass 2
  bf16* h_hi;       // pass 1 writes, pass 2 reads through its maps
  bf16* h_lo;
  bf16* out;        // pass 2, nsplit == 1
  float* partial;   // pass 2, nsplit > 1: [nsplit, E, C, N]
  int E, C, K, N, act, nsplit;
};

// d += A * B, m64n256k16: A from shared memory K-major, B from shared
// memory MN-major (imm-trans-b 1), both with the 128-byte swizzle.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Widens the raw int8 tile [64 k][256 n] into the bf16 tile wgmma reads:
// four regions of [64 k][64 n], 128-byte rows, 16-byte chunk c of row k
// at chunk c ^ (k & 7) (the 128-byte swizzle, as TMA lays a bf16 B tile
// out).  Each consumer thread (ct < 256) widens 8-byte pieces into 16-byte
// chunks; the 8 threads of a quarter warp write the 8 chunks of one row,
// which the swizzle spreads over all 32 banks.  In bf16, 128 + (v & 127)
// is exact (7 mantissa bits), and subtracting 128, or 256 when v's sign
// bit is set, gives v exactly.
__device__ __forceinline__ void widen_tile(const uint8_t* raw, uint8_t* dst,
                                           int ct) {
#pragma unroll 2  // fully unrolled, this loop crashed ptxas (CUDA 12.8)
  for (int i = 0; i < kBK * kBN / 8 / 256; ++i) {
    const int q = ct + 256 * i;
    const int c = q & 7, r = (q >> 3) & 3, k = q >> 5;
    const uint2 v = *reinterpret_cast<const uint2*>(raw + q * 8);
    const uint32_t words[2] = {v.x, v.y};
    uint32_t h[4];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // bytes 2 half and 2 half + 1 into the low bytes of two halves
        const uint32_t t =
            __byte_perm(words[w], 0u, half ? 0x4342u : 0x4140u);
        const uint32_t mag = (t & 0x007f007fu) | 0x43004300u;
        const uint32_t off = (t & 0x00800080u) | 0x43004300u;
        const __nv_bfloat162 d =
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                    *reinterpret_cast<const __nv_bfloat162*>(&off));
        h[2 * w + half] = *reinterpret_cast<const uint32_t*>(&d);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kRegion + k * 128 +
                              ((c ^ (k & 7)) << 4)) =
        make_uint4(h[0], h[1], h[2], h[3]);
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

constexpr int kEpStride = kBN + 8;  // floats per row of the staged tile
constexpr int kEpBytes = kBM * kEpStride * 4;

// One block: out[m0 .. m0 + 127, n0 .. n0 + 255] of expert e over the k
// chunks of split z.
template <typename TW, int kPass>
__global__ void __launch_bounds__(kWgThreads, 1)
gffn_wg_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap ta_lo,
               const __grid_constant__ CUtensorMap tb, const WgArgs a) {
  using P = Plan<TW, kPass>;
  static_assert(P::kStages * P::kStageBytes + P::kWide * kBTile >= kEpBytes,
                "the staged epilogue tile fits in the ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* wide = ring + P::kStages * P::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(wide + P::kWide * kBTile);
  uint64_t* empty = full + P::kStages;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int e = blockIdx.z / a.nsplit, z = blockIdx.z % a.nsplit;
  const int nk = (a.K + kBK - 1) / kBK;
  const int k0 = (int)((long long)z * nk / a.nsplit);
  const int steps = (int)((long long)(z + 1) * nk / a.nsplit) - k0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);  // one arrival per consumer warp
    }
    bar_fence_init();
  }
  __syncthreads();

  if (role == 2) {  // producer warpgroup: one thread issues the loads
    regs_producer();
    if (threadIdx.x == 256) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % P::kStages;
        const uint32_t ph = (i / P::kStages) & 1;
        if (i >= P::kStages) bar_wait(empty + s, ph ^ 1);
        uint8_t* st = ring + s * P::kStageBytes;
        const int kc = (k0 + i) * kBK;
        bar_expect(full + s, P::kStageBytes);
        tma_3d(st, &ta, full + s, kc, m0, e);
        if (kPass == 2) tma_3d(st + kATile, &ta_lo, full + s, kc, m0, e);
        uint8_t* sb = st + P::kA * kATile;
        if (P::kInt8) {
          tma_3d(sb, &tb, full + s, n0, kc, e);
        } else {
#pragma unroll
          for (int r = 0; r < kBN / 64; ++r)
            tma_3d(sb + r * kRegion, &tb, full + s, n0 + 64 * r, kc, e);
        }
      }
    }
  } else {  // consumer warpgroups 0 and 1: 64 rows each
    regs_consumer();
    const int wgi = warp / 4, t = lane % 4;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    for (int i = 0; i < steps; ++i) {
      const int s = i % P::kStages;
      const uint8_t* st = ring + s * P::kStageBytes;
      const uint8_t* sb = st + P::kA * kATile;
      bar_wait(full + s, (i / P::kStages) & 1);
      if (P::kInt8) {
        // widen while the tensor cores run product i - 1; then wait for
        // it, free its stage, and let both warpgroups see the new tile
        uint8_t* w = wide + (i & 1) * kBTile;
        widen_tile(sb, w, threadIdx.x);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        wg_wait0();
        if (i > 0) release(empty + (i - 1) % P::kStages, lane);
        consumers_sync();
        sb = w;
      }
      wg_fence();
      const uint64_t da = gdesc(st + wgi * 64 * 128, 16, 1024);
      const uint64_t db = gdesc(sb, kRegion, 1024);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // k step kk: A columns 16 kk.. (32 bytes along the row), B rows
        // 16 kk.. (16 rows of 128 bytes)
        wgmma_n256(acc, da + 2 * kk, db + 128 * kk);
        if (kPass == 2)
          wgmma_n256(acc, da + (kATile >> 4) + 2 * kk, db + 128 * kk);
      }
      wg_commit();
      if (!P::kInt8) {
        wg_wait1();  // product i - 1 is done: free its stage
        if (i > 0) release(empty + (i - 1) % P::kStages, lane);
      }
    }
    wg_wait0();
    fence_regs(acc);

    // Epilogue, staged through shared memory (the ring is idle now): the
    // f32 tile [128][kEpStride], then each thread takes 8 adjacent
    // columns of a row and stores them with 16-byte writes.
    consumers_sync();  // both warpgroups are done reading the ring
    float* tile = reinterpret_cast<float*>(ring);
    {
      float* my = tile + (wgi * 64 + (warp % 4) * 16 + lane / 4) * kEpStride +
                  2 * t;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        *reinterpret_cast<float2*>(my + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(my + 8 * kEpStride + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    consumers_sync();
    // Each thread owns 8 adjacent columns, the same in every row it takes
    // (rows threadIdx.x / 32 + 8 r), so their bias and scale load once.
    const int cc = 8 * (threadIdx.x % 32), col = n0 + cc;
    if (col >= a.N) return;  // N % 8 == 0: all 8 columns or none
    const size_t N = (size_t)a.N;
    const size_t c = (size_t)e * N + col;
    float bias[8], scale[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      bias[q] = (kPass == 1 ? a.b1 : a.b2)[c + q];
      scale[q] = P::kInt8 ? (kPass == 1 ? a.s1 : a.s2)[c + q] : 1.f;
    }
#pragma unroll 1
    for (int rl = threadIdx.x / 32; rl < kBM && m0 + rl < a.C; rl += 8) {
      const float4* src =
          reinterpret_cast<const float4*>(tile + rl * kEpStride + cc);
      const float4 v03 = src[0], v47 = src[1];
      const size_t at = ((size_t)e * a.C + m0 + rl) * N + col;
      if (kPass == 2 && a.nsplit > 1) {
        float4* dst = reinterpret_cast<float4*>(
            a.partial + (size_t)z * a.E * a.C * N + at);
        dst[0] = v03;
        dst[1] = v47;
        continue;
      }
      const float v[8] = {v03.x, v03.y, v03.z, v03.w,
                          v47.x, v47.y, v47.z, v47.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v0 = v[2 * q], v1 = v[2 * q + 1];
        if (P::kInt8) {
          v0 *= scale[2 * q];
          v1 *= scale[2 * q + 1];
        }
        v0 += bias[2 * q];
        v1 += bias[2 * q + 1];
        if (kPass == 1) {
          split_bf16(activation(v0, a.act), activation(v1, a.act), hi[q],
                     lo[q]);
        } else {
          const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          hi[q] = *reinterpret_cast<const uint32_t*>(&o);
        }
      }
      if (kPass == 1) {
        *reinterpret_cast<uint4*>(a.h_hi + at) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(a.h_lo + at) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {
        *reinterpret_cast<uint4*>(a.out + at) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
  }
}

// -- f32 x: FMA tiles ---------------------------------------------------------------

constexpr int kFmaKC = 32;                   // depth of a first-product chunk
constexpr int kFmaNC = 128;                  // columns of a second-product chunk
constexpr int kFmaNChunks = kCols / kFmaNC;  // 16

// Thread layout: the first product gives row tid / 16 and F-block columns
// tid % 16 + 16 q (q < 4); the second rows 4 (tid / 64) + i (i < 4) and
// chunk columns tid % 64 + 64 j (j < 2).
template <typename TW>
__global__ void __launch_bounds__(kThreads, 1) gffn_fma_kernel(const FfnArgs a) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  __shared__ float sx[kRows][kFmaKC];
  __shared__ float sw1[kFmaKC][kFB];
  __shared__ float sh[kRows][kFB + 1];
  __shared__ float sw2[kFB][kFmaNC];

  const int tid = threadIdx.x;
  const int H = a.H, F = a.F, C = a.C;
  const int nslices = (H + kCols - 1) / kCols;
  const int e = blockIdx.y / nslices;
  const int c0 = (blockIdx.y % nslices) * kCols;
  const int r0 = blockIdx.x * kRows;
  const int nfb = (F + kFB - 1) / kFB;
  const int fb0 = (int)((long long)blockIdx.z * nfb / a.nsplit);
  const int fb1 = (int)((long long)(blockIdx.z + 1) * nfb / a.nsplit);
  const int nn = (min(kCols, H - c0) + kFmaNC - 1) / kFmaNC;

  const float* x = static_cast<const float*>(a.x) + (size_t)e * C * H;
  const TW* w1 = static_cast<const TW*>(a.w1) + (size_t)e * H * F;
  const TW* w2 = static_cast<const TW*>(a.w2) + (size_t)e * F * H;
  const float* b1 = a.b1 + (size_t)e * F;
  const float* b2 = a.b2 + (size_t)e * H;
  const float* s1 = kInt8 ? a.s1 + (size_t)e * F : nullptr;
  const float* s2 = kInt8 ? a.s2 + (size_t)e * H : nullptr;

  const int hr = tid / 16, hc = tid % 16;
  const int rg = tid / 64, cg = tid % 64;

  float acc[kFmaNChunks][2][4];
#pragma unroll
  for (int n = 0; n < kFmaNChunks; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = c0 + n * kFmaNC + cg + 64 * j;
      const float v = (a.nsplit == 1 && col < H) ? b2[col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][j][i] = v;
    }

  for (int fb = fb0; fb < fb1; ++fb) {
    const int f0 = fb * kFB;
    float hacc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < H; k0 += kFmaKC) {
      __syncthreads();  // every thread is done with the last chunk
      for (int i = tid; i < kRows * kFmaKC; i += kThreads) {
        const int row = i / kFmaKC, k = k0 + i % kFmaKC;
        sx[row][i % kFmaKC] =
            (r0 + row < C && k < H) ? x[(size_t)(r0 + row) * H + k] : 0.f;
      }
      for (int i = tid; i < kFmaKC * kFB; i += kThreads) {
        const int rr = i / kFB, c = i % kFB, k = k0 + rr, f = f0 + c;
        sw1[rr][c] = (k < H && f < F) ? to_float(w1[(size_t)k * F + f]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kFmaKC; ++kk) {
        const float xv = sx[hr][kk];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hacc[q] = fmaf(xv, sw1[kk][hc + 16 * q], hacc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = f0 + hc + 16 * q;
      float p = 0.f;
      if (f < F) {
        p = hacc[q];
        if (kInt8) p *= s1[f];
        p = activation(p + b1[f], a.act);
      }
      sh[hr][hc + 16 * q] = p;
    }
#pragma unroll
    for (int n = 0; n < kFmaNChunks; ++n) {
      if (n >= nn) break;
      const int n0 = c0 + n * kFmaNC;
      __syncthreads();  // h written; every thread done with the last chunk
      for (int i = tid; i < kFB * kFmaNC; i += kThreads) {
        const int rr = i / kFmaNC, c = i % kFmaNC, f = f0 + rr, col = n0 + c;
        sw2[rr][c] =
            (f < F && col < H) ? to_float(w2[(size_t)f * H + col]) : 0.f;
      }
      __syncthreads();
      float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
      for (int kk = 0; kk < kFB; ++kk) {
        float hv[4], wv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = sh[4 * rg + i][kk];
#pragma unroll
        for (int j = 0; j < 2; ++j) wv[j] = sw2[kk][cg + 64 * j];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) tmp[j][i] = fmaf(hv[i], wv[j], tmp[j][i]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + cg + 64 * j;
        const float sc = kInt8 ? (col < H ? s2[col] : 0.f) : 1.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][j][i] += tmp[j][i] * sc;
      }
    }
  }

  const size_t ld = (size_t)H;
  float* out = static_cast<float*>(a.out) + (size_t)e * C * H;
  float* part = a.partial + ((size_t)blockIdx.z * a.E + e) * C * H;
#pragma unroll
  for (int n = 0; n < kFmaNChunks; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 4 * rg + i;
        const int col = c0 + n * kFmaNC + cg + 64 * j;
        if (row >= C || col >= H) continue;
        if (a.nsplit == 1)
          out[row * ld + col] = acc[n][j][i];
        else
          part[row * ld + col] = acc[n][j][i];
      }
}

// out = cast((partial[0] + partial[1] + ...) * s2 + b2), splits in order;
// s2 null: no scale (the fma kernel scales each F block itself).
template <typename T>
__global__ void gffn_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ s2,
                                   const float* __restrict__ b2,
                                   T* __restrict__ out, int E, int C, int H,
                                   int nsplit) {
  const size_t n = (size_t)E * C * H;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t c = i / ((size_t)C * H) * H + i % H;
  float s = partial[i];
  for (int z = 1; z < nsplit; ++z) s += partial[(size_t)z * n + i];
  if (s2 != nullptr) s *= s2[c];
  out[i] = from_float<T>(s + b2[c]);
}

// -- host ---------------------------------------------------------------------

// An [E, rows, cols] tensor read in boxes of box_rows x box_cols: bf16
// with the 128-byte swizzle (box_cols = 64), or int8 unswizzled.
bool make_map(CUtensorMap* map, const void* base, bool int8, int E, int rows,
              int cols, int box_rows, int box_cols, CUtensorMapSwizzle sw) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const size_t elem = int8 ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * elem),
                                 (cuuint64_t)((size_t)rows * cols * elem)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map,
            int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The B operand [E, K, N] in boxes of 64 rows: 64-column bf16 regions,
// or the whole int8 [64, 256] tile.
bool make_b_map(CUtensorMap* map, const void* base, bool int8, int E, int K,
                int N) {
  return int8 ? make_map(map, base, true, E, K, N, kBK, kBN,
                         CU_TENSOR_MAP_SWIZZLE_NONE)
              : make_map(map, base, false, E, K, N, kBK, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// An A operand [E, C, K] (x or h) in boxes of 128 rows x 64 columns.
bool make_a_map(CUtensorMap* map, const void* base, int E, int C, int K) {
  return make_map(map, base, false, E, C, K, kBM, kBK,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename TW, int kPass>
cudaError_t launch_wg(const CUtensorMap& ta, const CUtensorMap& ta_lo,
                      const CUtensorMap& tb, const WgArgs& a,
                      cudaStream_t stream) {
  using P = Plan<TW, kPass>;
  auto kernel = gffn_wg_kernel<TW, kPass>;
  cudaError_t e = allow_smem(kernel, P::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.C + kBM - 1) / kBM,
                  a.E * a.nsplit);
  kernel<<<grid, kWgThreads, P::kSmem, stream>>>(ta, ta_lo, tb, a);
  return cudaGetLastError();
}

// Pass 1 (passes & 1) and pass 2 (passes & 2) of the bf16-x route.
template <typename TW>
cudaError_t launch_tensor_cores(const FfnArgs& f, bf16* h_hi, bf16* h_lo,
                                int passes, cudaStream_t st) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  const int E = f.E, C = f.C, H = f.H, F = f.F;
  CUtensorMap tx, tw1, thi, tlo, tw2;
  if (!make_a_map(&tx, f.x, E, C, H) ||
      !make_b_map(&tw1, f.w1, kInt8, E, H, F) ||
      !make_a_map(&thi, h_hi, E, C, F) || !make_a_map(&tlo, h_lo, E, C, F) ||
      !make_b_map(&tw2, f.w2, kInt8, E, F, H))
    return cudaErrorNotSupported;
  WgArgs a{f.s1, f.b1, f.s2, f.b2, h_hi, h_lo, static_cast<bf16*>(f.out),
           f.partial, E, C, H, F, f.act, 1};
  cudaError_t e = cudaSuccess;
  if (passes & 1) e = launch_wg<TW, 1>(tx, tx, tw1, a, st);
  if (e != cudaSuccess || !(passes & 2)) return e;
  a.K = F;
  a.N = H;
  a.nsplit = f.nsplit;
  return launch_wg<TW, 2>(thi, tlo, tw2, a, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches on `stream`, whose device must be the calling thread's current
// one (the Python wrapper selects it).  Returns 0 on success, else the
// CUDA error code of the refused launch (cudaErrorInvalidValue for
// arguments these kernels do not take, cudaErrorNotSupported when a
// tensor map cannot be encoded).  x_dtype: 0 = float32, 1 = bfloat16;
// w_int8: 0 = w1/w2 in x's dtype, 1 = int8 with s1/s2; act: 0 gelu,
// 1 relu, 2 silu, 3 sigmoid, 4 tanh.  nsplit in [1, ceil(F / 64)]; above
// 1, `partial` holds nsplit * E * C * H floats.
// bfloat16 x takes the tensor-core GEMMs: H and F multiples of 8 (16 for
// int8 weights), x, w1, w2 16-byte aligned, and h_hi, h_lo two [E, C, F]
// bf16 scratch tensors (16-byte aligned); `passes` 1 runs only GEMM 1, 2
// only GEMM 2 (on whatever h holds; for timing each half), 3 both.
// float32 x takes gffn_fma_kernel (h_hi, h_lo and passes unused).
extern "C" int grouped_ffn_launch(const void* x, const void* w1,
                                  const void* s1, const void* b1,
                                  const void* w2, const void* s2,
                                  const void* b2, void* out, void* partial,
                                  void* h_hi, void* h_lo, int E, int C,
                                  int H, int F, int x_dtype, int w_int8,
                                  int act, int nsplit, int passes,
                                  void* stream) {
  if (E < 1 || C < 1 || H < 1 || F < 1 || act < 0 || act > 4)
    return cudaErrorInvalidValue;
  const int nfb = (F + kFB - 1) / kFB;
  if (nsplit < 1 || nsplit > nfb || (nsplit > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  if (w_int8 && (s1 == nullptr || s2 == nullptr)) return cudaErrorInvalidValue;
  const FfnArgs a{x,
                  w1,
                  static_cast<const float*>(s1),
                  static_cast<const float*>(b1),
                  w2,
                  static_cast<const float*>(s2),
                  static_cast<const float*>(b2),
                  out,
                  static_cast<float*>(partial),
                  E, C, H, F, act, nsplit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)E * C * H;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (x_dtype == 1) {
    const int m = w_int8 ? 16 : 8;  // elements in 16 bytes of a weight row
    if (H % m || F % m || h_hi == nullptr || h_lo == nullptr ||
        passes < 1 || passes > 3 || (long long)E * nsplit > 65535 ||
        (C + kBM - 1) / kBM > 65535 || !aligned16(x) || !aligned16(w1) ||
        !aligned16(w2) || !aligned16(h_hi) || !aligned16(h_lo) ||
        !aligned16(b1) || !aligned16(b2) || !aligned16(s1) || !aligned16(s2))
      return cudaErrorInvalidValue;
    bf16* hi = static_cast<bf16*>(h_hi);
    bf16* lo = static_cast<bf16*>(h_lo);
    const cudaError_t e =
        w_int8 ? launch_tensor_cores<int8_t>(a, hi, lo, passes, st)
               : launch_tensor_cores<bf16>(a, hi, lo, passes, st);
    if (e != cudaSuccess || nsplit == 1 || !(passes & 2)) return e;
    gffn_reduce_kernel<bf16><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(partial), a.s2, a.b2,
        static_cast<bf16*>(out), E, C, H, nsplit);
    return cudaGetLastError();
  }
  if (x_dtype != 0) return cudaErrorInvalidValue;
  const int nslices = (H + kCols - 1) / kCols;
  if ((long long)E * nslices > 65535 || nsplit > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((C + kRows - 1) / kRows, E * nslices, nsplit);
  if (w_int8)
    gffn_fma_kernel<int8_t><<<grid, kThreads, 0, st>>>(a);
  else
    gffn_fma_kernel<float><<<grid, kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  gffn_reduce_kernel<float><<<blocks, 256, 0, st>>>(
      static_cast<const float*>(partial), nullptr, a.b2,
      static_cast<float*>(out), E, C, H, nsplit);
  return cudaGetLastError();
}
