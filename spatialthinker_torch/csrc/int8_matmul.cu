// Fused W8A8 matmul for Hopper (sm_90a): per-token int8 quantize of x, the
// int8 x int8 -> int32 dot against per-output-channel int8 weights, and the
// scale epilogue.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/int8_matmul.py:
//   `_kernel_resident_w` (#10, :46) and `_kernel` (#11, :65), reached through
//   `fused_w8a8_matmul` (the pallas_calls at :210 and :227). Both compute one
//   function; this file computes it in the order of #10 and of the XLA path,
//   `(float(acc) * xs) * ws`.
// Contract (the plain versions in ops/int8_matmul.py state the same function):
//   x (m, K) bf16 | fp32; w (N, K) int8, one row per output column (the
//   port's QuantLinear layout: K-major, as wgmma's B operand takes it);
//   ws (N,) fp32. Per row: xs = max(amax |x|, 1e-8) / 127 (an IEEE division),
//   xq = clip(rint(x / xs), +-127). acc = xq . w exactly in int32.
//   out = __fmul_rn(__fmul_rn(float(acc), xs), ws) in bf16 (round to nearest
//   even) or fp32. Any m >= 1, K a multiple of 32, N a multiple of 8.
//   Bit-equal to the plain version on any device, whatever the plan: the
//   int32 sum is exact (K * 127^2 < 2^31), so any split of K summed in int32
//   in any order gives the same acc. With `quantize` = 0 the caller passes xq
//   and xs already made (the rows the silu junction quantized, or the row
//   quantize's split mode: `st_quantize_rows_split`, for a tensor-parallel
//   rank whose K / tp columns take the scale of the whole row's amax).
//
// What bounds it on the H100, and what the design does about it:
// - Decode (m <= 256: the engines' 65, 128, 129 and 136 lanes): bytes. Every
//   weight byte is read once, 4.2 MB (3B o_proj) to 311 MB (the head), against
//   2 m N K operations far under the card's operations-per-byte balance. The
//   plan (ops/int8_matmul.py `w8a8_plan`, the one source of truth; the C side
//   refuses a plan it cannot run) gives one CTA row tile ALL m rows (m64
//   blocks, one consumer warpgroup each), so each weight byte is read from HBM
//   by one CTA. It splits K over 2 to 4 CTAs of a thread-block cluster where
//   the column tiles leave SMs idle and K is long (3B down: 16 column tiles x
//   4 splits of 21-22 k-steps; 7B qkv, o and down), and otherwise keeps one
//   CTA per column tile with the deepest ring its shared memory allows:
//   measured on the H100, about one CTA per SM with a deep ring beats two or
//   more per SM with shallow ones by 15-40%.
//   The splits' int32 partials meet in distributed shared memory: each CTA
//   of the cluster sums its share of the tile's rows over every CTA's partial
//   and applies the epilogue; no workspace, no atomics, two calls bit-identical.
//   The decode and prefill tilings meet between m = 192 (the decode one
//   faster by 5-20% at the 3B linears) and m = 256 (the prefill one faster by
//   2-7%); the plan switches above 256, where no engine runs.
// - Prefill (m > 256: the 1,024-row chunks and 4,096-row refills): operations,
//   369 G int8 operations for the 3B gate_up at m = 4,096 against 59 MB. CTA
//   tiles of 128 x 256 (128 x 128 where 256 would leave SMs idle), two
//   consumer warpgroups of m64nBNk32 `wgmma`, the only path to Hopper's int8
//   tensor-core rate. The row tiles of one column tile are adjacent in launch
//   order, so each weight tile is read from HBM once and from L2 by the rest.
// - Both regimes: one producer warp streams 128-byte k-slices of xq and w by
//   TMA (128-byte swizzle, the layout wgmma's K-major descriptor reads without
//   bank conflicts) into an mbarrier ring of 2-8 stages (the plan's smem
//   budget: deep where a CTA has its SM to itself). At decode a slot holds
//   only xq's live rows, rounded up to 8 (72 of a 128-row tile at m = 65),
//   which leaves room for more stages. Each consumer warpgroup runs the
//   slice's four k32 `wgmma`s and hands the slot back as soon as they finish.
//   TMA zero-fills rows past m, columns past N and the k tail past K, so
//   nothing is padded.
// - The row quantize is a prologue kernel (one CTA per row, the row read once
//   in 16-byte vectors; Hopper's CTAs share nothing, and quantizing inside
//   the GEMM would read x once per column tile). It triggers programmatic
//   dependent launch at its start; at decode m (one row tile) the GEMM is
//   launched to take it, so its CTAs launch while the prologue runs and
//   their producers fill the ring with weight slices (which do not depend on
//   x) before `griddepcontrol.wait`; the xq slices follow. (At prefill m the
//   waiting CTAs would hold the SMs the prologue's rows need.) The wrapper
//   counts both kernels as one launch.
// What it does not do yet: a persistent schedule that overlaps one tile's
// epilogue with the next tile's loads; TMA multicast of a weight tile to the
// row tiles of a cluster at prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr float EPS = 1e-8f;
constexpr int QTHREADS = 256;
constexpr int K_STEP = 128;     // bytes of K per ring stage: one TMA box row, the 128-byte swizzle span
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int MAX_STAGES = 8;
constexpr int PART_PAD = 4;     // int32 words of padding per row of a split's partial tile
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use on the H100

// One CTA per row: xs = max(amax, eps) / 127, xq = clip(rint(x / xs)).
// 16-byte loads (8 bf16 or 4 fp32; K % 32 == 0 keeps rows whole vectors);
// a thread keeps its first HOLD vectors in registers (HOLD of 1, 2, 4 or 8,
// the least that holds the row: registers set how many rows an SM runs at
// once), so a row of up to QTHREADS * 8 vectors (K = 16,384 bf16) is read
// from memory once.

__device__ __forceinline__ float vec_amax(const uint4& v, float amax, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return amax;
}
__device__ __forceinline__ float vec_amax(const uint4& v, float amax, float) {
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(f[i]));
  return amax;
}
__device__ __forceinline__ int8_t quantize_one(float v, float s) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(v / s), -127.f), 127.f)));
}
// the vector's 8 (bf16) or 4 (fp32) int8 values at xq
__device__ __forceinline__ void vec_store(const uint4& v, float s, int8_t* xq, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  union { int8_t b[8]; uint2 u; } q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    q.b[2 * i] = quantize_one(f.x, s);
    q.b[2 * i + 1] = quantize_one(f.y, s);
  }
  *reinterpret_cast<uint2*>(xq) = q.u;
}
__device__ __forceinline__ void vec_store(const uint4& v, float s, int8_t* xq, float) {
  const float* f = reinterpret_cast<const float*>(&v);
  union { int8_t b[4]; uint32_t u; } q;
#pragma unroll
  for (int i = 0; i < 4; ++i) q.b[i] = quantize_one(f[i], s);
  *reinterpret_cast<uint32_t*>(xq) = q.u;
}

// MODE 0: one pass (the row's own amax). Under tensor parallelism a rank
// holds K / tp of a row whose scale is the amax over the whole K, so the
// split mode runs the kernel twice: MODE 1 writes each row's local amax to
// `amax_io` and nothing else; the group all-reduces MAX; MODE 2 reads the
// group's amax from `amax_io` and quantizes with its scale, as MODE 0 does
// with its own.
template <typename InT, int HOLD, int MODE>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const InT* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                     float* __restrict__ amax_io, int k) {
  griddep_launch_dependents();  // the GEMM may start streaming weights now
  constexpr int VEC = 16 / sizeof(InT);
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = k / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * k);
  uint4 held[HOLD];
  __shared__ float row_scale;
  if constexpr (MODE == 2) {
    // the group's amax: the row is read once, by the stores below
#pragma unroll
    for (int j = 0; j < HOLD; ++j) {
      const int v = threadIdx.x + j * QTHREADS;
      if (v < nv) held[j] = xr[v];
    }
    if (threadIdx.x == 0) {
      row_scale = fmaxf(amax_io[row], EPS) / 127.0f;  // IEEE division, as the plain version
      xs[row] = row_scale;
    }
  } else {
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < HOLD; ++j) {
      const int v = threadIdx.x + j * QTHREADS;
      if (v < nv) {
        held[j] = xr[v];
        amax = vec_amax(held[j], amax, InT());
      }
    }
    for (int v = threadIdx.x + HOLD * QTHREADS; v < nv; v += QTHREADS) amax = vec_amax(xr[v], amax, InT());
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    __shared__ float warp_max[QTHREADS / 32];
    if (lane == 0) warp_max[warp] = amax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.f;
      for (int w = 0; w < QTHREADS / 32; ++w) v = fmaxf(v, warp_max[w]);
      if constexpr (MODE == 1) {
        amax_io[row] = v;
      } else {
        row_scale = fmaxf(v, EPS) / 127.0f;  // IEEE division, as the plain version
        xs[row] = row_scale;
      }
    }
    if constexpr (MODE == 1) return;
  }
  __syncthreads();
  const float s = row_scale;
  int8_t* qr = xq + (size_t)row * k;
#pragma unroll
  for (int j = 0; j < HOLD; ++j) {
    const int v = threadIdx.x + j * QTHREADS;
    if (v < nv) vec_store(held[j], s, qr + v * VEC, InT());
  }
  for (int v = threadIdx.x + HOLD * QTHREADS; v < nv; v += QTHREADS) vec_store(xr[v], s, qr + v * VEC, InT());
}

// ---- distributed shared memory of a cluster ----
__device__ __forceinline__ int4 ld_cluster_int4(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// ---- wgmma ----
// D(64 x N, s32) += A(64 x 32, s8) B(N x 32, s8)^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_k32(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "column tiles of 64, 128 or 256");
  if constexpr (BN == 64) wgmma_m64n64k32(d, da, db);
  else if constexpr (BN == 128) wgmma_m64n128k32(d, da, db);
  else wgmma_m64n256k32(d, da, db);
}

// A CTA: MB consumer warpgroups (one m64 block of rows each) and one producer
// warp; a column tile of BN; a ring of `stages` slots, each the xq box
// (a_bytes: its rows x 128 bytes, at most BM rows) then the w box (BN rows x
// 128 bytes). Warpgroup g reads rows [64 g, 64 g + 64) from the slot's start:
// rows past the xq box fall in the w box of the same slot (a_rows + BN >= BM,
// st_int8_matmul sees to it) and feed accumulator rows never stored.
template <int MB, int BN>
struct Tile {
  static constexpr int BM = 64 * MB;
  static constexpr int CONSUMER_WARPS = 4 * MB;
  static constexpr int THREADS = 32 * CONSUMER_WARPS + 32;
  static constexpr int B_BYTES = BN * K_STEP;
  static constexpr int PART_STRIDE = BN + PART_PAD;  // int32 words per partial row
  static constexpr int PART_BYTES = BM * PART_STRIDE * 4;
  // two CTAs an SM where the accumulators and the decode ring allow it
  static constexpr int MIN_BLOCKS = (MB <= 2 && BN <= 128) ? 2 : 1;
  // the ring, or a split's partial tile where that is larger (it reuses the ring)
  __host__ __device__ static int body_bytes(int stages, int splits, int a_bytes) {
    const int ring = stages * (a_bytes + B_BYTES);
    return (splits > 1 && PART_BYTES > ring) ? PART_BYTES : ring;
  }
  // + 1 KB to align the ring to the swizzle atom, + a full and an empty barrier per stage
  __host__ __device__ static int smem_bytes(int stages, int splits, int a_bytes) {
    return 1024 + body_bytes(stages, splits, a_bytes) + 16 * stages;
  }
};

// grid (splits * row tiles, column tiles); with splits > 1 a cluster of
// (splits, 1, 1): the split index is blockIdx.x % splits, the cluster rank.
template <int MB, int BN, typename OutT>
__global__ void __launch_bounds__(Tile<MB, BN>::THREADS, Tile<MB, BN>::MIN_BLOCKS)
w8a8_gemm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ xs, const float* __restrict__ ws, OutT* __restrict__ out, int m,
                 int n, int k_steps, int splits, int stages, int a_bytes) {
  using T = Tile<MB, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + T::body_bytes(stages, splits, a_bytes);
  const int stage_bytes = a_bytes + T::B_BYTES;
  const uint32_t empty0 = full0 + 8 * stages;

  const int split = blockIdx.x % splits;
  const int m0 = (blockIdx.x / splits) * T::BM;
  const int n0 = blockIdx.y * BN;
  // this split's k-steps: the first k_steps % splits splits take one more
  const int per = k_steps / splits, extra = k_steps % splits;
  const int step0 = split * per + min(split, extra);
  const int n_k = per + (split < extra ? 1 : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);                      // the producer's expect_tx
      mbar_init(empty0 + 8 * s, T::CONSUMER_WARPS);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  if (warp == T::CONSUMER_WARPS) {
    // producer: weight slices first (x-independent), then xq once the prologue is done
    if (lane == 0) {
      const int pre = min(stages, n_k);
      for (int i = 0; i < pre; ++i) {
        const uint32_t slot = base + i * stage_bytes;
        mbar_expect_tx(full0 + 8 * i, stage_bytes);
        tma_load(slot + a_bytes, &map_w, (step0 + i) * K_STEP, n0, full0 + 8 * i);
      }
      griddep_wait();
      for (int i = 0; i < pre; ++i)
        tma_load(base + i * stage_bytes, &map_x, (step0 + i) * K_STEP, m0, full0 + 8 * i);
      for (int i = pre; i < n_k; ++i) {
        const int s = i % stages;
        mbar_wait(empty0 + 8 * s, ((i / stages) - 1) & 1);
        const uint32_t slot = base + s * stage_bytes;
        mbar_expect_tx(full0 + 8 * s, stage_bytes);
        tma_load(slot + a_bytes, &map_w, (step0 + i) * K_STEP, n0, full0 + 8 * s);
        tma_load(slot, &map_x, (step0 + i) * K_STEP, m0, full0 + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup g multiplies rows [64 g, 64 g + 64) of the tile
    const int g = warp >> 2;
    for (int i = 0; i < n_k; ++i) {
      const int s = i % stages;
      mbar_wait(full0 + 8 * s, (i / stages) & 1);
      __syncwarp();  // wgmma is warp-aligned: reconverge after the per-thread spin
      const uint32_t a = base + s * stage_bytes + g * 64 * K_STEP;
      const uint32_t b = base + s * stage_bytes + a_bytes;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < K_STEP / 32; ++j) wgmma_k32<BN>(acc, sw128_desc(a + 32 * j), sw128_desc(b + 32 * j));
      wgmma_commit();
      wgmma_wait<0>();  // this slice's products are done: its slot goes back to the producer
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    fence_acc(acc);
  }
  griddep_wait();  // xs comes from the prologue

  // accumulator layout of m64nBN: warp q of the warpgroup holds rows 16 q + lane / 4 (+ 8);
  // n8 chunk j holds columns 8 j + 2 (lane % 4) (+ 1) in acc[4 j + 2 h + {0, 1}]
  const int g = warp >> 2, q = warp & 3;
  if (splits == 1) {
    if (warp == T::CONSUMER_WARPS) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g * 64 + q * 16 + (lane >> 2) + 8 * h;
      if (r >= m) continue;
      const float sx = xs[r];
      OutT* orow = out + (size_t)r * n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane & 3);
        if (c >= n) continue;  // n % 8 == 0: c and c + 1 are both in or both out
        const float2 w2 = *reinterpret_cast<const float2*>(ws + c);
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sx), w2.x);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sx), w2.y);
        if constexpr (sizeof(OutT) == 4) {
          *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    return;
  }

  // split-K: each CTA of the cluster holds an int32 partial of the same tile
  __syncthreads();  // every slot is consumed: the partial may overwrite the ring
  int* part = reinterpret_cast<int*>(smem_raw + (base - raw));
  if (warp < T::CONSUMER_WARPS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g * 64 + q * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<int2*>(part + r * T::PART_STRIDE + 8 * j + 2 * (lane & 3)) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  cluster_sync();
  // this CTA sums its share of the live rows over all partials (exact int32) and writes them
  const int live = min(T::BM, m - m0);
  const int share = (live + splits - 1) / splits;
  const int r_lo = split * share, r_hi = min(live, r_lo + share);
  constexpr int C4 = BN / 4;
  for (int idx = threadIdx.x; idx < (r_hi - r_lo) * C4; idx += T::THREADS) {
    const int r = r_lo + idx / C4, c = (idx % C4) * 4;
    const int gc = n0 + c;
    if (gc >= n) continue;  // n % 8 == 0, c % 4 == 0: all four columns in or out
    const uint32_t local = base + (r * T::PART_STRIDE + c) * 4;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int s = 0; s < splits; ++s) {
      const int4 v = ld_cluster_int4(local, s);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float sx = xs[m0 + r];
    const float4 w4 = *reinterpret_cast<const float4*>(ws + gc);
    const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(sum.x), sx), w4.x);
    const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(sum.y), sx), w4.y);
    const float v2 = __fmul_rn(__fmul_rn(__int2float_rn(sum.z), sx), w4.z);
    const float v3 = __fmul_rn(__fmul_rn(__int2float_rn(sum.w), sx), w4.w);
    OutT* dst = out + (size_t)(m0 + r) * n + gc;
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v0, v1, v2, v3);
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst) = packed;
    }
  }
  cluster_sync();  // no CTA leaves while another still reads its partial
}

// ---- host side ----

template <typename InT, int MODE = 0>
cudaError_t launch_quantize(const InT* x, void* xq, void* xs, int m, int k, cudaStream_t s,
                            void* amax_io = nullptr) {
  const int per_thread = (k / (16 / static_cast<int>(sizeof(InT))) + QTHREADS - 1) / QTHREADS;
  auto kernel = per_thread <= 1   ? quantize_rows_kernel<InT, 1, MODE>
                : per_thread <= 2 ? quantize_rows_kernel<InT, 2, MODE>
                : per_thread <= 4 ? quantize_rows_kernel<InT, 4, MODE>
                                  : quantize_rows_kernel<InT, 8, MODE>;
  kernel<<<m, QTHREADS, 0, s>>>(x, static_cast<int8_t*>(xq), static_cast<float*>(xs),
                                static_cast<float*>(amax_io), k);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_quantize_split(const void* x, int x_f32, void* xq, void* xs, void* amax, int m, int k,
                                  cudaStream_t s) {
  return x_f32 ? launch_quantize<float, MODE>(static_cast<const float*>(x), xq, xs, m, k, s, amax)
               : launch_quantize<__nv_bfloat16, MODE>(static_cast<const __nv_bfloat16*>(x), xq, xs, m, k, s, amax);
}

// A (rows, k) int8 row-major matrix, read in boxes of 128 k-bytes x box_rows
// rows with the 128-byte swizzle; out-of-range rows and k read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(K_STEP), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Launch {
  const CUtensorMap* map_x;
  const CUtensorMap* map_w;
  const float* xs;
  const float* ws;
  void* out;
  int m, n, k_steps, splits, stages, a_bytes;
  bool pdl;
  cudaStream_t stream;
};

template <int MB, int BN, typename OutT>
int launch_gemm(const Launch& p) {
  using T = Tile<MB, BN>;
  auto kernel = w8a8_gemm_kernel<MB, BN, OutT>;
  const int smem = T::smem_bytes(p.stages, p.splits, p.a_bytes);
  int device = 0;
  cudaGetDevice(&device);
  static bool configured[64] = {};  // per device: the opt-in to large dynamic shared memory
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  const int row_tiles = (p.m + T::BM - 1) / T::BM;
  const int col_tiles = (p.n + BN - 1) / BN;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.splits * row_tiles, col_tiles, 1);
  config.blockDim = dim3(T::THREADS, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = p.stream;
  cudaLaunchAttribute attrs[2];
  int n_attrs = 0;
  if (p.splits > 1) {
    attrs[n_attrs].id = cudaLaunchAttributeClusterDimension;
    attrs[n_attrs].val.clusterDim.x = p.splits;
    attrs[n_attrs].val.clusterDim.y = 1;
    attrs[n_attrs].val.clusterDim.z = 1;
    ++n_attrs;
  }
  if (p.pdl) {
    attrs[n_attrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n_attrs].val.programmaticStreamSerializationAllowed = 1;
    ++n_attrs;
  }
  config.attrs = attrs;
  config.numAttrs = n_attrs;
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, *p.map_x, *p.map_w, p.xs, p.ws,
                                             static_cast<OutT*>(p.out), p.m, p.n, p.k_steps, p.splits,
                                             p.stages, p.a_bytes));
}

// The tiles that are built: (m64 blocks of rows per CTA, column tile).
#define W8A8_TILES(X) X(1, 64) X(1, 128) X(1, 256) X(2, 64) X(2, 128) X(2, 256) X(3, 64) X(3, 128) X(4, 64) X(4, 128)

// Bytes of dynamic shared memory of a plan; -1 for a tile that is not built.
int plan_smem(int mb, int bn, int stages, int splits, int a_bytes) {
#define W8A8_SMEM(MB, BN) \
  if (mb == MB && bn == BN) return Tile<MB, BN>::smem_bytes(stages, splits, a_bytes);
  W8A8_TILES(W8A8_SMEM)
#undef W8A8_SMEM
  return -1;
}

template <typename OutT>
int dispatch(int mb, int bn, const Launch& p) {
#define W8A8_LAUNCH(MB, BN) \
  if (mb == MB && bn == BN) return launch_gemm<MB, BN, OutT>(p);
  W8A8_TILES(W8A8_LAUNCH)
#undef W8A8_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (m, k) bf16 (x_f32 = 0) | fp32; scratch xq int8 (m, k) and xs fp32 (m,)
// allocated by the caller (with quantize = 0 they hold the caller's
// quantized rows and x is not read); w (n, k) int8; ws (n,) fp32; out (m, n)
// bf16 | fp32 (out_f32). The plan (ops/int8_matmul.py `w8a8_plan`): mb m64
// blocks of rows per CTA, column tiles of bn, K cut into `splits` ranges of
// whole 128-byte steps (one cluster of `splits` CTAs per tile when > 1), a
// ring of `stages`; a plan this file cannot run is refused
// (cudaErrorInvalidValue) before anything launches. Launches the prologue
// (quantize = 1) and the GEMM on `stream`; returns the first launch error
// (0 = launched).
extern "C" int st_int8_matmul(const void* x, int x_f32, void* xq, void* xs, const void* w, const void* ws,
                              void* out, int out_f32, int m, int n, int k, int quantize, int mb, int bn,
                              int splits, int stages, void* stream) {
  const int k_steps = (k + K_STEP - 1) / K_STEP;
  // refused before anything launches: a shape outside the contract, a tile
  // that is not built, a split or ring the kernel cannot run (two stages at
  // least: with one the weight stream would stop while the products run)
  // xq's box: with one row tile only its live rows, rounded up to a swizzle
  // atom's 8 (rows past them are never stored), but no fewer than 64 mb - bn,
  // so that every warpgroup's rows lie inside its slot; else the whole tile
  // (TMA zero-fills past m)
  const int a_rows = m <= 64 * mb ? max((m + 7) / 8 * 8, 64 * mb - bn) : 64 * mb;
  const int smem = plan_smem(mb, bn, stages, splits, a_rows * K_STEP);
  if (m < 1 || n < 8 || k < 32 || k % 32 != 0 || n % 8 != 0 || smem < 0 || smem > SMEM_LIMIT ||
      (n + bn - 1) / bn > 65535 || splits < 1 || splits > MAX_SPLITS || splits > k_steps || stages < 2 ||
      stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!encode_map(&map_x, xq, m, k, a_rows) || !encode_map(&map_w, w, n, k, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // programmatic dependent launch where the plan has one row tile (m <= 256):
  // then the prologue's m CTAs run beside the GEMM's waiting ones; at
  // prefill m the waiting GEMM CTAs would hold the SMs the prologue needs
  const bool pdl = quantize != 0 && m <= 64 * mb;
  const Launch p{&map_x, &map_w, static_cast<const float*>(xs), static_cast<const float*>(ws), out,
                 m, n, k_steps, splits, stages, a_rows * K_STEP, pdl, s};
  if (quantize) {
    const cudaError_t err = x_f32 ? launch_quantize(static_cast<const float*>(x), xq, xs, m, k, s)
                                  : launch_quantize(static_cast<const __nv_bfloat16*>(x), xq, xs, m, k, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return out_f32 ? dispatch<float>(mb, bn, p) : dispatch<__nv_bfloat16>(mb, bn, p);
}

// The row quantize's split mode (tensor parallelism: the row's scale is the
// amax over the whole K, K / tp of it on this rank). pass 1 writes each
// row's local amax (m,) fp32 to `amax` (xq and xs untouched); pass 2 writes
// xq (m, k) int8 and xs (m,) fp32 with the scale of `amax` (the group's,
// all-reduced MAX in between). K a multiple of 32, as the GEMM takes it.
extern "C" int st_quantize_rows_split(const void* x, int x_f32, void* xq, void* xs, void* amax, int m, int k,
                                      int pass, void* stream) {
  if (m < 1 || k < 32 || k % 32 != 0 || (pass != 1 && pass != 2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pass == 1 ? launch_quantize_split<1>(x, x_f32, xq, xs, amax, m, k, s)
                                    : launch_quantize_split<2>(x, x_f32, xq, xs, amax, m, k, s);
  return static_cast<int>(err);
}
