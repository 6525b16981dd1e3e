// W4A8 decode MLP for Hopper (sm_90a): int4 group-quantized weights times
// int8 per-row activations, with the silu junction fused into gate_up.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/int4_mlp.py:
//   `_gateup_kernel` (#13, :150)  x (m, E) -> h = silu(gate) * up (m, I) bf16   (gateup = 1)
//   `_matmul_kernel` (#14, :168)  x (m, K) -> out (m, N) bf16 | fp32           (gateup = 0)
// Each TPU kernel is one pallas_call over column panels of the packed weight:
// grid step 0 quantizes the whole x into VMEM scratch that the later steps
// reuse, and every step unpacks its (K/2, bn) panel one packed-row group at a
// time (`_group_dots`: the low nibbles are group gi, the high nibbles group
// gi + K/(2 group)), runs each group's int8 dot on the MXU, folds the -8 bias
// out with the row sums and accumulates dot * gscale in fp32; #13 does so for
// the gate and the up panel of the same columns and writes silu(g) * u.
// Contract (the plain versions in ops/int4_mlp.py state the same function):
//   x bf16 (m, K); q4 uint8 (C, K/2): one byte row per output column, byte r
//   holding row r in its LOW nibble and row r + K/2 in its HIGH nibble, both
//   stored +8 biased (C = 2I for gate_up, gate columns first; C = N for down);
//   gscale fp32 (K/group, C). Per row: xs = max(amax |x|, 1e-8) / 127,
//   xq = clip(round_half_even(x / xs), +-127). Per group g: the exact int32
//   dot of xq with the unsigned nibbles u, minus 8 * sum(xq over the group),
//   times gscale[g] in fp32; the groups summed in fp32, times xs. gate_up:
//   h = silu(g) * u in fp32, rounded to bf16. Only the order of the fp32
//   group sums differs from the plain version.
//
// What bounds it on the H100: bytes at small m, the products and their fold
// at decode m. Every weight byte is read once: 22.5 MB of nibbles and 1.4 MB
// of scales for the 3B gate_up (an 8.2 us bound at 3.35 TB/s), 11.3 MB and
// 0.7 MB for down (4.6 us). At m = 136 that is 12.3 G and 6.1 G int8
// operations, which only `wgmma` runs near the card's 1,979 TOP/s, and each
// of the 16 (86) groups of a row's dot must leave the int32 accumulator to be
// scaled into fp32: 2.3 G (1.1 G) scaled adds at m = 136. Every CTA also
// needs all of xq (278 KB at K = 2,048, 1.5 MB at K = 11,008) from L2.
//
// Design (the plan, ops/int4_mlp.py `w4_plan`, is the one source of truth for
// how a call is cut; `st_int4_mlp` refuses a plan it cannot run):
// - The row quantize is a prologue kernel (one CTA a row): xs, and xq written
//   once in the order the main kernel stages it: per row tile, ring stage
//   (128 packed bytes of K) and half (the low / high nibbles' columns), a
//   block of the tile's rows x 128 bytes with the 128-byte swizzle applied
//   (16-byte chunk c of row r at c ^ (r % 8)). A stage's B operand for all of
//   the CTA's rows is then ONE contiguous bulk copy, and xq crosses L2 once
//   per CTA, not once per 8 columns. The prologue triggers programmatic
//   dependent launch at its start, so the main kernel's CTAs launch while it
//   runs and stream weights (which do not depend on x) before
//   `griddepcontrol.wait`; the xq copies follow.
// - A CTA owns all rows of a row tile (up to 144: the 136 lanes of 128 slots
//   in one tile, so each weight byte is read from HBM once) and 16 weight
//   columns per warp, one to three warpgroups (three at the 3B decode shapes:
//   #13's 115 CTAs fill one wave, and 168 registers a thread still hold
//   N = 144): gate_up gives each warp 8 gate and the same 8 up columns (the
//   silu junction in registers), down 16.
//   A ring of stages: the xq block by `cp.async.bulk`, the weight box(es)
//   (128 packed bytes x the CTA's columns, 128-byte swizzle) and the group
//   scales by TMA, one mbarrier a stage. Thread 0 issues the first stages; the
//   last warp done with a stage (a count in shared memory) refills its slot,
//   so no warp waits for the others.
// - The products run on `wgmma` m64nNk32 s8 x s8 with the operands swapped:
//   the warpgroup's 64 weight columns are M, A from registers; the tile's
//   rows are N (8 to 144), B the staged xq read by the descriptor. A weight
//   nibble u becomes the int8 u - 8 in registers (three integer operations a
//   word), so the dot is the contract's xq . u - 8 sum xq exactly, with no row
//   sums. A group's k32 steps accumulate in the int32 wgmma accumulator; at
//   the group's end it is waited on, converted exactly (an integer and a float
//   add, not the quarter-rate I2F) and scaled into fp32 accumulators that stay
//   in registers. A of two k32 steps is held at a time (a step's registers
//   are rewritten once the product two steps back has read them), which keeps
//   the N = 144 instances free of spills. The epilogue takes the tile's row
//   scales by a few loads a lane and shuffles, and swaps a row's value between
//   neighbour lanes so that every store writes two adjacent columns.
// - Down at the 3B widths has only 11 CTAs' worth of columns: the plan splits
//   the ring stages (K) over a thread-block cluster of up to 8 CTAs (clusters
//   of 8 only within two thirds of the SMs: 16 of them at one CTA an SM did
//   not all fit the GPCs at once). Each rank's fp32
//   partial tile goes to its shared memory, and each rank sums its share of
//   the rows over all ranks in rank order through distributed shared memory:
//   no workspace, no float atomics, two calls bit-identical.
// What it does not do (measured costs in PERF.md): overlap one group's
// fold with the next group's products (a second int32 accumulator does not
// fit the registers at N = 144; warpgroups taking turns on the tensor cores
// measured slower), multicast the xq blocks across a cluster (59% of a
// stage's bytes), a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr float EPS = 1e-8f;
constexpr int QTHREADS = 256;       // the prologue's CTA: one row
constexpr int STAGE_K = 128;        // packed bytes of K a ring stage: one 128-byte swizzled row
constexpr int WARP_COLS = 16;       // weight columns of a consumer warp: its m16 slice of the warpgroup's m64
constexpr int MAX_TILE_ROWS = 144;  // rows of a row tile (wgmma's N)
constexpr int MAX_WARPS = 12;       // consumer warps of a CTA: up to three warpgroups, 168 registers a thread
constexpr int MAX_RANKS = 8;        // CTAs of a cluster that split K (the portable cluster size)
constexpr int MAX_STAGES = 6;
constexpr int PART_PAD = 4;         // floats of padding a row of a rank's partial tile
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use on the H100

// The row tiles that are built: wgmma's N (the accumulators are registers,
// so N is a template parameter); a plan's tile_rows is one of them.
#define W4_N(X) X(8) X(16) X(32) X(64) X(96) X(128) X(144)

// Bytes of a CTA's dynamic shared memory (ops/int4_mlp.py `stage_layout` computes the same).
struct Layout {
  int xq;     // a stage's xq block: the low then the high half's rows x 128 bytes
  int w;      // its weight box(es): the CTA's columns x 128 bytes
  int sbox;   // one scale box (a half's groups of the stage x a matrix's columns, fp32), padded to 128
  int stage;  // xq + w + the 2 x nmat scale boxes, padded to 1024
  int body;   // the ring, or a rank's partial tile where that is larger (it reuses the ring)
  int total;  // + 1 KB to align the ring, + a full barrier and a done count a stage
};
__host__ __device__ inline Layout stage_layout(int tile_rows, int warps, int group, int stages, int ranks,
                                               int nmat) {
  Layout L;
  L.xq = 2 * tile_rows * STAGE_K;
  L.w = WARP_COLS * warps * STAGE_K;
  L.sbox = round_up((STAGE_K / group) * (WARP_COLS * warps / nmat) * 4, 128);
  L.stage = round_up(L.xq + L.w + 2 * nmat * L.sbox, 1024);
  const int ring = stages * L.stage;
  const int part = ranks > 1 ? tile_rows * (WARP_COLS * warps + PART_PAD) * 4 : 0;
  L.body = part > ring ? part : ring;
  L.total = 1024 + L.body + 16 * stages;
  return L;
}

// Byte offset of xq[r][c] in the staged layout: row tile t = r / tile_rows,
// stage st = (packed byte of c) / 128, half h (c >= K/2); a block of
// tile_rows x 128 bytes each, the 16-byte chunk b / 16 of row rl stored at
// chunk (b / 16) ^ (rl % 8) (ops/int4_mlp.py `staged_offsets` computes the same).
__host__ __device__ inline size_t staged_offset(int r, int c, int k, int tile_rows, int n_stages) {
  const int t = r / tile_rows, rl = r - t * tile_rows;
  const int h = c >= k / 2 ? 1 : 0;
  const int p = c - h * (k / 2);
  const int st = p / STAGE_K, b = p % STAGE_K;
  return ((((size_t)t * n_stages + st) * 2 + h) * tile_rows + rl) * STAGE_K + (((b >> 4) ^ (rl & 7)) << 4) +
         (b & 15);
}

__device__ __forceinline__ int quantize_one(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}
// two bf16 pairs (4 consecutive values) -> their 4 int8 values in one word
__device__ __forceinline__ uint32_t quantize_word(uint32_t lo, uint32_t hi, float s) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return (quantize_one(a.x, s) & 0xFF) | ((quantize_one(a.y, s) & 0xFF) << 8) |
         ((quantize_one(b.x, s) & 0xFF) << 16) | (static_cast<uint32_t>(quantize_one(b.y, s) & 0xFF) << 24);
}
__device__ __forceinline__ float bf16x2_amax(uint32_t w, float amax) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
}

// One CTA a row: xs = max(amax, eps) / 127 (IEEE division, as the plain
// version), xq = clip(rint(x / xs)) in the staged layout, 16 values (one
// 16-byte store) at a time. K % 64 == 0, so a 16-value chunk never straddles
// a half or a stage.
__global__ void __launch_bounds__(QTHREADS)
int4_quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int k,
                          int tile_rows, int n_stages) {
  griddep_launch_dependents();  // the main kernel may start streaming weights now
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * k);  // 8 bf16 a vector
  float amax = 0.f;
  for (int v = threadIdx.x; v < k / 8; v += QTHREADS) {
    const uint4 a = xr[v];
    amax = bf16x2_amax(a.w, bf16x2_amax(a.z, bf16x2_amax(a.y, bf16x2_amax(a.x, amax))));
  }
  amax = warp_max(amax);
  __shared__ float warp_amax[QTHREADS / 32];
  __shared__ float row_scale;
  if (lane == 0) warp_amax[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int w = 0; w < QTHREADS / 32; ++w) v = fmaxf(v, warp_amax[w]);
    row_scale = fmaxf(v, EPS) / 127.0f;
    xs[row] = row_scale;
  }
  __syncthreads();
  const float s = row_scale;
  for (int c16 = threadIdx.x; c16 < k / 16; c16 += QTHREADS) {
    const uint4 a = xr[2 * c16], b = xr[2 * c16 + 1];
    const uint4 q = make_uint4(quantize_word(a.x, a.y, s), quantize_word(a.z, a.w, s), quantize_word(b.x, b.y, s),
                               quantize_word(b.z, b.w, s));
    *reinterpret_cast<uint4*>(xq + staged_offset(row, 16 * c16, k, tile_rows, n_stages)) = q;
  }
}

// The stored nibbles u (1..15) in the low nibbles of a word's bytes, as the
// four int8 values u - 8: (u | 0x80) - 8 borrows across no byte, and the xor
// with 0x80 takes each byte back to u - 8 mod 256.
__device__ __forceinline__ uint32_t signed_nibbles(uint32_t w) {
  return (((w & 0x0F0F0F0Fu) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// float(c) for |c| < 2^22 (a group's dot is at most 127 x 7 x 128), exactly,
// by an integer and a float add at full rate instead of the quarter-rate
// conversion: 0x4B400000 is 1.5 x 2^23, whose mantissa's low 22 bits take c.
__device__ __forceinline__ float exact_float(int c) { return __int_as_float(0x4B400000 + c) - 12582912.0f; }

__device__ __forceinline__ float silu_mul(float g, float u) { return (g * (1.f / (1.f + expf(-g)))) * u; }

// ---- wgmma ----
// D (64 x N, s32) = A (64 x 32, s8, registers) B (N x 32, s8, K-major in
// shared memory)^T (+ D when scale_d != 0). A's fragment in a warp of the
// warpgroup is mma.m16n8k32's: a[0] row gid, k 4 tig .. + 3; a[1] row gid + 8,
// the same k; a[2], a[3] the same rows at k 16 + 4 tig ...
template <int N>
__device__ __forceinline__ void wgmma_rs(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs<8>(int (&d)[4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(int (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(int (&d)[48], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(int (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<144>(int (&d)[72], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// grid (ranks x column blocks, row tiles), a cluster of (ranks, 1, 1) when
// ranks > 1: the rank is blockIdx.x % ranks. `warps` warps (one to three
// warpgroups); thread 0 issues the ring's first stages. Warp w owns its
// warpgroup's m16 slice of weight columns: its fragment rows gid (sub 0) and gid + 8
// (sub 1) are, for gate_up, gate and up column 8 w + gid of the CTA's, for
// down columns 16 w + gid and 16 w + gid + 8. A row tile holds N rows (N is
// wgmma's N: the rows are the B operand); the accumulators hold rows
// 8 j + 2 tig + e in acc[4 j + 2 sub + e].
template <int N, bool GATEUP, typename OutT>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
int4_mlp_kernel(const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_s,
                const int8_t* __restrict__ xq, const float* __restrict__ xs, OutT* __restrict__ out, int m, int k,
                int n_out, int group, int warps, int ranks, int stages) {
  constexpr int NMAT = GATEUP ? 2 : 1;
  constexpr int R = N / 2;  // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  const Layout L = stage_layout(N, warps, group, stages, ranks, NMAT);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* ring = smem_raw + (base - raw);
  const uint32_t full0 = base + L.body, empty0 = full0 + 8 * stages;

  const int cm = WARP_COLS * warps / NMAT;  // columns of each matrix the CTA owns
  const int rank = blockIdx.x % ranks;
  const int col0 = (blockIdx.x / ranks) * cm;
  const int row0 = blockIdx.y * N;
  const int rows = min(N, m - row0);
  const int half = k / 2;
  const int n_stages = (half + STAGE_K - 1) / STAGE_K;
  const int hg = half / group;         // groups of each half
  const int gps = STAGE_K / group;     // groups of a half in a full stage
  const int spg = group / 32;          // k32 steps a group: 1, 2 or 4
  const int lg = spg == 4 ? 2 : spg - 1;
  const int per = n_stages / ranks, extra = n_stages % ranks;
  const int st0 = rank * per + min(rank, extra);
  const int n_st = per + (rank < extra ? 1 : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the feeder's expect_tx
      *reinterpret_cast<uint32_t*>(smem_raw + (empty0 + 8 * s - raw)) = 0;  // warps done with the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage st into ring slot `slot`: its weight box(es) and scale boxes by TMA, its xq block by one bulk copy
  const int tx = L.xq + NMAT * cm * STAGE_K + 2 * NMAT * gps * cm * 4;
  const int8_t* xq_tile = xq + (size_t)blockIdx.y * n_stages * L.xq;
#define W4_FEED_WEIGHTS(st, slot)                                                                                 \
  do {                                                                                                            \
    const uint32_t dst_ = base + (slot) * L.stage, bar_ = full0 + 8 * (slot);                                     \
    for (int mat = 0; mat < NMAT; ++mat) {                                                                        \
      tma_load(dst_ + L.xq + mat * cm * STAGE_K, &map_w, (st) * STAGE_K, mat * n_out + col0, bar_);              \
      for (int h_ = 0; h_ < 2; ++h_)                                                                              \
        tma_load(dst_ + L.xq + L.w + (h_ * NMAT + mat) * L.sbox, &map_s, mat * n_out + col0, h_ * hg + (st) * gps, \
                 bar_);                                                                                           \
    }                                                                                                             \
  } while (0)
#define W4_FEED_XQ(st, slot) \
  bulk_g2s(base + (slot) * L.stage, xq_tile + (size_t)(st) * L.xq, L.xq, full0 + 8 * (slot))
  if (threadIdx.x == 0) {
    // weights and scales first (x-independent), then xq once the prologue is done
    const int pre = min(stages, n_st);
    for (int i = 0; i < pre; ++i) {
      mbar_expect_tx(full0 + 8 * i, tx);
      W4_FEED_WEIGHTS(st0 + i, i);
    }
    griddep_wait();
    for (int i = 0; i < pre; ++i) W4_FEED_XQ(st0 + i, i);
  }
  __syncwarp();

  // this thread's two weight rows in a stage (sub 0, 1) and their scale columns
  int wrow[2], scol[2];
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    const int mat = GATEUP ? sub : 0;
    const int c = GATEUP ? 8 * warp + gid : 16 * warp + gid + 8 * sub;  // column in its matrix
    wrow[sub] = L.xq + (mat * cm + c) * STAGE_K;
    scol[sub] = mat * (L.sbox / 4) + c;
  }

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  int d[R];
  for (int i = 0; i < n_st; ++i) {
    const int slot = i % stages;
    mbar_wait(full0 + 8 * slot, (i / stages) & 1);
    __syncwarp();
    const uint8_t* st_base = ring + slot * L.stage;
    const uint32_t xq_s = base + slot * L.stage;
    const float* scales = reinterpret_cast<const float*>(st_base + L.xq + L.w);
    const int steps = min(STAGE_K, half - (st0 + i) * STAGE_K) / 32;  // live k32 steps of each half
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const uint32_t xq_h = xq_s + h * N * STAGE_K;
      const float* hs = scales + h * NMAT * (L.sbox / 4);
      // A of the stage's k32 step s: the packed bytes 32 s + 4 tig .. + 3 (a[0], a[1]: rows gid and gid + 8)
      // and 32 s + 16 + 4 tig .. + 3 (a[2], a[3]) of the thread's two weight rows, this half's nibbles as
      // u - 8; the 128-byte swizzle puts chunk c of a row at c ^ (row % 8) = c ^ gid. Two steps' A in
      // registers: step s's may be written once step s - 2's product has read it.
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s >= steps) break;
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = *reinterpret_cast<const uint32_t*>(st_base + wrow[q & 1] + (((2 * s + (q >> 1)) ^ gid) << 4) +
                                                    4 * tig);
        if (s >= 2) wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < 4; ++q) a[s & 1][q] = signed_nibbles(h ? w[q] >> 4 : w[q]);
        const bool first = (s & (spg - 1)) == 0;
        wgmma_fence();  // A was written, and at a group's start D read, by other instructions
        wgmma_rs<N>(d, a[s & 1], sw128_desc(xq_h + 32 * s), first ? 0 : 1);
        wgmma_commit();
        if (((s + 1) & (spg - 1)) == 0) {  // the group's int32 dot is complete: scale it in
          wgmma_wait<0>();
          fence_acc(d);
          const int g = s >> lg;
          const float s0 = hs[g * cm + scol[0]], s1 = hs[g * cm + scol[1]];
#pragma unroll
          for (int j = 0; j < R / 4; ++j) {
            acc[4 * j] += exact_float(d[4 * j]) * s0;
            acc[4 * j + 1] += exact_float(d[4 * j + 1]) * s0;
            acc[4 * j + 2] += exact_float(d[4 * j + 2]) * s1;
            acc[4 * j + 3] += exact_float(d[4 * j + 3]) * s1;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) {  // the last warp done with the slot refills it, so no warp waits for another
      uint32_t done;
      asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                   : "=r"(done) : "r"(empty0 + 8 * slot) : "memory");
      if (done == static_cast<uint32_t>(warps - 1)) {
        asm volatile("st.shared::cta.u32 [%0], 0;\n" ::"r"(empty0 + 8 * slot) : "memory");
        if (i + stages < n_st) {
          griddep_wait();  // the prologue's xq (returns at once after the first)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slot's reads before the copies
          mbar_expect_tx(full0 + 8 * slot, tx);
          W4_FEED_WEIGHTS(st0 + i + stages, slot);
          W4_FEED_XQ(st0 + i + stages, slot);
        }
      }
    }
    __syncwarp();
  }

  const int ocol = col0 + (GATEUP ? 8 : 16) * warp;  // the warp's first output column
  const bool live = ocol < n_out;
  if (ranks == 1) {
    griddep_wait();  // xs comes from the prologue
    if (!live) return;
    // lanes gid and gid ^ 1 swap one row's values so that each stores two adjacent columns of one row:
    // an even gid row 8 j + 2 tig, columns gid and gid + 1; an odd gid row 8 j + 2 tig + 1, gid - 1 and gid
    const bool even = (gid & 1) == 0;
    // the tile's row scales, lane l holding rows l + 32 t: all loads in flight at once, then shuffles
    float xs_lane[(N + 31) / 32];
#pragma unroll
    for (int t = 0; t < (N + 31) / 32; ++t) xs_lane[t] = xs[row0 + min(lane + 32 * t, rows - 1)];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int r0 = 8 * j + 2 * tig;  // rows 8 j .. 8 j + 7 lie in one 32-row block: lanes r0 % 32 and + 1
      const float sx0 = __shfl_sync(0xffffffffu, xs_lane[j / 4], r0 % 32);
      const float sx1 = __shfl_sync(0xffffffffu, xs_lane[j / 4], (r0 + 1) % 32);
      const int r = r0 + (even ? 0 : 1);
#pragma unroll
      for (int sub = 0; sub < (GATEUP ? 1 : 2); ++sub) {
        float v0, v1;  // rows r0 and r0 + 1 of this thread's column
        if constexpr (GATEUP) {
          v0 = silu_mul(acc[4 * j] * sx0, acc[4 * j + 2] * sx0);
          v1 = silu_mul(acc[4 * j + 1] * sx1, acc[4 * j + 3] * sx1);
        } else {
          v0 = acc[4 * j + 2 * sub] * sx0;
          v1 = acc[4 * j + 2 * sub + 1] * sx1;
        }
        const float theirs = __shfl_xor_sync(0xffffffffu, even ? v1 : v0, 4);
        if (r >= rows) continue;
        const float lo = even ? v0 : theirs, hi = even ? theirs : v1;
        OutT* dst = out + (size_t)(row0 + r) * n_out + ocol + (gid & ~1) + 8 * sub;
        if constexpr (sizeof(OutT) == 4) {
          *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
        }
      }
    }
    return;
  }

  // split K: each rank's partial tile (rows x the CTA's columns, gate then up) in its shared memory
  __syncthreads();  // every slot is consumed: the partial may overwrite the ring
  float* part = reinterpret_cast<float*>(const_cast<uint8_t*>(ring));
  const int pstride = WARP_COLS * warps + PART_PAD;
  if (live) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          const int pc = GATEUP ? sub * cm + 8 * warp + gid : 16 * warp + gid + 8 * sub;
          part[(8 * j + 2 * tig + e) * pstride + pc] = acc[4 * j + 2 * sub + e];
        }
  }
  cluster_sync();
  griddep_wait();
  // this rank's share of the rows, summed over the ranks in rank order, four columns a thread
  const int share = (rows + ranks - 1) / ranks;
  const int r_lo = rank * share, r_hi = min(rows, r_lo + share);
  const int c4 = cm / 4, total = (r_hi - r_lo) * c4, step = 32 * warps;
  constexpr int BATCH = GATEUP ? 2 : 4;  // quads a thread sums at once: a rank's remote loads in flight together
  for (int i0 = threadIdx.x; i0 < total; i0 += BATCH * step) {
    const float* src[BATCH];
    float4 g[BATCH], u[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int idx = min(i0 + b * step, total - 1);  // past the end: a repeat, never stored
      src[b] = part + (r_lo + idx / c4) * pstride + (idx % c4) * 4;
      g[b] = *reinterpret_cast<const float4*>(rank_ptr(src[b], 0, ranks));
      if (GATEUP) u[b] = *reinterpret_cast<const float4*>(rank_ptr(src[b] + cm, 0, ranks));
    }
    for (int q = 1; q < ranks; ++q) {
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const float4 v = *reinterpret_cast<const float4*>(rank_ptr(src[b], q, ranks));
        g[b].x += v.x, g[b].y += v.y, g[b].z += v.z, g[b].w += v.w;
        if (GATEUP) {
          const float4 v2 = *reinterpret_cast<const float4*>(rank_ptr(src[b] + cm, q, ranks));
          u[b].x += v2.x, u[b].y += v2.y, u[b].z += v2.z, u[b].w += v2.w;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int idx = i0 + b * step;
      if (idx >= total) break;
      const int r = r_lo + idx / c4, c = (idx % c4) * 4;
      if (col0 + c >= n_out) continue;  // n_out % 8 == 0, c % 4 == 0: all four columns in or out
      const float sx = xs[row0 + r];
      OutT* dst = out + (size_t)(row0 + r) * n_out + col0 + c;
      float4 o;
      if (GATEUP) {
        o = make_float4(silu_mul(g[b].x * sx, u[b].x * sx), silu_mul(g[b].y * sx, u[b].y * sx),
                        silu_mul(g[b].z * sx, u[b].z * sx), silu_mul(g[b].w * sx, u[b].w * sx));
      } else {
        o = make_float4(g[b].x * sx, g[b].y * sx, g[b].z * sx, g[b].w * sx);
      }
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<float4*>(dst) = o;
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y), hi = __floats2bfloat162_rn(o.z, o.w);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst) = packed;
      }
    }
  }
  cluster_sync();  // no CTA leaves while another still reads its partial
#undef W4_FEED_WEIGHTS
#undef W4_FEED_XQ
}

// ---- host side ----

// A 2-D row-major tensor of `outer` rows x `inner` elements, read in boxes of
// box_inner x box_outer; out-of-range elements read as zeros.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr, int inner, int outer,
                int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Launch {
  const CUtensorMap* map_w;
  const CUtensorMap* map_s;
  const int8_t* xq;
  const float* xs;
  void* out;
  int m, k, n_out, group, warps, ranks, stages, smem, col_blocks, row_tiles;
  cudaStream_t stream;
};

template <int N, bool GATEUP, typename OutT>
int launch_main(const Launch& p) {
  auto kernel = int4_mlp_kernel<N, GATEUP, OutT>;
  int device = 0;
  cudaGetDevice(&device);
  static bool configured[64] = {};  // per device: the opt-in to large dynamic shared memory
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.ranks * p.col_blocks, p.row_tiles, 1);
  config.blockDim = dim3(32 * p.warps, 1, 1);
  config.dynamicSmemBytes = p.smem;
  config.stream = p.stream;
  cudaLaunchAttribute attrs[2];
  int n_attrs = 0;
  if (p.ranks > 1) {
    attrs[n_attrs].id = cudaLaunchAttributeClusterDimension;
    attrs[n_attrs].val.clusterDim.x = p.ranks;
    attrs[n_attrs].val.clusterDim.y = 1;
    attrs[n_attrs].val.clusterDim.z = 1;
    ++n_attrs;
  }
  // the prologue's CTAs have all started before any of these launch (each
  // triggers at its start), so the waiting CTAs never hold an SM it needs
  attrs[n_attrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[n_attrs].val.programmaticStreamSerializationAllowed = 1;
  ++n_attrs;
  config.attrs = attrs;
  config.numAttrs = n_attrs;
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, *p.map_w, *p.map_s, p.xq, p.xs,
                                             static_cast<OutT*>(p.out), p.m, p.k, p.n_out, p.group, p.warps,
                                             p.ranks, p.stages));
}

bool built_tile(int tile_rows) {
#define W4_BUILT(N) \
  if (tile_rows == N) return true;
  W4_N(W4_BUILT)
#undef W4_BUILT
  return false;
}

template <bool GATEUP, typename OutT>
int dispatch(int tile_rows, const Launch& p) {
#define W4_LAUNCH(N) \
  if (tile_rows == N) return launch_main<N, GATEUP, OutT>(p);
  W4_N(W4_LAUNCH)
#undef W4_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x bf16 (m, k); scratch: the staged xq (row tiles x stages x 2 x tile_rows x
// 128 bytes), then xs fp32 (m,) (ops/int4_mlp.py `W4Plan.scratch_bytes`);
// q4 (n_cols, k/2) uint8; gscale (k/group, n_cols) fp32; out (m, n_cols/2)
// bf16 for gate_up, (m, n_cols) bf16 | fp32 (out_f32) for down. The plan
// (ops/int4_mlp.py `w4_plan`): `warps` (4 or 8) consumer warps of 16 weight
// columns a CTA, K's ring stages split over `ranks` CTAs of a cluster, a ring
// of `stages`, row tiles of `tile_rows` rows (a built N); a plan or shape this file cannot
// run is refused (cudaErrorInvalidValue) before anything launches. Launches
// the prologue and the main kernel on `stream`; returns the first launch
// error (0 = launched).
extern "C" int st_int4_mlp(const void* x, void* scratch, const void* q4, const void* gscale, void* out, int m, int k,
                           int n_cols, int group, int gateup, int out_f32, int warps, int ranks, int stages,
                           int tile_rows, void* stream) {
  const int nmat = gateup ? 2 : 1;
  if (m < 1 || (group != 32 && group != 64 && group != 128) || k < 2 * group || k % (2 * group) != 0 ||
      n_cols % nmat != 0 || (gateup && out_f32) || warps % 4 != 0 || warps < 4 || warps > MAX_WARPS ||
      tile_rows > MAX_TILE_ROWS || !built_tile(tile_rows) || stages < 2 || stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_out = n_cols / nmat;
  const int cm = WARP_COLS * warps / nmat;
  const int n_stages = (k / 2 + STAGE_K - 1) / STAGE_K;
  const int row_tiles = (m + tile_rows - 1) / tile_rows;
  const int col_blocks = (n_out + cm - 1) / cm;
  const Layout L = stage_layout(tile_rows, warps, group, stages, ranks, nmat);
  if (n_out % (WARP_COLS / nmat) != 0 || ranks < 1 || ranks > MAX_RANKS || ranks > n_stages ||
      L.total > SMEM_LIMIT || row_tiles > 65535 || (long long)ranks * col_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_w, map_s;
  if (!encode_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q4, k / 2, n_cols, STAGE_K, cm,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&map_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, gscale, n_cols, k / group, cm, STAGE_K / group,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  int8_t* xq = static_cast<int8_t*>(scratch);
  float* xs = reinterpret_cast<float*>(xq + (size_t)row_tiles * n_stages * 2 * tile_rows * STAGE_K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4_quantize_rows_kernel<<<m, QTHREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x), xq, xs, k, tile_rows,
                                                   n_stages);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch p{&map_w, &map_s, xq, xs, out, m, k, n_out, group, warps, ranks, stages, L.total, col_blocks,
                 row_tiles, s};
  if (gateup) return dispatch<true, __nv_bfloat16>(tile_rows, p);
  return out_f32 ? dispatch<false, float>(tile_rows, p) : dispatch<false, __nv_bfloat16>(tile_rows, p);
}
