// Decode attention for Hopper (sm_90a): one new query token per sequence
// against one layer of the stacked dense KV cache.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/decode_attention.py
// (launched by `_pallas_decode`):
//   `_decode_kernel`          bf16 cache (mode 0) and int8 cache with per-cell
//                             scales (mode 1): `decode_split_kernel` below;
//   `_decode_kernel_int4`     int4 cache, dots on the unsigned nibbles widened
//                             to floating point (mode 2);
//   `_decode_kernel_int4_i8`  int4 cache, both dots on int8 operands (mode 3).
// Modes 2 and 3 are `decode_quant_kernel` in the second half of this file.
// Same contract:
//   q (B, Hq, D) bf16; k/v cache (L, B, Hkv, S, D) bf16 | int8, or uint8
//   (L, B, Hkv, S/2, D) for int4 (byte row r holds token r in its low nibble
//   and token r + S/2 in its high nibble, both +8 biased: split-half over the
//   WHOLE cache width); scales (L, B, Hkv, S) bf16 per token cell;
//   kv_seg (B, S) int32, nonzero = valid cell; layer = which layer to attend;
//   o (B, Hq, D) bf16, zero rows where no cell is valid.
// No (B, Hkv, S, D) slice of a layer is copied, as on the TPU.
//
// What bounds it on the H100: bytes. A step reads every live K/V cell once
// (2 * D * 2 bytes per bf16 cell and kv head, 2 * (D + 2) for int8 with its
// scales) and does ~4 * G * D operations per cell, far under the card's
// operations-per-byte balance. What keeps a kernel from the byte bound is
// latency: too few CTAs for the SMs, loads waited on in series.
//
// ---- modes 0 and 1: `decode_split_kernel` ----
// One plan per call (ops/decode_attention.py `decode_plan`): the 64-token
// tiles of a (row, kv head) stripe are split over a thread-block cluster of
// up to 8 CTAs (ranks) where the (row, kv head) pairs leave CTA slots idle (a
// CTA walks its tiles in series behind a fixed cost of several µs, and the
// CTAs an SM's shared memory holds at once -- two in bf16, three in int8 --
// overlap); rank r takes tiles r, r + n, ... . A producer warp reads the row's
// kv_seg ahead of the loads, 64 cells a tile as two ballots, and skips a tile
// with no valid cell before any of its bytes are read (exact: such a tile
// adds nothing); a live tile's K and V arrive by TMA (3-D tensor maps over
// the stacked cache, 128-byte swizzle, so the fragment loads below meet no
// bank conflict; cells past the width read as zeros) with the tile's int8
// scales by one bulk copy each, into a ring of `stages` slots with a full and
// an empty mbarrier a slot. Its 64-bit validity mask rides in the slot's
// header. Four consumer warps take 16 tokens of a tile each, both products on
// `mma.sync.m16n8k16` bf16 (the per-warp `mma.sync` keeps each warp's online
// softmax its own with no CTA barrier a tile; `wgmma`'s 64-row tiles would
// tie four warps to one softmax, and its B operand from shared memory would
// need the int8 values converted there):
//   scores S^T = K_tile . q^T with the tokens as M and up to 8 query heads as
//     N (G = 8 of the 3B preset is exactly n8; G <= 16 takes two N tiles, q's
//     padding heads zero in registers, never in the caller's tensors);
//   the weights P^T go from the scores' accumulator layout to the B layout of
//     the next product by `movmatrix.trans` (no shared memory);
//   output O^T += V^T . P^T with d as M, V^T by `ldmatrix.trans`.
// Mode 1 converts the int8 K and V to bf16 in registers (exact, as the TPU
// kernel's `.astype(jnp.bfloat16)`), loading them with 16-byte shared loads in
// a k order the q fragments follow; it multiplies the scores by
// k_scale * scale per cell and rounds p * v_scale to bf16 before p . v, as
// the TPU kernel and the plain version do. Each warp keeps its own running
// max; the four warps meet in warp order at the end, then the ranks in
// distributed shared memory in rank order, so two calls are bit-identical. A
// row with no valid cell gives exact zeros.
//
// ---- modes 2 and 3: `decode_quant_kernel` ----
// One CTA of 4 warps per (row, kv head), synchronous 64-row tiles and fp32 /
// dp4a dots (their first design; see the comment above the kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int QD = 128;       // head dim (text heads of the 3B/7B presets)
constexpr int GMAX = 16;      // largest query group per kv head
constexpr float NEG_INF = -1e30f;
constexpr int MODE_BF16 = 0, MODE_INT8 = 1, MODE_INT4 = 2, MODE_INT4_I8 = 3;
constexpr int MAX_SMEM = 232448;  // bytes a block may opt in to on sm_90

// ---------------------------------------------------------------------------
// Modes 0 and 1: the split kernel.

constexpr int TILE = 64;                        // tokens a ring slot holds: one TMA box of rows
constexpr int WARP_ROWS = 16;                   // tokens a consumer warp takes of a tile (the M of its products)
constexpr int CONSUMERS = TILE / WARP_ROWS;     // consumer warps; one producer warp more
constexpr int SPLIT_THREADS = 32 * (CONSUMERS + 1);
constexpr int SPLIT_MAX_CLUSTER = 8;            // the portable cluster size
constexpr int SPLIT_MAX_STAGES = 4;
constexpr int BOX_BYTES = TILE * 128;           // a 64-row x 128-byte TMA box (the 128-byte swizzle span)
constexpr int PART_STRIDE = QD + 4;             // floats per head row of the partial outputs

// Shared memory of the split kernel, computed alike on host and device. The
// ring's slots (K boxes, V boxes, the tile's k and v scales) start 1024-byte
// aligned; after the last tile they hold the warps' partial outputs and the
// CTA's sum of them.
struct SplitLayout {
  int slot;      // bytes of a ring slot
  int off_hdr;   // per slot: the tile, its validity mask (two words)
  int off_red;   // per warp and head: m, l, combine weight; per head: the CTA's m, l; the ranks' weights
  int off_bar;   // full[stages], empty[stages]
  int total;     // with 1 KB of slack to align the ring
};

__host__ __device__ inline SplitLayout split_layout(int mode, int nt, int stages) {
  SplitLayout L;
  const int g16 = 8 * nt;
  L.slot = round_up((mode == MODE_BF16 ? 4 : 2) * BOX_BYTES + 2 * TILE * 2, 1024);
  const int ring = stages * L.slot;
  const int part = (CONSUMERS + 1) * g16 * PART_STRIDE * 4;
  int off = ring > part ? ring : part;
  L.off_hdr = off;  off += stages * 16;
  L.off_red = off;  off += (3 * CONSUMERS + 2 + SPLIT_MAX_CLUSTER + 1) * g16 * 4;
  L.off_bar = round_up(off, 8);
  L.total = L.off_bar + 2 * stages * 8 + 1024;
  return L;
}

// A (128-byte, 64-row, 1) box of `map` at (c0, c1, c2) into shared memory; completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
// the 8 x 8 b16 matrix of the warp's fragments (thread (g, t): row g, columns 2t, 2t + 1), transposed
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// bytes `i` of words x and y (int8) as a bf16 pair (x's in the low half): exact
__device__ __forceinline__ uint32_t i8_pair(uint32_t x, uint32_t y, int i) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(x >> (8 * i))),
                   static_cast<float>(static_cast<int8_t>(y >> (8 * i))));
}
// word j (0-3) of a 16-byte value
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
// byte offset of (row, byte column c) in a 64-row box written with the 128-byte swizzle: the
// 16-byte chunk c / 16 of row r sits at chunk (c / 16) ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int row, int c) {
  return row * 128 + ((((c >> 4) ^ row) & 7) << 4) + (c & 15);
}

// Output column of fragment value c (0-3) of M tile x, lane (gid, tig): mode 0 takes d = 16 x + gid
// (+ 8) as `ldmatrix.trans` delivers V^T; mode 1 d = 16 gid + 2 x (+ 1), the columns its thread
// loaded as one 16-byte chunk of V.
template <int MODE>
__device__ __forceinline__ int out_col(int x, int c, int gid) {
  return MODE == MODE_BF16 ? 16 * x + gid + 8 * (c >> 1) : 16 * gid + 2 * x + (c >> 1);
}

// NT: N tiles of 8 heads (1: G <= 8, 2: G <= 16). Grid (n, B, Hkv): the n CTAs of a (row, kv head)
// form a cluster. Warps 0-3 consume (warp w: rows 16 w .. 16 w + 15 of every tile), warp 4 produces.
// Fragments (gid = lane / 4, tig = lane % 4): scores of rows gid, gid + 8 of the warp's 16 and heads
// nt * 8 + 2 tig (+ 1); outputs of columns out_col(x, c, gid), the same heads.
template <int MODE, int NT>
__global__ void __launch_bounds__(SPLIT_THREADS)
decode_split_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ kv_seg,
                    __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv, int stripe0, float scale,
                    int stages) {
  constexpr int G16 = 8 * NT;
  constexpr int NBOX = MODE == MODE_BF16 ? 2 : 1;  // TMA boxes of a tile and operand (128 bytes of d each)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const SplitLayout L = split_layout(MODE, NT, stages);
  const int n_split = gridDim.x, rank = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int G = Hq / Hkv;
  const int n_tiles = (S + TILE - 1) / TILE;
  const size_t stripe = (size_t)b * Hkv + h;
  const bool bulk_scales = MODE == MODE_INT8 && (S & 7) == 0;  // the tile's scales are 16-byte aligned
  int* hdr = reinterpret_cast<int*>(smem + L.off_hdr);           // slot s: tile, mask bits 0-31, 32-63
  float* red_m = reinterpret_cast<float*>(smem + L.off_red);    // [warp][head]
  float* red_l = red_m + CONSUMERS * G16;
  float* red_w = red_l + CONSUMERS * G16;
  float* fin_m = red_w + CONSUMERS * G16;                        // [head]
  float* fin_l = fin_m + G16;
  float* wts = fin_l + G16;                                      // [my head][rank], then its l
  const uint32_t full0 = smem_u32(smem + L.off_bar), empty0 = full0 + 8 * stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  float m_run[NT][2], l_run[NT][2], acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) m_run[nt][e] = NEG_INF, l_run[nt][e] = 0.f;
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][x][c] = 0.f;
  }

  if (warp == CONSUMERS) {
    // ---- the producer: this rank's tiles with a valid cell, in order, then an end marker ----
    const int* seg = kv_seg + (size_t)b * S;
    const int z = stripe0 + static_cast<int>(stripe);
    auto valid = [&](int t, int j) { return t < n_tiles && t * TILE + j < S && seg[t * TILE + j] != 0; };
    bool c0 = valid(rank, lane), c1 = valid(rank, lane + 32);
    int i = 0;  // live tiles issued
    for (int t = rank; t < n_tiles; t += n_split) {
      const bool n0 = valid(t + n_split, lane), n1 = valid(t + n_split, lane + 32);  // the next tile's, early
      const uint32_t m0 = __ballot_sync(0xffffffffu, c0), m1 = __ballot_sync(0xffffffffu, c1);
      c0 = n0, c1 = n1;
      if ((m0 | m1) == 0) continue;  // no valid cell: none of its bytes is read
      const int s = i % stages;
      if (i >= stages) mbar_wait(empty0 + 8 * s, (i / stages - 1) & 1);
      if (lane == 0) {
        hdr[4 * s] = t;
        hdr[4 * s + 1] = static_cast<int>(m0);
        hdr[4 * s + 2] = static_cast<int>(m1);
        const uint32_t bar = full0 + 8 * s, dst = smem_u32(smem + s * L.slot);
        const int scale_bytes = bulk_scales ? min(TILE, S - t * TILE) * 2 : 0;
        mbar_expect_tx(bar, 2 * NBOX * BOX_BYTES + 2 * scale_bytes);
#pragma unroll
        for (int bx = 0; bx < NBOX; ++bx) {
          tma_load_3d(dst + bx * BOX_BYTES, &kmap, bx * 64, t * TILE, z, bar);
          tma_load_3d(dst + (NBOX + bx) * BOX_BYTES, &vmap, bx * 64, t * TILE, z, bar);
        }
        if (scale_bytes) {
          bulk_g2s(dst + 2 * NBOX * BOX_BYTES, k_scale + stripe * S + t * TILE, scale_bytes, bar);
          bulk_g2s(dst + 2 * NBOX * BOX_BYTES + TILE * 2, v_scale + stripe * S + t * TILE, scale_bytes, bar);
        }
      }
      __syncwarp();
      ++i;
    }
    const int s = i % stages;
    if (i >= stages) mbar_wait(empty0 + 8 * s, (i / stages - 1) & 1);
    if (lane == 0) {
      hdr[4 * s] = -1;
      mbar_arrive(full0 + 8 * s);
    }
  } else {
    // ---- a consumer warp: rows r0 .. r0 + 15 of every tile ----
    const int r0 = WARP_ROWS * warp;
    // q as the scores' B fragments: mode 0 k = 2 tig (+1) of step ks is d = 16 ks + 2 tig (+ 1), k = 2 tig + 8
    // (+1) d + 8; mode 1 d = 32 tig + 4 ks + 0, 1 and 2, 3 (the bytes a thread loads of a K row)
    uint32_t qb[NT][8][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int head = nt * 8 + gid;
      const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)h * G + (head < G ? head : 0)) * QD;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t w0 = 0, w1 = 0;
        if (head < G) {
          if (MODE == MODE_BF16) {
            w0 = *reinterpret_cast<const uint32_t*>(qh + 16 * ks + 2 * tig);
            w1 = *reinterpret_cast<const uint32_t*>(qh + 16 * ks + 2 * tig + 8);
          } else {
            const uint2 w = *reinterpret_cast<const uint2*>(qh + 32 * tig + 4 * ks);
            w0 = w.x, w1 = w.y;
          }
        }
        qb[nt][ks][0] = w0, qb[nt][ks][1] = w1;
      }
    }
    const __nv_bfloat16* ksg = k_scale + stripe * S;
    const __nv_bfloat16* vsg = v_scale + stripe * S;

    for (int i = 0;; ++i) {
      const int s = i % stages;
      mbar_wait(full0 + 8 * s, (i / stages) & 1);
      const int tile = hdr[4 * s];
      if (tile < 0) break;
      const uint32_t mine = (static_cast<uint32_t>(hdr[4 * s + 1 + (r0 >> 5)]) >> (r0 & 31)) & 0xFFFFu;
      if (mine) {
        const unsigned char* slot = smem + s * L.slot;
        const uint32_t kbase = smem_u32(slot), vbase = kbase + NBOX * BOX_BYTES;
        const bool v0 = (mine >> gid) & 1u, v1 = (mine >> (gid + 8)) & 1u;
        const int tok0 = tile * TILE + r0 + gid;  // this thread's tokens: tok0 and tok0 + 8

        // ---- scores S^T (16 tokens x 8 heads a tile of N) ----
        float sc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
        if (MODE == MODE_BF16) {
          const int row = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const int d = 16 * ks + 8 * (lane >> 4);  // bf16 column: box d / 64, byte 2 (d % 64)
            uint32_t a[4];
            ldmatrix_x4(a, kbase + (d >> 6) * BOX_BYTES + swz(row, 2 * (d & 63)));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(sc[nt], a, qb[nt][ks][0], qb[nt][ks][1]);
          }
        } else {
          uint4 kr[2][2];  // rows gid, gid + 8: bytes 32 tig .. 32 tig + 31
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              kr[rr][hh] = *reinterpret_cast<const uint4*>(slot + swz(r0 + gid + 8 * rr, 32 * tig + 16 * hh));
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const uint32_t w0 = word(kr[0][ks >> 2], ks & 3), w1 = word(kr[1][ks >> 2], ks & 3);
            const uint32_t a[4] = {i8_pair(w0, w0 >> 8, 0), i8_pair(w1, w1 >> 8, 0), i8_pair(w0, w0 >> 8, 2),
                                   i8_pair(w1, w1 >> 8, 2)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(sc[nt], a, qb[nt][ks][0], qb[nt][ks][1]);
          }
        }

        // ---- online softmax of the warp's 16 tokens, the warp's own running max ----
        float f0 = scale, f1 = scale, g0 = 1.f, g1 = 1.f;  // score factors, v scales
        if (MODE == MODE_INT8) {
          const __nv_bfloat16* kss = reinterpret_cast<const __nv_bfloat16*>(slot + 2 * BOX_BYTES);
          const __nv_bfloat16* vss = kss + TILE;
          const int j0 = r0 + gid, j1 = j0 + 8;
          f0 = v0 ? __bfloat162float(bulk_scales ? kss[j0] : ksg[tok0]) * scale : 0.f;
          f1 = v1 ? __bfloat162float(bulk_scales ? kss[j1] : ksg[tok0 + 8]) * scale : 0.f;
          g0 = v0 ? __bfloat162float(bulk_scales ? vss[j0] : vsg[tok0]) : 0.f;
          g1 = v1 ? __bfloat162float(bulk_scales ? vss[j1] : vsg[tok0 + 8]) : 0.f;
        }
        uint32_t pb[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float p0[2], p1[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s0 = v0 ? sc[nt][e] * f0 : NEG_INF;
            const float s1 = v1 ? sc[nt][2 + e] * f1 : NEG_INF;
            const float m_new = fmaxf(m_run[nt][e], gid_max(fmaxf(s0, s1)));
            const float corr = __expf(m_run[nt][e] - m_new);
            p0[e] = v0 ? __expf(s0 - m_new) : 0.f;
            p1[e] = v1 ? __expf(s1 - m_new) : 0.f;
            l_run[nt][e] = l_run[nt][e] * corr + (p0[e] + p1[e]);  // this lane's tokens; lanes summed at the end
            m_run[nt][e] = m_new;
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[nt][x][e] *= corr, acc[nt][x][2 + e] *= corr;
            p0[e] *= g0, p1[e] *= g1;  // mode 1: the v scales ride on the weights
          }
          // the p . v product takes bf16 weights, as the TPU kernel does; (token, head) -> (head, token)
          pb[nt][0] = movmatrix_trans(pack_bf16(p0[0], p0[1]));
          pb[nt][1] = movmatrix_trans(pack_bf16(p1[0], p1[1]));
        }

        // ---- O^T += V^T . P^T: 8 M tiles of 16 columns, K = the warp's 16 tokens ----
        if (MODE == MODE_BF16) {
          const int row = r0 + (lane & 7) + 8 * (lane >> 4);
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int d = 16 * x + 8 * ((lane >> 3) & 1);
            uint32_t a[4];
            ldmatrix_x4_trans(a, vbase + (d >> 6) * BOX_BYTES + swz(row, 2 * (d & 63)));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][x], a, pb[nt][0], pb[nt][1]);
          }
        } else {
          // rows r0 + 2 tig, + 1, + 8, + 9 (the k of this thread's B values), bytes 16 gid .. 16 gid + 15
          const unsigned char* vslot = slot + BOX_BYTES;
          uint4 vr[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            vr[j] = *reinterpret_cast<const uint4*>(vslot + swz(r0 + 2 * tig + (j & 1) + 8 * (j >> 1), 16 * gid));
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            // M row gid: column 16 gid + 2 x, row gid + 8: 16 gid + 2 x + 1 (bytes 2 x, 2 x + 1 of a chunk)
            const int wi = x >> 1, sh = 2 * (x & 1);
            const uint32_t a[4] = {i8_pair(word(vr[0], wi), word(vr[1], wi), sh),
                                   i8_pair(word(vr[0], wi), word(vr[1], wi), sh + 1),
                                   i8_pair(word(vr[2], wi), word(vr[3], wi), sh),
                                   i8_pair(word(vr[2], wi), word(vr[3], wi), sh + 1)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][x], a, pb[nt][0], pb[nt][1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
  }

  // ---- the CTA's (m, l, acc): the consumer warps' partials combined in warp order ----
  __syncthreads();  // every tile consumed: the ring takes the partials
  float* part = reinterpret_cast<float*>(smem);  // [warp][head][PART_STRIDE], then the CTA's [head][PART_STRIDE]
  float* fin = part + CONSUMERS * G16 * PART_STRIDE;
  if (warp < CONSUMERS) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = gid_sum(l_run[nt][e]);
        const int head = nt * 8 + 2 * tig + e;
        if (gid == 0) red_m[warp * G16 + head] = m_run[nt][e], red_l[warp * G16 + head] = l;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          float* row = part + (warp * G16 + head) * PART_STRIDE;
          row[out_col<MODE>(x, 0, gid)] = acc[nt][x][e];
          row[out_col<MODE>(x, 2, gid)] = acc[nt][x][2 + e];
        }
      }
  }
  __syncthreads();
  if (threadIdx.x < G16) {
    const int head = threadIdx.x;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) M = fmaxf(M, red_m[w * G16 + head]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) {
      const float wt = expf(red_m[w * G16 + head] - M);
      red_w[w * G16 + head] = wt;
      l += red_l[w * G16 + head] * wt;
    }
    fin_m[head] = M;
    fin_l[head] = l;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G16 * QD; e += blockDim.x) {
    const int head = e / QD, d = e % QD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) sum += part[(w * G16 + head) * PART_STRIDE + d] * red_w[w * G16 + head];
    fin[head * PART_STRIDE + d] = sum;
  }

  // ---- the cluster: this rank writes heads rank, rank + n, ... from every rank's (m, l, acc) ----
  if (n_split > 1)
    cluster_sync();
  else
    __syncthreads();
  const int my_heads = G > rank ? (G - rank + n_split - 1) / n_split : 0;
  constexpr int WS = SPLIT_MAX_CLUSTER + 1;
  if (threadIdx.x < my_heads) {
    const int g = rank + threadIdx.x * n_split;
    float mr[SPLIT_MAX_CLUSTER], lr[SPLIT_MAX_CLUSTER];
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r)
      if (r < n_split) {
        mr[r] = *rank_ptr(fin_m + g, r, n_split);
        lr[r] = *rank_ptr(fin_l + g, r, n_split);
        M = fmaxf(M, mr[r]);
      }
    float l_sum = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r)
      if (r < n_split) {
        mr[r] = expf(mr[r] - M);
        l_sum += lr[r] * mr[r];
        wts[threadIdx.x * WS + r] = mr[r];
      }
    wts[threadIdx.x * WS + SPLIT_MAX_CLUSTER] = l_sum == 0.f ? 1.f : l_sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < my_heads * QD; e += blockDim.x) {
    const int j = e / QD, d = e % QD, g = rank + j * n_split;
    float o_sum = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r)
      if (r < n_split) o_sum += *rank_ptr(fin + g * PART_STRIDE + d, r, n_split) * wts[j * WS + r];
    o[((size_t)b * Hq + (size_t)h * G + g) * QD + d] = __float2bfloat16(o_sum / wts[j * WS + SPLIT_MAX_CLUSTER]);
  }
  if (n_split > 1) cluster_sync();  // no CTA leaves while another still reads its shared memory
}

// The stacked cache as (D, S, L * B * Hkv) of `esize`-byte values, read in boxes of 128 bytes of d x
// TILE tokens x 1 stripe with the 128-byte swizzle; tokens past S read as zeros.
bool encode_cache_map(CUtensorMap* map, const void* ptr, int esize, int S, int stripes) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(QD), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(stripes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(QD) * esize, static_cast<cuuint64_t>(S) * QD * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / esize), static_cast<cuuint32_t>(TILE), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Bytes of dynamic shared memory of a split plan; -1 for a plan the kernel cannot run.
int split_smem(int mode, int G, int n_split, int stages) {
  if ((mode != MODE_BF16 && mode != MODE_INT8) || G < 1 || G > GMAX || n_split < 1 ||
      n_split > SPLIT_MAX_CLUSTER || stages < 1 || stages > SPLIT_MAX_STAGES)
    return -1;
  return split_layout(mode, G <= 8 ? 1 : 2, stages).total;
}

template <int MODE, int NT>
int launch_split(const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q, const void* ks,
                 const void* vs, const void* kv_seg, void* o, int B, int Hq, int Hkv, int S, int stripe0,
                 float scale, int n_split, int stages, int smem, cudaStream_t stream) {
  auto kernel = decode_split_kernel<MODE, NT>;
  int device = 0;
  cudaGetDevice(&device);
  static bool configured[64] = {};  // per device: the opt-in to large dynamic shared memory
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_split, B, Hkv);
  config.blockDim = dim3(SPLIT_THREADS, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  if (n_split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
  return static_cast<int>(cudaLaunchKernelEx(
      &config, kernel, kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(kv_seg), static_cast<__nv_bfloat16*>(o), S,
      Hq, Hkv, stripe0, scale, stages));
}

// ---------------------------------------------------------------------------
// int4 caches (modes 2 and 3), head dim 128.
//
// The cache is walked in BLOCKS of `block_rows` packed byte rows
// [r0, r0 + block_rows) = tokens [r0, ..) in the low nibbles and tokens
// [S/2 + r0, ..) in the high nibbles, so kv_seg and the scales are read at
// both halves. The block matters to the RESULT only in mode 3, whose softmax
// weights are rounded to int8 against the largest weight of their block: the
// caller passes the block the TPU kernel tiles with, and the plain PyTorch
// version quantizes over the same blocks.
//
// Arithmetic per block, as the TPU kernels:
//   mode 2: scores = (q . u - 8 * sum(q)) * (k_scale * scale) on the unsigned
//     nibbles u = value + 8; weights * v_scale rounded to bf16 for the p . u
//     dot, debiased by -8 * sum(p) with the UNROUNDED fp32 weights.
//   mode 3: q quantized once per (row, head) to int8; scores = (int8 dot of q
//     with u - 8 * sum(q)) * qscale * (k_scale * scale); weights * v_scale
//     quantized to int8 per head per block; p . u is an int8 dot debiased by
//     -8 * sum(p) and restored by pscale. The int32 sums are exact.
//
// One CTA per (row, kv head), all G query heads sharing every byte read. Each
// block goes through three phases that keep the block's scores in shared
// memory (mode 3 needs the block's largest weight before its p . v dot):
// A) stage K in 64-row tiles with 16-byte loads and form scores (fp32 FMAs,
// or `__dp4a` on packed nibbles in mode 3), B) one warp per head does the
// online-softmax update, C) stage V tiles and accumulate one output column
// per thread. A block with no valid cell (the unwritten decode tail) is
// skipped before its bytes are read.
// What it does not do yet: tensor-core dots, cp.async / TMA double buffering,
// a split of S across CTAs.

constexpr int THREADS = 128;  // 4 warps
constexpr int KV4_BIAS = 8;
constexpr int TILE_STRIDE = QD + 16;  // bytes per staged row (padded against bank conflicts)

// Shared-memory plan, computed alike on host and device.
struct QLayout {
  int pg;        // padded score slots per block (two padded halves)
  int half_pad;  // padded byte rows per block
  int off_s, off_ksc, off_vsc, off_valid, off_p8, off_q, off_small, total;
};

__host__ __device__ inline QLayout make_qlayout(int mode, int G, int block_rows) {
  QLayout L;
  L.half_pad = round_up(block_rows, 4);
  L.pg = 2 * L.half_pad;
  int off = TILE * TILE_STRIDE;
  L.off_s = off;      off += G * L.pg * 4;
  L.off_ksc = off;    off += L.pg * 4;
  L.off_vsc = off;    off += L.pg * 4;
  L.off_valid = off;  off += round_up(L.pg, 16);
  L.off_p8 = off;     off += mode == MODE_INT4_I8 ? round_up(G * L.pg, 16) : 0;
  L.off_q = off;      off += mode == MODE_INT4_I8 ? GMAX * QD : GMAX * QD * 4;
  L.off_small = off;  off += 8 * GMAX * 4;
  L.total = off;
  return L;
}

// Stage `n_rows` (<= TILE) rows of QD bytes into the padded tile; rows beyond
// n_rows are zero-filled.
__device__ __forceinline__ void load_tile(const unsigned char* __restrict__ src, int n_rows,
                                          unsigned char* tile) {
  constexpr int chunks = QD / 16;
  for (int i = threadIdx.x; i < TILE * chunks; i += THREADS) {
    const int r = i / chunks;
    const int c = (i % chunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)r * QD + c);
    *reinterpret_cast<uint4*>(tile + r * TILE_STRIDE + c) = val;
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
decode_quant_kernel(const __nv_bfloat16* __restrict__ q,
                    const unsigned char* __restrict__ kc,  // layer base
                    const unsigned char* __restrict__ vc,
                    const __nv_bfloat16* __restrict__ k_scale,  // layer base
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ kv_seg, __nv_bfloat16* __restrict__ o,
                    int S, int Hq, int Hkv, int block_rows, float scale) {
  static_assert(MODE == MODE_INT4 || MODE == MODE_INT4_I8, "modes 0 and 1 run decode_split_kernel");
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = Hq / Hkv;
  const QLayout L = make_qlayout(MODE, G, block_rows);
  unsigned char* tile = smem;
  float* s_sh = reinterpret_cast<float*>(smem + L.off_s);
  float* ksc = reinterpret_cast<float*>(smem + L.off_ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.off_vsc);
  unsigned char* valid_sh = smem + L.off_valid;
  signed char* p8 = reinterpret_cast<signed char*>(smem + L.off_p8);
  float* qs = reinterpret_cast<float*>(smem + L.off_q);              // mode 2
  signed char* q8 = reinterpret_cast<signed char*>(smem + L.off_q);  // mode 3
  float* small = reinterpret_cast<float*>(smem + L.off_small);
  float* m_sh = small;
  float* l_sh = small + GMAX;
  float* corr_sh = small + 2 * GMAX;
  float* qscale_sh = small + 3 * GMAX;
  float* sumq_sh = small + 4 * GMAX;
  float* pscale_sh = small + 5 * GMAX;
  float* sump_sh = small + 6 * GMAX;

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int PG = L.pg;
  const int half_pad = L.half_pad;
  const int rows_total = S / 2;  // stored rows of the stripe
  const size_t stripe = (size_t)b * Hkv + h;
  const unsigned char* kb = kc + stripe * (size_t)rows_total * QD;
  const unsigned char* vb = vc + stripe * (size_t)rows_total * QD;
  const __nv_bfloat16* ksb = k_scale + stripe * (size_t)S;
  const __nv_bfloat16* vsb = v_scale + stripe * (size_t)S;
  const int* segb = kv_seg + (size_t)b * S;

  const __nv_bfloat16* qg = q + ((size_t)b * Hq + (size_t)h * G) * QD;
  if (tid < GMAX) {
    m_sh[tid] = NEG_INF;
    l_sh[tid] = 0.f;
  }
  if (MODE == MODE_INT4_I8) {
    // q -> int8 once, one scale per (row, head)
    for (int g = warp; g < G; g += THREADS / 32) {
      float qf[QD / 32];
      float qa = 0.f;
#pragma unroll
      for (int j = 0; j < QD / 32; ++j) {
        qf[j] = __bfloat162float(qg[(size_t)g * QD + lane + 32 * j]);
        qa = fmaxf(qa, fabsf(qf[j]));
      }
      qa = warp_max(qa);
      const float qscale = fmaxf(qa, 1e-8f) * (1.0f / 127.0f);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < QD / 32; ++j) {
        const float r = rintf(qf[j] / qscale);
        q8[g * QD + lane + 32 * j] = static_cast<signed char>(static_cast<int>(r));
        sq += r;
      }
      sq = warp_sum(sq);
      if (lane == 0) {
        qscale_sh[g] = qscale;
        sumq_sh[g] = sq;
      }
    }
  } else {
    for (int i = tid; i < G * QD; i += THREADS) qs[i] = __bfloat162float(qg[i]);
    // sum(q) per head, for the -8 debias of the scores
    for (int g = warp; g < G; g += THREADS / 32) {
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < QD / 32; ++j) sq += __bfloat162float(qg[(size_t)g * QD + lane + 32 * j]);
      sq = warp_sum(sq);
      if (lane == 0) sumq_sh[g] = sq;
    }
  }

  float acc[GMAX];  // column d = tid of every head's output
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;

  const int tok = tid % TILE;   // phase A: one staged row per thread ...
  const int part = tid / TILE;  // ... and its nibble half

  for (int r0 = 0; r0 < rows_total; r0 += block_rows) {
    const int rows = min(block_rows, rows_total - r0);  // stored rows of this block
    __syncthreads();  // previous block fully consumed (and q / state initialised)
    // score slot j -> token: slot j < half_pad = token r0 + j, slot half_pad + j
    // = token S/2 + r0 + j
    int any = 0;
    for (int j = tid; j < PG; j += THREADS) {
      int t = -1;
      const int hf = j >= half_pad;
      const int r = j - hf * half_pad;
      if (r < rows) t = hf * rows_total + r0 + r;
      const bool ok = t >= 0 && segb[t] != 0;
      valid_sh[j] = ok;
      ksc[j] = ok ? __bfloat162float(ksb[t]) * scale : 0.f;
      vsc[j] = ok ? __bfloat162float(vsb[t]) : 0.f;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;  // nothing valid: the state is unchanged

    // ---- phase A: scores of the whole block into s_sh ----
    for (int t0 = 0; t0 < rows; t0 += TILE) {
      __syncthreads();  // tile free
      load_tile(kb + (size_t)(r0 + t0) * QD, min(TILE, rows - t0), tile);
      __syncthreads();
      const unsigned char* krow = tile + tok * TILE_STRIDE;
      const int r = t0 + tok;
      if (MODE == MODE_INT4_I8) {
        int iacc[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) iacc[g] = 0;
        const int* q8w = reinterpret_cast<const int*>(q8);
#pragma unroll
        for (int c = 0; c < QD; c += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
          const unsigned int w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int nib = static_cast<int>((part ? (w4[e] >> 4) : w4[e]) & 0x0F0F0F0Fu);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
              if (g < G) iacc[g] = __dp4a(nib, q8w[g * (QD / 4) + c / 4 + e], iacc[g]);
          }
        }
        if (r < rows) {
          const int j = part * half_pad + r;
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
              const float sv = (static_cast<float>(iacc[g]) - KV4_BIAS * sumq_sh[g]) * qscale_sh[g];
              s_sh[g * PG + j] = sv * ksc[j];
            }
          }
        }
      } else {
        float sc[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) sc[g] = 0.f;
#pragma unroll 2
        for (int c = 0; c < QD; c += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
          const unsigned char* b16 = reinterpret_cast<const unsigned char*>(&raw);
          float kf[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) kf[e] = static_cast<float>((b16[e] >> (4 * part)) & 15);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
#pragma unroll
              for (int e = 0; e < 16; ++e) sc[g] = fmaf(qs[g * QD + c + e], kf[e], sc[g]);
            }
          }
        }
        if (r < rows) {
          const int j = part * half_pad + r;
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) s_sh[g * PG + j] = (sc[g] - KV4_BIAS * sumq_sh[g]) * ksc[j];
        }
      }
    }
    __syncthreads();

    // ---- phase B: online softmax of the block, one warp per head ----
    for (int g = warp; g < G; g += THREADS / 32) {
      float* srow = s_sh + g * PG;
      const float m_prev = m_sh[g];
      float mx = NEG_INF;
      for (int j = lane; j < PG; j += 32)
        if (valid_sh[j]) mx = fmaxf(mx, srow[j]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f, pmax = 0.f, pvsum = 0.f;
      for (int j = lane; j < PG; j += 32) {
        float p = 0.f;
        if (valid_sh[j]) {
          p = expf(srow[j] - m_new);
          psum += p;
          p *= vsc[j];
          pvsum += p;  // mode 2 debiases with the unrounded weights
          // mode 2: the p . v dot takes bf16 weights, as the TPU kernel does
          if (MODE != MODE_INT4_I8) p = __bfloat162float(__float2bfloat16(p));
        }
        srow[j] = p;
        pmax = fmaxf(pmax, p);
      }
      const float corr = expf(m_prev - m_new);
      psum = warp_sum(psum);
      if (MODE == MODE_INT4_I8) {
        // weights -> int8, one scale per head per block
        const float pscale = fmaxf(warp_max(pmax), 1e-20f) * (1.0f / 127.0f);
        float sp = 0.f;
        for (int j = lane; j < PG; j += 32) {
          const float r = rintf(srow[j] / pscale);
          p8[g * PG + j] = static_cast<signed char>(static_cast<int>(r));
          sp += r;
        }
        sp = warp_sum(sp);
        if (lane == 0) {
          pscale_sh[g] = pscale;
          sump_sh[g] = sp;
        }
      }
      if (MODE == MODE_INT4) {
        pvsum = warp_sum(pvsum);
        if (lane == 0) sump_sh[g] = pvsum;
      }
      if (lane == 0) {
        l_sh[g] = l_sh[g] * corr + psum;
        m_sh[g] = m_new;
        corr_sh[g] = corr;
      }
    }
    __syncthreads();

    // ---- phase C: p . v, one output column per thread ----
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) acc[g] *= corr_sh[g];
    if (MODE == MODE_INT4_I8) {
      int iacc[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) iacc[g] = 0;
      const int* p8w = reinterpret_cast<const int*>(p8);
      for (int t0 = 0; t0 < rows; t0 += TILE) {
        __syncthreads();
        load_tile(vb + (size_t)(r0 + t0) * QD, min(TILE, rows - t0), tile);
        __syncthreads();
        const int n4 = min(TILE, round_up(rows - t0, 4));
        for (int t = 0; t < n4; t += 4) {
          const unsigned int w = static_cast<unsigned int>(tile[(t + 0) * TILE_STRIDE + tid]) |
                                 static_cast<unsigned int>(tile[(t + 1) * TILE_STRIDE + tid]) << 8 |
                                 static_cast<unsigned int>(tile[(t + 2) * TILE_STRIDE + tid]) << 16 |
                                 static_cast<unsigned int>(tile[(t + 3) * TILE_STRIDE + tid]) << 24;
          const int lo = static_cast<int>(w & 0x0F0F0F0Fu);
          const int hi = static_cast<int>((w >> 4) & 0x0F0F0F0Fu);
          const int wl = (t0 + t) / 4;             // low-half slots t0+t .. +3
          const int wh = (half_pad + t0 + t) / 4;  // their high-half partners
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
              iacc[g] = __dp4a(lo, p8w[g * (PG / 4) + wl], iacc[g]);
              iacc[g] = __dp4a(hi, p8w[g * (PG / 4) + wh], iacc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G)
          acc[g] += (static_cast<float>(iacc[g]) - KV4_BIAS * sump_sh[g]) * pscale_sh[g];
    } else {
      for (int t0 = 0; t0 < rows; t0 += TILE) {
        __syncthreads();
        load_tile(vb + (size_t)(r0 + t0) * QD, min(TILE, rows - t0), tile);
        __syncthreads();
        const int nt = min(TILE, rows - t0);
        for (int t = 0; t < nt; ++t) {
          const unsigned int byte = tile[t * TILE_STRIDE + tid];
          const float lo = static_cast<float>(byte & 15u);
          const float hi = static_cast<float>(byte >> 4);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
              acc[g] = fmaf(s_sh[g * PG + t0 + t], lo, acc[g]);
              acc[g] = fmaf(s_sh[g * PG + half_pad + t0 + t], hi, acc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] -= KV4_BIAS * sump_sh[g];
    }
  }

  __syncthreads();
  __nv_bfloat16* og = o + ((size_t)b * Hq + (size_t)h * G) * QD;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const float l = l_sh[g];
      og[(size_t)g * QD + tid] = __float2bfloat16(acc[g] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int MODE>
int launch_quant(const void* q, const unsigned char* kc, const unsigned char* vc, const void* ks,
                 const void* vs, const void* kv_seg, void* o, int B, int Hq, int Hkv, int S,
                 int block_rows, float scale, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(decode_quant_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_quant_kernel<MODE><<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kc, vc, static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(kv_seg),
      static_cast<__nv_bfloat16*>(o), S, Hq, Hkv, block_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory (bytes) one CTA of the int4 modes (2, 3) needs; the
// wrapper refuses shapes beyond the card's opt-in limit before launching.
extern "C" int st_decode_attention_smem(int mode, int G, int block_rows) {
  return make_qlayout(mode, G, block_rows).total;
}

// Int4 caches (modes 2 and 3). `S` is the cache width in tokens; `block_rows`
// is the number of packed rows per block. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int st_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                   const void* k_scale, const void* v_scale,
                                   const void* kv_seg, void* o, int B, int Hq, int Hkv,
                                   int S, int D, int layer, int mode, int block_rows,
                                   float scale, void* stream) {
  if (Hq % Hkv != 0 || Hq / Hkv > GMAX || (mode != MODE_INT4 && mode != MODE_INT4_I8) || D != QD ||
      block_rows < 1 || S % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = make_qlayout(mode, Hq / Hkv, block_rows).total;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const size_t layer_bytes = (size_t)B * Hkv * (size_t)(S / 2) * QD;
  const size_t layer_cells = (size_t)B * Hkv * (size_t)S;
  const unsigned char* kc = static_cast<const unsigned char*>(k_cache) + layer * layer_bytes;
  const unsigned char* vc = static_cast<const unsigned char*>(v_cache) + layer * layer_bytes;
  const __nv_bfloat16* ks = static_cast<const __nv_bfloat16*>(k_scale) + layer * layer_cells;
  const __nv_bfloat16* vs = static_cast<const __nv_bfloat16*>(v_scale) + layer * layer_cells;
  if (mode == MODE_INT4)
    return launch_quant<MODE_INT4>(q, kc, vc, ks, vs, kv_seg, o, B, Hq, Hkv, S, block_rows, scale, smem, s);
  return launch_quant<MODE_INT4_I8>(q, kc, vc, ks, vs, kv_seg, o, B, Hq, Hkv, S, block_rows, scale, smem, s);
}

// Dynamic shared memory (bytes) of the split kernel (modes 0, 1) under a plan
// (cluster size, ring slots); -1 for a plan it cannot run.
extern "C" int st_decode_split_smem(int mode, int G, int n_split, int stages) {
  return split_smem(mode, G, n_split, stages);
}

// bf16 (mode 0) and int8 (mode 1) caches of L layers, under the plan
// (n_split ranks, `stages` ring slots) from ops/decode_attention.py
// `decode_plan`; refuses (cudaErrorInvalidValue, before anything launches) a
// plan or a shape it cannot run. Scales (mode 1) are the (L, B, Hkv, S) stacks.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int st_decode_split(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                               const void* v_scale, const void* kv_seg, void* o, int L, int B, int Hq, int Hkv,
                               int S, int layer, int mode, int n_split, int stages, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || B < 1 || B > 65535 || Hkv > 65535 || S < 1 || L < 1 || layer < 0 ||
      layer >= L || static_cast<long long>(L) * B * Hkv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const int smem = split_smem(mode, G, n_split, stages);
  if (smem < 0 || smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = mode == MODE_BF16 ? 2 : 1;
  CUtensorMap kmap, vmap;
  if (!encode_cache_map(&kmap, k_cache, esize, S, L * B * Hkv) ||
      !encode_cache_map(&vmap, v_cache, esize, S, L * B * Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t layer_cells = (size_t)B * Hkv * (size_t)S;
  const __nv_bfloat16* ks = nullptr;
  const __nv_bfloat16* vs = nullptr;
  if (mode == MODE_INT8) {
    ks = static_cast<const __nv_bfloat16*>(k_scale) + layer * layer_cells;
    vs = static_cast<const __nv_bfloat16*>(v_scale) + layer * layer_cells;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stripe0 = layer * B * Hkv;
  if (mode == MODE_BF16)
    return G <= 8 ? launch_split<MODE_BF16, 1>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, scale,
                                                n_split, stages, smem, s)
                  : launch_split<MODE_BF16, 2>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, scale,
                                                n_split, stages, smem, s);
  return G <= 8 ? launch_split<MODE_INT8, 1>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, scale,
                                              n_split, stages, smem, s)
                : launch_split<MODE_INT8, 2>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, scale,
                                              n_split, stages, smem, s);
}
