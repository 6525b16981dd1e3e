// Decode attention for Hopper (sm_90a): one new query token per sequence
// against one layer of the stacked dense KV cache.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/decode_attention.py
// (launched by `_pallas_decode`):
//   `_decode_kernel`          bf16 cache (mode 0) and int8 cache with per-cell
//                             scales (mode 1): `decode_split_kernel` below;
//   `_decode_kernel_int4`     int4 cache, dots on the unsigned nibbles widened
//                             to bf16 (mode 2): `decode_int4_kernel`;
//   `_decode_kernel_int4_i8`  int4 cache, both dots on int8 operands (mode 3):
//                             `decode_int4_kernel`.
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
// scales, 2 * (D / 2 + 2) for int4) and does ~4 * G * D operations per cell,
// far under the card's operations-per-byte balance. What keeps a kernel from
// the byte bound is latency: too few CTAs for the SMs, loads waited on in
// series.
//
// One design for every mode. One plan per call (ops/decode_attention.py
// `decode_plan`): the tiles of a (row, kv head) stripe are split over a
// thread-block cluster of up to 8 CTAs (ranks) where the (row, kv head) pairs
// leave CTA slots idle (a CTA walks its tiles in series behind a fixed cost of
// several µs, and the CTAs an SM's shared memory holds at once -- two in
// bf16, three in int8 and int4 -- overlap). A producer warp reads the row's
// kv_seg ahead of the loads and skips a tile with no valid cell before any of
// its bytes are read (exact: such a tile adds nothing); a live tile's K and V
// arrive by TMA (3-D tensor maps over the stacked cache, 128-byte swizzle, so
// the fragment loads below meet no bank conflict; rows past the width read as
// zeros) with its scales by bulk copies, into a ring of `stages` slots with a
// full and an empty mbarrier a slot. Its validity mask rides in the slot's
// header. Four consumer warps take 16 rows of a tile each, both products on
// `mma.sync` (the per-warp `mma.sync` keeps each warp's softmax its own with
// no CTA barrier a tile; `wgmma`'s 64-row tiles would tie four warps to one
// softmax, and its B operand from shared memory would need the values
// converted there). The warps meet in warp order at the end, then the ranks
// in distributed shared memory in rank order, so two calls are bit-identical
// (`split_combine`). A row with no valid cell gives exact zeros.
//
// ---- modes 0 and 1: `decode_split_kernel` ----
// A tile is 64 tokens; rank r takes tiles r, r + n, ... . Both products on
// `mma.sync.m16n8k16` bf16:
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
// max.
//
// ---- modes 2 and 3: `decode_int4_kernel` ----
// A tile is 64 packed byte rows = 128 tokens: the low nibbles of rows
// 64 t .. 64 t + 63 and, S/2 further on, the high nibbles of the same bytes.
// It arrives as one 64-row x 128-byte box a cache (D = 128 values pack into
// 128 bytes: mode 1's box), with four 64-cell scale runs (k and v, low and high
// half) by bulk copies, and the producer reads kv_seg at both halves: four
// ballots, a 128-bit mask. The rank's unit is the BLOCK of `block_rows` byte
// rows (`int4_block_rows`: 128 or 256, or the whole width where its row count
// is no multiple of 128): rank r takes blocks r, r + n, ... whole, since mode
// 3 rounds its weights per block. Consumer warp w takes byte rows
// 16 w .. 16 w + 15 of a tile, i.e. 32 tokens; each product runs once on the
// low and once on the high nibbles.
//   Mode 2: the nibbles u are widened to bf16 in registers (exact: the bf16
//     bits 0x4300 | u are 128 + u, minus 128); S^T = K_u . q^T and
//     O^T += U^T . P^T on m16n8k16 bf16 as in mode 1; scores
//     (q . u - 8 sum(q)) * (k_scale * scale); p * v_scale rounded to bf16 for
//     p . u, which is debiased by -8 sum(p * v_scale) of the UNROUNDED fp32
//     weights. Each warp keeps its own running max.
//   Mode 3: q is quantized to int8 in the CTA's prologue with the plain
//     version's arithmetic to the bit (max(|q|, 1e-8) * fp32(1/127), an IEEE
//     quotient, round half to even); S^T = u . q8^T on `mma.sync` m16n8k32 s8
//     (u in [0, 15] is a valid s8 operand, the int32 sums are exact), debiased
//     by -8 sum(q8) and restored by qscale, times k_scale * scale -- the plain
//     version's scores to the bit. Its weights are quantized per head per
//     block against the block's largest p * v_scale, so a block's weights wait
//     for all of its scores: the block's live tiles (at most 4: a block of more
//     than 256 rows is refused) stay in the ring and their scores in
//     registers (8 values a thread and tile at G <= 8, 16 at G <= 16). The
//     consumer warps meet once a block on a named barrier, over each warp's
//     largest score and its largest exp(s - its max) * v_scale in shared
//     memory: from those every warp derives the block's common running max
//     and pscale = max(p * v_scale) / 127, so the warps share one running max.
//     Then p8 = round(p * v_scale / pscale) (p = exp(s - m), the fp32
//     quotient) goes through the warp's records in shared memory to the B
//     layout of O^T += U^T . P8^T on m16n8k32 s8, debiased by -8 sum(p8) and
//     restored by pscale, and each tile's slot is released after its product.
//     Where exp and the block max meet a rounding tie, an int8 weight may move
//     by one step (the card tests' tolerance).

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
// modes 2 and 3
constexpr int KV4_BIAS = 8;
constexpr int BLOCK_TILES = 4;                  // the producer's group of tiles; mode 3's largest block (256 rows)
constexpr int INT4_MAX_STAGES = 8;              // mode 3 holds a block's tiles in the ring until its p . v
constexpr unsigned int NIB = 0x0F0F0F0Fu;
constexpr int Q8_STRIDE = QD + 16;              // bytes of a q8 row in shared memory (padded: the heads' B
                                                // fragments fall in different banks)

// Shared memory of the split kernel, computed alike on host and device. The
// ring's slots (K boxes, V boxes, the tile's k and v scales) start 1024-byte
// aligned; after the last tile they hold the warps' partial outputs and the
// CTA's sum of them.
struct SplitLayout {
  int slot;      // bytes of a ring slot
  int off_hdr;   // per slot: the tile, its validity mask (two words; int4: the live tiles of its group)
  int off_red;   // per warp and head: m, l, combine weight; per head: the CTA's m, l; the ranks' weights
  int off_int4;  // int4: per slot the four mask words; q8, qscale, 8 sum(q); the block maxima; p8 records
  int off_bar;   // full[stages], empty[stages]
  int total;     // with 1 KB of slack to align the ring
};

// Bytes of the int4 modes' own region (`off_int4`): per slot the 128-bit validity mask, mode 3's q8
// [head][Q8_STRIDE], per head qscale and 8 sum(q), the block maxima [parity][warp][head][2] and the
// warps' p8 records [warp][head][32].
__host__ __device__ inline int int4_region(int g16, int stages) {
  return stages * 16 + g16 * Q8_STRIDE + 2 * g16 * 4 + 2 * CONSUMERS * g16 * 2 * 4 + CONSUMERS * g16 * 32;
}

__host__ __device__ inline SplitLayout split_layout(int mode, int nt, int stages) {
  SplitLayout L;
  const int g16 = 8 * nt;
  const bool int4 = mode == MODE_INT4 || mode == MODE_INT4_I8;
  // an int4 slot: the K and V boxes (64 byte rows, 128 tokens) and four 64-cell scale runs
  L.slot = int4 ? round_up(2 * BOX_BYTES + 4 * TILE * 2, 1024)
                : round_up((mode == MODE_BF16 ? 4 : 2) * BOX_BYTES + 2 * TILE * 2, 1024);
  const int ring = stages * L.slot;
  const int part = (CONSUMERS + 1) * g16 * PART_STRIDE * 4;
  int off = ring > part ? ring : part;
  L.off_hdr = off;  off += stages * 16;
  L.off_red = off;  off += (3 * CONSUMERS + 2 + SPLIT_MAX_CLUSTER + 1) * g16 * 4;
  L.off_int4 = off; off += int4 ? int4_region(g16, stages) : 0;
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
// byte offset of (row, byte column c) in a 64-row box written with the 128-byte swizzle: the
// 16-byte chunk c / 16 of row r sits at chunk (c / 16) ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int row, int c) {
  return row * 128 + ((((c >> 4) ^ row) & 7) << 4) + (c & 15);
}

// Output column of fragment value c (0-3) of M tile x, lane (gid, tig): mode 0 takes d = 16 x + gid
// (+ 8) as `ldmatrix.trans` delivers V^T; modes 1-3 d = 16 gid + 2 x (+ 1), the columns its thread
// loaded as one 16-byte chunk of V.
template <int MODE>
__device__ __forceinline__ int out_col(int x, int c, int gid) {
  return MODE == MODE_BF16 ? 16 * x + gid + 8 * (c >> 1) : 16 * gid + 2 * x + (c >> 1);
}

// The end of every mode: the consumer warps' (m, l, acc) combined in warp order into the CTA's, then
// the ranks' in rank order in distributed shared memory; this rank writes heads rank, rank + n, ... .
// acc holds the output columns out_col<MODE>(x, c, gid) of heads nt * 8 + 2 tig + (c & 1).
template <int MODE, int NT>
__device__ __forceinline__ void split_combine(unsigned char* smem, const SplitLayout& L, const float (&m_run)[NT][2],
                                              const float (&l_run)[NT][2], const float (&acc)[NT][8][4],
                                              __nv_bfloat16* __restrict__ o, int b, int h, int Hq, int G) {
  constexpr int G16 = 8 * NT;
  const int n_split = gridDim.x, rank = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float* red_m = reinterpret_cast<float*>(smem + L.off_red);    // [warp][head]
  float* red_l = red_m + CONSUMERS * G16;
  float* red_w = red_l + CONSUMERS * G16;
  float* fin_m = red_w + CONSUMERS * G16;                        // [head]
  float* fin_l = fin_m + G16;
  float* wts = fin_l + G16;                                      // [my head][rank], then its l

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

// NT: N tiles of 8 heads (1: G <= 8, 2: G <= 16). Grid (n, B, Hkv): the n CTAs of a (row, kv head)
// form a cluster. Warps 0-3 consume (warp w: rows 16 w .. 16 w + 15 of every tile), warp 4 produces.
// Fragments (gid = lane / 4, tig = lane % 4): scores of rows gid, gid + 8 of the warp's 16 and heads
// nt * 8 + 2 tig (+ 1); outputs of columns out_col(x, c, gid), the same heads.
template <int MODE, int NT>
__global__ void __launch_bounds__(SPLIT_THREADS)
decode_split_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ kv_seg,
                    __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv, int stripe0, int /*block_rows*/,
                    float scale, int stages) {
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

  split_combine<MODE, NT>(smem, L, m_run, l_run, acc, o, b, h, Hq, G);
}

// ---------------------------------------------------------------------------
// Modes 2 and 3: the int4 kernel (see the top of the file).

// the consumer warps alone (the producer never waits here)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(32 * CONSUMERS) : "memory"); }

// NT: N tiles of 8 heads (1: G <= 8, 2: G <= 16). Grid (n, B, Hkv) as the split kernel's. Warps 0-3
// consume (warp w: byte rows 16 w .. 16 w + 15 of every tile, both nibbles), warp 4 produces. Score
// fragments: byte rows gid, gid + 8 of the warp's 16, heads nt * 8 + 2 tig (+ 1), once for the low
// and once for the high nibbles (mode 3 keeps them as sc[..][nt][c]: c < 4 low, c >= 4 high, row
// gid + 8 ((c >> 1) & 1), head 2 tig + (c & 1)); outputs of columns out_col<MODE>(x, c, gid).
template <int MODE, int NT>
__global__ void __launch_bounds__(SPLIT_THREADS, NT == 1 ? 3 : 1)  // G <= 8: three CTAs an SM, as the ring allows

decode_int4_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                   const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ kv_seg,
                   __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv, int stripe0, int block_rows,
                   float scale, int stages) {
  static_assert(MODE == MODE_INT4 || MODE == MODE_INT4_I8, "modes 0 and 1 run decode_split_kernel");
  constexpr int G16 = 8 * NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const SplitLayout L = split_layout(MODE, NT, stages);
  const int n_split = gridDim.x, rank = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int G = Hq / Hkv;
  const int R = S / 2;                                // byte rows of a stripe
  const int n_tiles = (R + TILE - 1) / TILE;
  const int tpb = (block_rows + TILE - 1) / TILE;     // tiles of a block
  const int n_blocks = (n_tiles + tpb - 1) / tpb;
  const size_t stripe = (size_t)b * Hkv + h;
  const bool bulk_scales = (R & 7) == 0;  // every scale run starts and ends 16-byte aligned
  int* hdr = reinterpret_cast<int*>(smem + L.off_hdr);                           // slot s: tile, live tiles of its group
  uint32_t* msk = reinterpret_cast<uint32_t*>(smem + L.off_int4);                 // slot s: low 0-31, 32-63, high 0-31, 32-63
  signed char* q8 = reinterpret_cast<signed char*>(smem + L.off_int4 + stages * 16);  // [head][Q8_STRIDE] (mode 3)
  float* qstat = reinterpret_cast<float*>(q8 + G16 * Q8_STRIDE);  // [head] qscale (mode 3), [G16 + head] 8 sum(q)
  float* blk_red = qstat + 2 * G16;                         // mode 3: [parity][warp][head] (max score, max p * v_scale)
  unsigned char* rec = reinterpret_cast<unsigned char*>(blk_red + 2 * CONSUMERS * G16 * 2) + warp * G16 * 32;
  const uint32_t full0 = smem_u32(smem + L.off_bar), empty0 = full0 + 8 * stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // q's per-head terms, one warp a head: mode 2 8 sum(q); mode 3 q8 (padding heads zero), qscale, 8 sum(q8)
  if (warp < CONSUMERS)
    for (int g = warp; g < G16; g += CONSUMERS) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < G) {
        const uint2 raw = *reinterpret_cast<const uint2*>(q + ((size_t)b * Hq + (size_t)h * G + g) * QD + 4 * lane);
        const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v[0] = f0.x, v[1] = f0.y, v[2] = f1.x, v[3] = f1.y;
      }
      float sq = v[0] + v[1] + v[2] + v[3];
      if (MODE == MODE_INT4_I8) {
        const float qa = warp_max(fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
        const float qs = fmaxf(qa, 1e-8f) * (1.0f / 127.0f);
        uint32_t packed4 = 0;
        sq = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float r = rintf(v[j] / qs);  // the IEEE quotient, round half to even: the plain version's
          sq += r;
          packed4 |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xFFu) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(q8 + g * Q8_STRIDE + 4 * lane) = packed4;
        if (lane == 0) qstat[g] = qs;
      }
      sq = warp_sum(sq);
      if (lane == 0) qstat[G16 + g] = KV4_BIAS * sq;
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
    // ---- the producer: this rank's blocks, in groups of up to BLOCK_TILES tiles (a mode-3 block is
    // one group), the tiles with a valid cell in either half, then an end marker ----
    const int* seg = kv_seg + (size_t)b * S;
    const int z = stripe0 + static_cast<int>(stripe);
    // word w of tile g0 + k's mask: w & 1 the rows' second 32, w >> 1 the high nibbles (token R + row)
    auto load = [&](bool (&c)[BLOCK_TILES][4], int blk, int g0) {
      const int t_end = min((blk + 1) * tpb, n_tiles);
#pragma unroll
      for (int k = 0; k < BLOCK_TILES; ++k)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int t = g0 + k, row = t * TILE + 32 * (w & 1) + lane;
          c[k][w] = t < t_end && row < R && seg[(w >> 1) * R + row] != 0;
        }
    };
    bool cur[BLOCK_TILES][4], nxt[BLOCK_TILES][4];
    int blk = rank, g0 = rank * tpb, i = 0;  // i: live tiles issued
    load(cur, blk, g0);
    while (blk < n_blocks) {
      int nblk = blk, ng = g0 + BLOCK_TILES;
      if (ng >= min((blk + 1) * tpb, n_tiles)) nblk = blk + n_split, ng = nblk * tpb;
      load(nxt, nblk, ng);  // the next group's cells, early
      uint32_t mk[BLOCK_TILES][4];
      int live = 0;
#pragma unroll
      for (int k = 0; k < BLOCK_TILES; ++k) {
#pragma unroll
        for (int w = 0; w < 4; ++w) mk[k][w] = __ballot_sync(0xffffffffu, cur[k][w]);
        live += (mk[k][0] | mk[k][1] | mk[k][2] | mk[k][3]) != 0;
      }
#pragma unroll
      for (int k = 0; k < BLOCK_TILES; ++k) {
        if ((mk[k][0] | mk[k][1] | mk[k][2] | mk[k][3]) == 0) continue;  // no valid cell: none of its bytes is read
        const int t = g0 + k, s = i % stages;
        if (i >= stages) mbar_wait(empty0 + 8 * s, (i / stages - 1) & 1);
        if (lane == 0) {
          hdr[4 * s] = t;
          hdr[4 * s + 1] = live;
#pragma unroll
          for (int w = 0; w < 4; ++w) msk[4 * s + w] = mk[k][w];
          const uint32_t bar = full0 + 8 * s, dst = smem_u32(smem + s * L.slot);
          const int run = bulk_scales ? min(TILE, R - t * TILE) * 2 : 0;  // bytes of a scale run
          mbar_expect_tx(bar, 2 * BOX_BYTES + 4 * run);
          tma_load_3d(dst, &kmap, 0, t * TILE, z, bar);
          tma_load_3d(dst + BOX_BYTES, &vmap, 0, t * TILE, z, bar);
          if (run) {
            const size_t lo = stripe * S + (size_t)t * TILE;
            bulk_g2s(dst + 2 * BOX_BYTES, k_scale + lo, run, bar);
            bulk_g2s(dst + 2 * BOX_BYTES + TILE * 2, k_scale + lo + R, run, bar);
            bulk_g2s(dst + 2 * BOX_BYTES + 2 * TILE * 2, v_scale + lo, run, bar);
            bulk_g2s(dst + 2 * BOX_BYTES + 3 * TILE * 2, v_scale + lo + R, run, bar);
          }
        }
        __syncwarp();
        ++i;
      }
#pragma unroll
      for (int k = 0; k < BLOCK_TILES; ++k)
#pragma unroll
        for (int w = 0; w < 4; ++w) cur[k][w] = nxt[k][w];
      blk = nblk, g0 = ng;
    }
    const int s = i % stages;
    if (i >= stages) mbar_wait(empty0 + 8 * s, (i / stages - 1) & 1);
    if (lane == 0) {
      hdr[4 * s] = -1;
      mbar_arrive(full0 + 8 * s);
    }
  } else {
    // ---- a consumer warp: byte rows r0 .. r0 + 15 of every tile ----
    const int r0 = WARP_ROWS * warp;
    const __nv_bfloat16* ksg = k_scale + stripe * S;
    const __nv_bfloat16* vsg = v_scale + stripe * S;
    // this warp's valid cells of the tile in slot s: bit r of half hf = byte row r0 + r
    auto bits = [&](int s, int hf) { return (msk[4 * s + 2 * hf + (r0 >> 5)] >> (r0 & 31)) & 0xFFFFu; };
    // the scale (run 0: k, 1: v) of this thread's cell (half hf, byte row r0 + gid + 8 rr) of `tile`;
    // only read for a valid cell
    auto cell_scale = [&](const unsigned char* slot, int run, int tile, int hf, int rr) {
      const int j = r0 + gid + 8 * rr;
      return __bfloat162float(bulk_scales
          ? reinterpret_cast<const __nv_bfloat16*>(slot + 2 * BOX_BYTES + (2 * run + hf) * TILE * 2)[j]
          : (run ? vsg : ksg)[hf * R + tile * TILE + j]);
    };
    float hsq[NT][2];  // 8 sum(q) (mode 3: of q8) of heads nt * 8 + 2 tig + e
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) hsq[nt][e] = qstat[G16 + nt * 8 + 2 * tig + e];

    if constexpr (MODE == MODE_INT4) {
      // q as the scores' B fragments in mode 1's k order: d = 32 tig + 4 ks + 0, 1 and 2, 3
      uint32_t qb[NT][8][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int head = nt * 8 + gid;
        const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)h * G + (head < G ? head : 0)) * QD;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          uint2 w = make_uint2(0u, 0u);
          if (head < G) w = *reinterpret_cast<const uint2*>(qh + 32 * tig + 4 * ks);
          qb[nt][ks][0] = w.x, qb[nt][ks][1] = w.y;
        }
      }
      float sv_run[NT][2];  // sum of the unrounded p * v_scale, for the -8 debias
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sv_run[nt][0] = sv_run[nt][1] = 0.f;

      for (int i = 0;; ++i) {
        const int s = i % stages;
        mbar_wait(full0 + 8 * s, (i / stages) & 1);
        const int tile = hdr[4 * s];
        if (tile < 0) break;
        const uint32_t mine[2] = {bits(s, 0), bits(s, 1)};
        if (mine[0] | mine[1]) {
          const unsigned char* slot = smem + s * L.slot;
          bool v[2][2];  // [half][row gid, gid + 8]
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) v[hf][0] = (mine[hf] >> gid) & 1u, v[hf][1] = (mine[hf] >> (gid + 8)) & 1u;

          // ---- scores S^T of the low and the high nibbles (16 rows x 8 heads a tile of N) ----
          float sc[2][NT][4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int c = 0; c < 4; ++c) sc[hf][nt][c] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            // rows gid, gid + 8: bytes 32 tig + 4 ks .. + 3, a word at a time (three CTAs an SM)
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(slot + swz(r0 + gid, 32 * tig + 4 * ks));
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(slot + swz(r0 + gid + 8, 32 * tig + 4 * ks));
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const uint32_t a[4] = {nib_pair(w0, w0, 0, 1, hf), nib_pair(w1, w1, 0, 1, hf), nib_pair(w0, w0, 2, 3, hf),
                                     nib_pair(w1, w1, 2, 3, hf)};
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) mma_bf16(sc[hf][nt], a, qb[nt][ks][0], qb[nt][ks][1]);
            }
          }

          // ---- online softmax of the warp's 32 tokens, the warp's own running max ----
          float f[2][2], gv[2][2];  // k_scale * scale and v_scale of the thread's cells; 0 where invalid
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              f[hf][rr] = v[hf][rr] ? cell_scale(slot, 0, tile, hf, rr) * scale : 0.f;
              gv[hf][rr] = v[hf][rr] ? cell_scale(slot, 1, tile, hf, rr) : 0.f;
            }
          uint32_t pb[2][NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float pw[2][2][2];  // [half][row][head e]: p * v_scale
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float sx[2][2], mx = NEG_INF;
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                  sx[hf][rr] = v[hf][rr] ? (sc[hf][nt][2 * rr + e] - hsq[nt][e]) * f[hf][rr] : NEG_INF;
                  mx = fmaxf(mx, sx[hf][rr]);
                }
              const float m_new = fmaxf(m_run[nt][e], gid_max(mx));
              const float corr = __expf(m_run[nt][e] - m_new);
              float psum = 0.f, svsum = 0.f;
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                  const float p = v[hf][rr] ? __expf(sx[hf][rr] - m_new) : 0.f;
                  psum += p;
                  pw[hf][rr][e] = p * gv[hf][rr];
                  svsum += pw[hf][rr][e];
                }
              l_run[nt][e] = l_run[nt][e] * corr + psum;  // this lane's tokens; lanes summed at the end
              sv_run[nt][e] = sv_run[nt][e] * corr + svsum;
              m_run[nt][e] = m_new;
#pragma unroll
              for (int x = 0; x < 8; ++x) acc[nt][x][e] *= corr, acc[nt][x][2 + e] *= corr;
            }
            // the p . u product takes bf16 weights, as the TPU kernel does; (token, head) -> (head, token)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) pb[hf][nt][rr] = movmatrix_trans(pack_bf16(pw[hf][rr][0], pw[hf][rr][1]));
          }

          // ---- O^T += U^T . P^T: 8 M tiles of 16 columns, K = the warp's 16 rows of each half ----
          // rows r0 + 2 tig, + 1, + 8, + 9 (the k of this thread's B values), bytes 16 gid .. 16 gid + 15, a
          // word of each row for two M tiles
          const unsigned char* vslot = slot + BOX_BYTES;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            // M row gid: column 16 gid + 2 x, row gid + 8: 16 gid + 2 x + 1 (bytes 2 x, 2 x + 1 of a chunk)
            const int wi = x >> 1, sh = 2 * (x & 1);
            auto vw = [&](int j) {
              return *reinterpret_cast<const uint32_t*>(vslot + swz(r0 + 2 * tig + (j & 1) + 8 * (j >> 1),
                                                                    16 * gid + 4 * wi));
            };
            const uint32_t x0 = vw(0), x1 = vw(1), x2 = vw(2), x3 = vw(3);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const uint32_t a[4] = {nib_pair(x0, x1, sh, 4 + sh, hf), nib_pair(x0, x1, sh + 1, 5 + sh, hf),
                                     nib_pair(x2, x3, sh, 4 + sh, hf), nib_pair(x2, x3, sh + 1, 5 + sh, hf)};
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][x], a, pb[hf][nt][0], pb[hf][nt][1]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
      // the -8 debias with the unrounded weights, per warp (its tokens)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = KV4_BIAS * gid_sum(sv_run[nt][e]);
#pragma unroll
          for (int x = 0; x < 8; ++x) acc[nt][x][e] -= sv, acc[nt][x][2 + e] -= sv;
        }
    } else {
      // q8 as the scores' B fragments, read from shared memory at each tile (registers hold the block's
      // scores): k 4 tig + j of step ks is d = 32 tig + 8 ks + j, k 16 + 4 tig + j is d = 32 tig + 8 ks + 4 + j
      // (the order in which a thread holds its rows' 32 bytes)
      auto qb = [&](int nt, int ks) {
        return *reinterpret_cast<const uint2*>(q8 + (nt * 8 + gid) * Q8_STRIDE + 32 * tig + 8 * ks);
      };
      float hqs[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) hqs[nt][e] = qstat[nt * 8 + 2 * tig + e];
      // valid cell of fragment value c (c < 4 low, else high; row gid + 8 ((c >> 1) & 1))
      auto live_cell = [&](const uint32_t (&mine)[2], int c) { return (mine[c >> 2] >> (gid + 8 * ((c >> 1) & 1))) & 1u; };
      int par = 0;  // which half of blk_red this block's maxima use
      for (int i = 0;;) {
        const int s0 = i % stages;
        mbar_wait(full0 + 8 * s0, (i / stages) & 1);
        if (hdr[4 * s0] < 0) break;
        const int n_live = hdr[4 * s0 + 1];  // the block's live tiles: slots i .. i + n_live - 1

        // ---- the block's scores into registers ----
        float sc[BLOCK_TILES][NT][8], mx[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mx[nt][0] = mx[nt][1] = NEG_INF;
#pragma unroll
        for (int k = 0; k < BLOCK_TILES; ++k) {
          if (k >= n_live) break;
          const int s = (i + k) % stages;
          if (k > 0) mbar_wait(full0 + 8 * s, ((i + k) / stages) & 1);
          const uint32_t mine[2] = {bits(s, 0), bits(s, 1)};
          if ((mine[0] | mine[1]) == 0) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int c = 0; c < 8; ++c) sc[k][nt][c] = NEG_INF;
            continue;
          }
          const unsigned char* slot = smem + s * L.slot;
          const int tile = hdr[4 * s];
          int cl[NT][4], ch[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) cl[nt][c] = ch[nt][c] = 0;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            // rows gid, gid + 8: bytes 32 tig + 8 ks .. + 7, loaded step by step (registers hold the block's
            // scores)
            const uint2 w0 = *reinterpret_cast<const uint2*>(slot + swz(r0 + gid, 32 * tig + 8 * ks));
            const uint2 w1 = *reinterpret_cast<const uint2*>(slot + swz(r0 + gid + 8, 32 * tig + 8 * ks));
            const uint32_t a_lo[4] = {w0.x & NIB, w1.x & NIB, w0.y & NIB, w1.y & NIB};
            const uint32_t a_hi[4] = {(w0.x >> 4) & NIB, (w1.x >> 4) & NIB, (w0.y >> 4) & NIB, (w1.y >> 4) & NIB};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint2 b = qb(nt, ks);
              mma_s8(cl[nt], a_lo, b.x, b.y);
              mma_s8(ch[nt], a_hi, b.x, b.y);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int e = c & 1;
              float sv = NEG_INF;
              if (live_cell(mine, c)) {
                // the plain version's order: ((q8 . u - 8 sum q8) * qscale) * (k_scale * scale)
                const float dot = static_cast<float>(c < 4 ? cl[nt][c] : ch[nt][c - 4]);
                const float kss = cell_scale(slot, 0, tile, c >> 2, (c >> 1) & 1) * scale;
                sv = ((dot - hsq[nt][e]) * hqs[nt][e]) * kss;
              }
              sc[k][nt][c] = sv;
              mx[nt][e] = fmaxf(mx[nt][e], sv);
            }
        }

        // ---- the block's maxima: each warp its largest score and exp(s - that) * v_scale ----
        float pm[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mx[nt][0] = gid_max(mx[nt][0]), mx[nt][1] = gid_max(mx[nt][1]);
          pm[nt][0] = pm[nt][1] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < BLOCK_TILES; ++k) {
          if (k >= n_live) break;
          const int s = (i + k) % stages;
          const uint32_t mine[2] = {bits(s, 0), bits(s, 1)};
          if ((mine[0] | mine[1]) == 0) continue;
          const unsigned char* slot = smem + s * L.slot;
          const int tile = hdr[4 * s];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (live_cell(mine, c))
                pm[nt][c & 1] = fmaxf(pm[nt][c & 1], __expf(sc[k][nt][c] - mx[nt][c & 1]) *
                                                         cell_scale(slot, 1, tile, c >> 2, (c >> 1) & 1));
        }
        float* red = blk_red + par * CONSUMERS * G16 * 2;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pm[nt][e] = gid_max(pm[nt][e]);
            if (gid == 0) {
              red[(warp * G16 + nt * 8 + 2 * tig + e) * 2] = mx[nt][e];
              red[(warp * G16 + nt * 8 + 2 * tig + e) * 2 + 1] = pm[nt][e];
            }
          }
        consumers_sync();  // the one meeting of the block
        // the common running max; pscale = the block's max of p * v_scale against it, / 127
        float pscale[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int head = nt * 8 + 2 * tig + e;
            float M = NEG_INF;
#pragma unroll
            for (int w2 = 0; w2 < CONSUMERS; ++w2) M = fmaxf(M, red[(w2 * G16 + head) * 2]);
            const float m_new = fmaxf(m_run[nt][e], M);
            float pmax = 0.f;
#pragma unroll
            for (int w2 = 0; w2 < CONSUMERS; ++w2)
              pmax = fmaxf(pmax, red[(w2 * G16 + head) * 2 + 1] * __expf(red[(w2 * G16 + head) * 2] - m_new));
            pscale[nt][e] = fmaxf(pmax, 1e-20f) * (1.0f / 127.0f);
            const float corr = __expf(m_run[nt][e] - m_new);
            l_run[nt][e] *= corr;
            m_run[nt][e] = m_new;
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[nt][x][e] *= corr, acc[nt][x][2 + e] *= corr;
          }
        par ^= 1;

        // ---- per tile: int8 weights into the warp's records, O^T += U^T . P8^T, the slot released ----
#pragma unroll
        for (int k = 0; k < BLOCK_TILES; ++k) {
          if (k >= n_live) break;
          const int s = (i + k) % stages;
          const uint32_t mine[2] = {bits(s, 0), bits(s, 1)};
          if (mine[0] | mine[1]) {
            const unsigned char* slot = smem + s * L.slot;
            const int tile = hdr[4 * s];
            float sp[NT][2];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              sp[nt][0] = sp[nt][1] = 0.f;
              // record (head, k): k < 16 the low cell of byte row r0 + k, 16 + k its high cell
              unsigned char* rn = rec + nt * 8 * 32;
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                const int e = c & 1;
                float r = 0.f;
                if (live_cell(mine, c)) {
                  const float p = __expf(sc[k][nt][c] - m_run[nt][e]);
                  l_run[nt][e] += p;
                  r = rintf(p * cell_scale(slot, 1, tile, c >> 2, (c >> 1) & 1) / pscale[nt][e]);
                }
                sp[nt][e] += r;
                rn[(2 * tig + e) * 32 + (c >> 2) * 16 + gid + 8 * ((c >> 1) & 1)] =
                    static_cast<unsigned char>(static_cast<int>(r));
              }
            }
            __syncwarp();
            // rows r0 + 4 tig .. + 3 (the k of this thread's A values), bytes 16 gid .. 16 gid + 15, a word
            // of each row at a time
            const unsigned char* vslot = slot + BOX_BYTES;
            // one N tile and one M tile at a time: the int32 sums of an M tile are one product of the
            // warp's 32 tokens, restored at once (registers: three CTAs an SM at G <= 8)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const unsigned char* rn = rec + (nt * 8 + gid) * 32;
              const uint32_t b_lo = *reinterpret_cast<const uint32_t*>(rn + 4 * tig);
              const uint32_t b_hi = *reinterpret_cast<const uint32_t*>(rn + 16 + 4 * tig);
              const float spw[2] = {KV4_BIAS * gid_sum(sp[nt][0]), KV4_BIAS * gid_sum(sp[nt][1])};
#pragma unroll
              for (int qq = 0; qq < 4; ++qq) {
                uint32_t rw[4], cw[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  rw[j] = *reinterpret_cast<const uint32_t*>(vslot + swz(r0 + 4 * tig + j, 16 * gid + 4 * qq));
                transpose4x4(rw, cw);  // cw[c]: rows r0 + 4 tig .. + 3 of column 16 gid + 4 qq + c
#pragma unroll
                for (int xx = 0; xx < 2; ++xx) {
                  // M row gid: column 16 gid + 2 x, row gid + 8: 16 gid + 2 x + 1 (x = 2 qq + xx)
                  const int x = 2 * qq + xx;
                  const uint32_t a[4] = {cw[2 * xx] & NIB, cw[2 * xx + 1] & NIB, (cw[2 * xx] >> 4) & NIB,
                                         (cw[2 * xx + 1] >> 4) & NIB};
                  int ai[4] = {0, 0, 0, 0};
                  mma_s8(ai, a, b_lo, b_hi);
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    acc[nt][x][c] += (static_cast<float>(ai[c]) - spw[c & 1]) * pscale[nt][c & 1];
                }
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
        i += n_live;
      }
    }
  }

  split_combine<MODE, NT>(smem, L, m_run, l_run, acc, o, b, h, Hq, G);
}

// The stacked cache as (D, S, L * B * Hkv) of `esize`-byte values, read in boxes of 128 bytes of d x
// TILE tokens x 1 stripe with the 128-byte swizzle; tokens past S read as zeros. An int4 cache is
// (128, S/2, L * B * Hkv) bytes: its boxes are 64 byte rows.
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

// Bytes of dynamic shared memory of a split plan; -1 for a plan the kernel cannot run (modes 0 and 1
// take rings of up to SPLIT_MAX_STAGES slots, the int4 modes up to INT4_MAX_STAGES).
int split_smem(int mode, int G, int n_split, int stages) {
  const bool int4 = mode == MODE_INT4 || mode == MODE_INT4_I8;
  if ((mode != MODE_BF16 && mode != MODE_INT8 && !int4) || G < 1 || G > GMAX || n_split < 1 ||
      n_split > SPLIT_MAX_CLUSTER || stages < 1 || (stages > SPLIT_MAX_STAGES && !int4) || stages > INT4_MAX_STAGES)
    return -1;
  return split_layout(mode, G <= 8 ? 1 : 2, stages).total;
}

template <int MODE, int NT>
int launch_split(const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q, const void* ks,
                 const void* vs, const void* kv_seg, void* o, int B, int Hq, int Hkv, int S, int stripe0,
                 int block_rows, float scale, int n_split, int stages, int smem, cudaStream_t stream) {
  auto kernel = decode_split_kernel<MODE_BF16, NT>;
  if constexpr (MODE == MODE_INT8) kernel = decode_split_kernel<MODE_INT8, NT>;
  if constexpr (MODE == MODE_INT4) kernel = decode_int4_kernel<MODE_INT4, NT>;
  if constexpr (MODE == MODE_INT4_I8) kernel = decode_int4_kernel<MODE_INT4_I8, NT>;
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
      Hq, Hkv, stripe0, block_rows, scale, stages));
}

template <int MODE>
int launch_mode(const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q, const void* ks, const void* vs,
                const void* kv_seg, void* o, int B, int Hq, int Hkv, int S, int stripe0, int block_rows,
                float scale, int n_split, int stages, int smem, cudaStream_t stream) {
  return Hq / Hkv <= 8 ? launch_split<MODE, 1>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, block_rows,
                                               scale, n_split, stages, smem, stream)
                       : launch_split<MODE, 2>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, block_rows,
                                               scale, n_split, stages, smem, stream);
}

}  // namespace

// Dynamic shared memory (bytes) of the split kernel (every mode) under a plan
// (cluster size, ring slots); -1 for a plan it cannot run.
extern "C" int st_decode_split_smem(int mode, int G, int n_split, int stages) {
  return split_smem(mode, G, n_split, stages);
}

// Caches of L layers in every mode -- bf16 (0), int8 (1), int4 with dots on
// the widened nibbles (2) and int4 with int8 dots (3) -- under the plan
// (n_split ranks, `stages` ring slots) from ops/decode_attention.py
// `decode_plan`; `S` is the width in tokens (int4: twice the packed rows) and
// `block_rows` the int4 modes' block of packed rows (`int4_block_rows`). Refuses
// (cudaErrorInvalidValue, before anything launches) a plan or a shape it
// cannot run: mode 3 a block of more than BLOCK_TILES tiles (256 rows) or a
// ring that cannot hold one. Scales (modes 1-3) are the (L, B, Hkv, S) stacks.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int st_decode_split(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                               const void* v_scale, const void* kv_seg, void* o, int L, int B, int Hq, int Hkv,
                               int S, int layer, int mode, int block_rows, int n_split, int stages, float scale,
                               void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || B < 1 || B > 65535 || Hkv > 65535 || S < 1 || L < 1 || layer < 0 ||
      layer >= L || static_cast<long long>(L) * B * Hkv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const bool int4 = mode == MODE_INT4 || mode == MODE_INT4_I8;
  const int rows = int4 ? S / 2 : S;  // cache rows of a stripe
  if (int4) {
    if (S % 2 != 0 || block_rows < 1 || block_rows > rows || rows % block_rows != 0 ||
        (block_rows % TILE != 0 && block_rows != rows))
      return static_cast<int>(cudaErrorInvalidValue);
    const int tpb = (block_rows + TILE - 1) / TILE;
    if (mode == MODE_INT4_I8 && (tpb > BLOCK_TILES || stages < tpb)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = split_smem(mode, G, n_split, stages);
  if (smem < 0 || smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = mode == MODE_BF16 ? 2 : 1;
  CUtensorMap kmap, vmap;
  if (!encode_cache_map(&kmap, k_cache, esize, rows, L * B * Hkv) ||
      !encode_cache_map(&vmap, v_cache, esize, rows, L * B * Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t layer_cells = (size_t)B * Hkv * (size_t)S;
  const __nv_bfloat16* ks = nullptr;
  const __nv_bfloat16* vs = nullptr;
  if (mode != MODE_BF16) {
    ks = static_cast<const __nv_bfloat16*>(k_scale) + layer * layer_cells;
    vs = static_cast<const __nv_bfloat16*>(v_scale) + layer * layer_cells;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stripe0 = layer * B * Hkv;
  switch (mode) {
    case MODE_BF16:
      return launch_mode<MODE_BF16>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, block_rows, scale,
                                    n_split, stages, smem, s);
    case MODE_INT8:
      return launch_mode<MODE_INT8>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, block_rows, scale,
                                    n_split, stages, smem, s);
    case MODE_INT4:
      return launch_mode<MODE_INT4>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, block_rows, scale,
                                    n_split, stages, smem, s);
    default:
      return launch_mode<MODE_INT4_I8>(kmap, vmap, q, ks, vs, kv_seg, o, B, Hq, Hkv, S, stripe0, block_rows, scale,
                                       n_split, stages, smem, s);
  }
}
