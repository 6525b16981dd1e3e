// Paged decode attention for Hopper (sm_90a): one new query token per slot
// attends the slot's pages of a global KV page pool through its page table.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/paged_attention.py:
//   `_paged_kernel` (:113)          bf16 pools, and int8 pools with per-cell
//                                   scales (modes 0 and 1 here);
//   `_paged_kernel_int4_i8` (:338)  int4 pools, both dots on int8 operands
//                                   (mode 2);
//   `_paged_kernel_int4` (:225)     int4 pools, dots on the unsigned nibbles
//                                   widened to floating point (mode 3);
//   and their helper `_staged_block_update` (:59) under `staged=`.
// Same contract as `_pallas_paged`:
//   q (S, Hq, 128) bf16; pools (L, N, Hkv, page, 128) bf16 | int8, or uint8
//   (L, N, Hkv, page/2, 128) for int4 (byte row r of a page holds cell r in
//   its low nibble and cell r + page/2 in its high nibble, both +8 biased);
//   scales (L, N, Hkv, page) bf16 per token cell; page_table (S, P_max) int32;
//   lengths (S,) int32 = valid compacted cells of the slot; layer = which
//   layer of the pools. Outputs: o (S, Hq, 128) bf16 normalised, and the
//   partial-softmax stats m, l (S, Hq) fp32 in scaled-score space, so the
//   caller can merge further cells by the flash combine. A slot of length 0
//   gives o = 0, m = -1e30, l = 0.
// The page table is read by the CTA itself: pool[layer, table[slot, pi]] is
// addressed directly, no gathered cache exists, and the layer is a pointer
// offset. Pages at or beyond ceil(length / page) are never touched (the TPU
// kernel fetches them fully masked, which computes the same thing).
//
// Arithmetic follows the TPU kernels page block by page block, so the plain
// PyTorch versions in ops/paged_attention.py state the same function:
//   modes 0/1: scores = q . k in fp32 (int8 k exact in fp32), times
//     scale (mode 1: times k_scale * scale); online softmax against the
//     running max; weights (mode 1: times v_scale) rounded to bf16 for p . v.
//   mode 2: q quantized once per (head, row) to int8; scores = int8 dot of q
//     with the biased nibbles, debiased by -8 * sum(q), times qscale, times
//     (k_scale * scale); weights times v_scale are quantized to int8 per row
//     PER PAGE against that page's row max; p . v is an int8 dot debiased by
//     -8 * sum(p) and restored by pscale. The int32 sums are exact.
//   mode 3: scores = q . u in fp32 on the unsigned nibbles u = value + 8,
//     debiased by -8 * sum(q), times (k_scale * scale); weights times v_scale
//     are rounded to bf16 for the p . u dot, which is debiased by -8 * sum(p)
//     with the UNROUNDED fp32 weights, as the TPU kernel does.
//
// What bounds it on the H100: bytes -- a step reads every live cell once
// (0.5 to 2 bytes per value) and does 4 * G operations per value, far under
// the card's operations-per-byte balance; what keeps a kernel from the byte
// bound is latency: loads waited on in series, and too few warps in flight.
//
// One design for every mode: #9's split kernel. One plan per call
// (ops/paged_attention.py `paged_plan`, its `mode` argument) splits each
// slot's pages over a thread-block cluster of up to 8 CTAs where the (slot,
// kv head) pairs leave SMs idle (path (c)'s 17 lanes x 2 kv heads on 132
// SMs; not the shipped 129 lanes), the ranks meeting in distributed shared
// memory in rank order (`split_end`: no second kernel, no atomics, two calls
// bit-identical). Pages, or parts of them, arrive by bulk asynchronous copies
// into rings of K and V slots completed on mbarriers while the ones before
// are computed; both products run on tensor cores (`mma.sync`).
//
// Mode 2 (#9, the shipped path: every layer of every decode step) is
// `paged_kernel_int4_i8`, described above it. In short: up to 8 warps take
// 16-row blocks of a page, both dots on `mma.sync` m16n8k32 s8, two CTA
// barriers a page carry its row maxima (the weights are quantized per row
// per page). The grid runs rank fastest, then slot, then kv head: the engine
// gives a group's lanes the first free slots, so at a refill a group's 8
// lanes are adjacent slots and the CTAs reading the group's shared prompt
// pages run together and meet in the 50 MB L2. A page of more than 1,024
// cells passes in parts of 512 rows through one K and one V slot, three
// times: the row max, the weights' sum and max, then the int8 weights and
// p . v, the scores recomputed each pass. What it does not do yet: V blocks
// are transposed in registers from 32-bit shared loads the 4 threads of a
// quad make in the same banks (4-way conflicts).
//
// Modes 0, 1, 3 (#7 bf16 and int8 pools, #8 int4 pools with widened nibbles;
// every knob off the shipped `int4_i8dot`: path (c), path (f)'s `paged_int4`
// case, path (h)'s greedy fused runs) are `paged_kernel_split`, described
// above it: the same plan, cluster, copies and combine; the unit is a part of
// a page (warps x 16 pool rows), one streaming pass with an online-softmax
// step and one CTA barrier a part; both products on `mma.sync` m16n8k16 bf16
// (int8 values converted, int4 nibbles widened in registers, both exact).
//
// The staged block (every mode, when C > 0). Replaces the TPU helper
// `_staged_block_update` (spatialthinker_tpu/ops/paged_attention.py), which
// #7, #8 and #9 run on their last grid step under `staged=`: after the last
// page and before the flush, one more online-softmax update over the slot's
// C cells of the decode staging ring (the chunk's tokens not yet installed
// in the pools). The ring is dense and slot-major, (L, S, Hkv, C, 128): bf16
// cells under bf16 pools, int8 cells with bf16 per-cell scales (L, S, Hkv, C)
// under int8 AND int4 pools (ring cells are never packed); stage_seg (S, C)
// int32 marks the live cells (seg != 0), which need not be a prefix. The
// update is the TPU helper's: scores = bf16(q) . bf16(k) in fp32 -- the float
// q also in mode 2, never its int8 copy -- times (k_scale * scale) with
// scales, else times scale; dead cells masked; m, l and acc corrected;
// weights times v_scale rounded to bf16 for the p . v dot. In every mode the
// last rank of the cluster runs it after its pages, the ring's K and V cells
// arriving by one bulk copy each at the kernel's start: in mode 2 a warp
// takes a cell's scores (a lane four columns) and the p . v of its cells in
// fp32; in modes 0, 1, 3 the ring passes the unit's bf16 products as one
// more part (bf16 rows in mode 0, int8 rows in modes 1 and 3). With the ring
// fused, the returned (m, l) are final: the caller has nothing left to merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int D = 128;        // head dim (text heads of the 3B/7B presets)
constexpr int GMAX = 16;      // largest query group per kv head
constexpr int KV4_BIAS = 8;
constexpr float NEG_INF = -1e30f;
constexpr int MODE_BF16 = 0, MODE_INT8 = 1, MODE_INT4_I8 = 2, MODE_INT4 = 3;
constexpr int MAX_SMEM = 232448;  // bytes a block may opt in to on sm_90

// int4 pools are packed: byte row r = cells r and r + page/2
__host__ __device__ inline bool packed(int mode) { return mode == MODE_INT4_I8 || mode == MODE_INT4; }

// ---- mode 2: the split kernel of int4 pools with int8 dots ----
//
// CTA (rank, slot, kv head), grid (n, S, Hkv): the n CTAs of one (slot, kv
// head) form a thread-block cluster; rank r takes the slot's pages
// pi = r, r + n, ... with its own running (m, l, acc), and the last rank the
// staging ring. Each page stays one unit, so its weight quantization (per row
// per page, against the page's row max of p * v_scale) is the plain
// version's; a rank's weights are relative to its own running max, which
// the int8 weights p / pscale do not see (both scale alike). The ranks meet
// in distributed shared memory in rank order: M = max m_r, w_r = exp(m_r - M),
// l = sum l_r w_r, o = sum acc_r w_r / l. No second kernel, no atomics.
//
// Inside a CTA, `warps` warps split a page into blocks of 16 byte rows (32
// cells: the lo nibbles of rows r0..r0+15 and their hi-nibble partners
// r0+half..), block b to warp b % warps. Both dots are `mma.sync` m16n8k32
// s8 (nibbles are valid s8): the scores S^T[cell][head] = K[cell][d] q8[head][d]
// with the cells as M and up to 8 heads as N (two N tiles for G > 8), and
// O^T[d][head] = V^T[d][cell] p8[head][cell] with 16 columns of d as M and
// the 32 cells of a block as K. Per page: scores into registers, one CTA
// barrier for the page's row max, one for the row max of p * v_scale (the
// weight scale), then each warp quantizes its own cells' weights, writes
// them to its records in the product's k order and runs p . v on them; its
// partial (l, acc) is summed with the other warps' after the last page.
// The per-value softmax work is branch-free (a dead cell's score is -1e30,
// whose exp is 0), so the compiler overlaps the values: with 8 warps an SM,
// each page's phases are chains of dependent latencies, not bandwidth. The
// weights' exp is `__expf` (ex2) and their quantization a product with
// 1 / pscale: both within a few ulps of the plain version's exp and
// division, which moves an int8 weight only on an exact rounding tie.
//
// Pages arrive by bulk asynchronous copies (`cp.async.bulk`, completion on
// an mbarrier), one per operand: K with both scale vectors (4-byte
// `cp.async`s tracked by the same barrier where the page is not a multiple
// of 8 cells), and V, each in a ring of `stages` slots. Thread 0 refills a
// K slot after the page's second barrier and a V slot after the next page's
// first, so the next pages land while this one is computed. A CTA costs a
// few µs before its first page (the length, page-table and q reads, the
// final sum of the warps' partials): the plan splits a slot's pages over
// a cluster only where the (slot, kv head) pairs leave SMs idle.

constexpr int SPLIT_ROWS = 16;         // byte rows a block: 32 cells, the K of one product
constexpr int SPLIT_MAX_CLUSTER = 8;   // the portable cluster size
constexpr int SPLIT_MAX_WARPS = 8;
constexpr int SPLIT_MAX_STAGES = 4;
constexpr unsigned int NIB = 0x0F0F0F0Fu;
constexpr int SMEM_BUDGET_TWO = 113 * 1024;  // shared memory a CTA may take and leave room for a second

// Shared memory of the split kernels, computed alike on host and device. The
// K and V slots and the ring's cells are reused for the warps' partial
// outputs once the last page is done.
struct SplitLayout {
  int kbytes;   // K (or V) bytes of a slot: a page's rows rounded up to whole blocks, at most the
                // rows the CTA's blocks cover (a larger page passes in parts)
  int sbytes;   // one scale region of a slot, padded to 16 bytes (modes 1-3)
  int kslot;    // a K slot: K rows, k_scale, v_scale
  int off_v, off_ring, off_q8, off_qf, off_p8, off_red, off_stat, off_rs, off_bar, total;
};

__host__ __device__ inline SplitLayout split_layout(int mode, int nt, int page, int C, int warps, int bpw,
                                                    int stages) {
  SplitLayout L;
  const int g16 = 8 * nt;
  if (mode != MODE_INT4_I8) {
    // modes 0, 1, 3 (`paged_kernel_split`): a slot holds a part of warps blocks of 16 pool rows (bf16
    // rows of 256 bytes, int8 or packed byte rows of 128); its scales: mode 1 the part's cells', mode 3
    // the part's two runs (lo and hi cells) where a page is a multiple of 16 cells, else the page's
    const int rb = mode == MODE_BF16 ? 2 * D : D;
    const int rows = round_up(packed(mode) ? page / 2 : page, SPLIT_ROWS), cover = warps * SPLIT_ROWS;
    const int cap = rows < cover ? rows : cover;
    L.kbytes = cap * rb;
    L.sbytes = mode == MODE_BF16 ? 0 : mode == MODE_INT8 ? 2 * cap : page % 16 == 0 ? 4 * cap : round_up(2 * page, 16);
    L.kslot = L.kbytes + 2 * L.sbytes;
    int off = stages * L.kslot;
    L.off_v = off;     off += stages * L.kbytes;
    L.off_ring = off;  off += 2 * round_up(C, SPLIT_ROWS) * rb;  // the ring's K rows, then its V rows
    const int part = (warps + 1) * g16 * D * 4 * 33 / 32;        // the warps' partial outputs and their sum
    off = round_up(off > part ? off : part, 16);
    L.off_q8 = L.off_qf = L.off_p8 = off;
    L.off_red = off;   off += 2 * warps * g16 * 4;               // per-warp row maxima, two parities
    L.off_stat = off;  off += 2 * g16 * 4;                       // the CTA's m and l
    L.off_rs = off;    off += round_up(C * 4 * 3, 16);           // ring: k_scale * scale, v_scale, live
    L.off_bar = off;   off += (2 * stages + 1) * 8;              // K slots, V slots, the ring
    L.total = off;
    return L;
  }
  const int rows = round_up(page / 2, SPLIT_ROWS), cover = warps * bpw * SPLIT_ROWS;
  L.kbytes = (rows < cover ? rows : cover) * D;
  L.sbytes = round_up(page * 2, 16);
  L.kslot = L.kbytes + 2 * L.sbytes;
  int off = stages * L.kslot;              // the K slots start at 0
  L.off_v = off;     off += stages * L.kbytes;
  L.off_ring = off;  off += 2 * C * D;     // the ring's K cells, then its V cells
  const int part = (warps + 1) * g16 * D * 4 * 33 / 32;  // the warps' partial outputs and their sum (padded)
  off = round_up(off > part ? off : part, 16);
  L.off_q8 = off;    off += g16 * D;
  L.off_qf = off;    off += C > 0 ? g16 * (D + 4) * 4 : 0;  // the staged block's float q (rows padded)
  L.off_p8 = off;    off += warps * bpw * g16 * 32;   // int8 weights, 32 a (block, head)
  L.off_red = off;   off += 2 * warps * g16 * 4;      // per-warp row maxima, twice
  L.off_stat = off;  off += 4 * g16 * 4;              // qscale, 8 sum(q), the CTA's m and l
  L.off_rs = off;    off += round_up(C * 4 * (3 + g16), 16);  // ring: k_scale * scale, v_scale, live, scores
  L.off_bar = off;   off += (2 * stages + 1) * 8;     // K slots, V slots, the ring
  L.total = off;
  return L;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
// `bar`'s phase also waits for this thread's earlier cp.asyncs (one more
// pending arrival, made when they land)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// The end of both split kernels: the CTA's (m, l, acc) from its warps' partials, summed in warp order
// (every warp holds the CTA's running max m_run; l_w[nt][e] is the warp's l, equal on its lanes), then
// the ranks' in rank order in distributed shared memory; this rank writes heads rank, rank + n, ... .
// acc holds columns 16 gid + 2 x + (c >> 1) of heads nt * 8 + 2 tig + (c & 1). red_a takes warps x
// G16 floats, fin_m / fin_l (= fin_m + G16) the CTA's m and l; the slots at smem's start the partials.
template <int NT>
__device__ __forceinline__ void split_end(unsigned char* smem, float* red_a, float* fin_m, const float (&m_run)[NT][2],
                                          const float (&l_w)[NT][2], const float (&acc)[NT][8][4],
                                          __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                                          float* __restrict__ l_out, int slot, int h, int Hq, int G) {
  constexpr int G16 = 8 * NT;
  const int n_split = gridDim.x, rank = blockIdx.x, warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float* fin_l = fin_m + G16;
  // in fragment order: value k = 32 nt + 4 x + c of lane L at k * 33 + L (rows padded: no bank conflict)
  constexpr int KN = 32 * NT;
  __syncthreads();  // every warp is done with the slots and the ring: they take the partials
  float* part = reinterpret_cast<float*>(smem);  // [warps][KN][33]
  float* fin = part + warps * KN * 33;           // [KN][33]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[(warp * KN + 32 * nt + 4 * x + c) * 33 + lane] = acc[nt][x][c];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (gid == 0) red_a[warp * G16 + nt * 8 + 2 * tig + e] = l_w[nt][e];
      if (gid == 0 && warp == 0) fin_m[nt * 8 + 2 * tig + e] = m_run[nt][e];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < KN * 33; e += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < SPLIT_MAX_WARPS; ++w2)
      if (w2 < warps) sum += part[w2 * KN * 33 + e];
    fin[e] = sum;
  }
  if (threadIdx.x < G16) {
    float sum = 0.f;
    for (int w2 = 0; w2 < warps; ++w2) sum += red_a[w2 * G16 + threadIdx.x];
    fin_l[threadIdx.x] = sum;
  }

  // ---- the cluster: this rank writes heads rank, rank + n, ... from every rank's (m, l, acc) ----
  if (n_split > 1)
    cluster_sync();
  else
    __syncthreads();
  const int my_heads = G > rank ? (G - rank + n_split - 1) / n_split : 0;
  // [my head][rank]: exp(m_r - M), then the head's l (1 where it is 0); the partials are spent
  float* wts = part;
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
      }
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r)
      if (r < n_split) M = fmaxf(M, mr[r]);
    float l_sum = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r)
      if (r < n_split) {
        mr[r] = expf(mr[r] - M);
        l_sum += lr[r] * mr[r];
      }
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r)
      if (r < n_split) wts[threadIdx.x * WS + r] = mr[r];
    wts[threadIdx.x * WS + SPLIT_MAX_CLUSTER] = l_sum == 0.f ? 1.f : l_sum;
    const size_t row = (size_t)slot * Hq + (size_t)h * G + g;
    m_out[row] = M;
    l_out[row] = l_sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < my_heads * D; e += blockDim.x) {
    const int j = e / D, d = e % D, g = rank + j * n_split;
    // (head g, column d) is value k of lane L in the fragment order
    const int hh = g % 8, k = 32 * (g / 8) + 4 * ((d % 16) / 2) + 2 * (d % 2) + (hh % 2);
    const int at = k * 33 + 4 * (d / 16) + hh / 2;
    float v[SPLIT_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r)
      if (r < n_split) v[r] = *rank_ptr(fin + at, r, n_split);
    float o_sum = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r)
      if (r < n_split) o_sum += v[r] * wts[j * WS + r];
    o[((size_t)slot * Hq + (size_t)h * G + g) * D + d] = __float2bfloat16(o_sum / wts[j * WS + SPLIT_MAX_CLUSTER]);
  }
  if (n_split > 1) cluster_sync();  // no CTA leaves while another still reads its shared memory
}

// NT: N tiles of 8 heads (1: G <= 8, 2: G <= 16); BPW: blocks a warp takes of
// a page (1, 2 or 4) or of each part of it; PARTS: a page has more blocks
// than warps x BPW and passes in parts. Fragment ownership (gid = lane / 4, tig = lane % 4):
// scores of cells r0 + gid (+ 8), heads nt * 8 + 2 tig (+ 1); outputs of
// columns 16 gid .. 16 gid + 15, the same heads.
template <int NT, int BPW, bool PARTS>
__global__ void __launch_bounds__(SPLIT_MAX_WARPS * 32)
paged_kernel_int4_i8(const __nv_bfloat16* __restrict__ q, const unsigned char* __restrict__ k_pool,
                     const unsigned char* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
                     const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ page_table,
                     const int* __restrict__ lengths, __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out, const unsigned char* __restrict__ stage_k,
                     const unsigned char* __restrict__ stage_v, const __nv_bfloat16* __restrict__ stage_ks,
                     const __nv_bfloat16* __restrict__ stage_vs, const int* __restrict__ stage_seg, int Hq, int Hkv,
                     int page, int p_max, int C, float scale, int stages) {
  constexpr int G16 = 8 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_split = gridDim.x, rank = blockIdx.x, slot = blockIdx.y, h = blockIdx.z;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int G = Hq / Hkv;
  const int half = page >> 1;
  const int nblk = (half + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const SplitLayout L = split_layout(MODE_INT4_I8, NT, page, C, warps, BPW, stages);
  signed char* q8 = reinterpret_cast<signed char*>(smem + L.off_q8);
  float* qf = reinterpret_cast<float*>(smem + L.off_qf);
  unsigned char* p8 = smem + L.off_p8 + warp * BPW * G16 * 32;  // this warp's weight records
  float* red_a = reinterpret_cast<float*>(smem + L.off_red);
  float* red_b = red_a + warps * G16;
  float* qscale_sh = reinterpret_cast<float*>(smem + L.off_stat);
  float* sumq8_sh = qscale_sh + G16;
  float* fin_m = qscale_sh + 2 * G16;  // then the CTA's l (split_end)
  float* rks = reinterpret_cast<float*>(smem + L.off_rs);
  float* rvs = rks + C;
  int* rseg = reinterpret_cast<int*>(rvs + C);
  float* sring = reinterpret_cast<float*>(rseg + C);
  // K slot s: bar0 + 8 s; V slot s: bar0 + 8 (stages + s); the ring: bar0 + 16 stages
  const uint32_t bar0 = smem_u32(smem + L.off_bar);

  // the first page id is read beside the length, not after it (one memory round trip, not two)
  const __nv_bfloat16* q_rows = q + ((size_t)slot * Hq + (size_t)h * G) * D;
  const int first_page = threadIdx.x == 0 && rank < p_max ? page_table[(size_t)slot * p_max + rank] : 0;
  const int len = lengths[slot];
  const int npg = min((len + page - 1) / page, p_max);
  const int mine = npg > rank ? (npg - rank + n_split - 1) / n_split : 0;  // pages rank, rank + n, ...
  const bool ring = C > 0 && rank == n_split - 1;
  const int page_bytes = half * D;
  const int part_rows = warps * BPW * SPLIT_ROWS;  // byte rows of a page the CTA's blocks cover
  const bool bulk_scales = (page & 7) == 0;
  const size_t ring_cell0 = ((size_t)slot * Hkv + h) * C;

  auto page_row = [&](int i) {  // (page id, kv head) row of this rank's i-th page
    return (size_t)(i == 0 ? first_page : page_table[(size_t)slot * p_max + rank + i * n_split]) * Hkv + h;
  };
  // K rows of part j of this rank's page i (the whole page where it is one part) into K slot
  // i % stages, with the page's two scale vectors where `scales`
  auto issue_k = [&](int i, int j, bool scales) {
    const size_t row = page_row(i);
    const int s = i % stages;
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t dst = smem_u32(smem + s * L.kslot);
    const int bytes = min(part_rows, half - j * part_rows) * D;
    const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(k_scale) + row * page * 2;
    const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(v_scale) + row * page * 2;
    if (scales && !bulk_scales) {  // page % 8 != 0: the scale vectors are not 16-byte aligned
      for (int c = 0; c < 2 * page; c += 4) {
        cp_async4(dst + L.kbytes + c, ksrc + c);
        cp_async4(dst + L.kbytes + L.sbytes + c, vsrc + c);
      }
      cp_async_arrive(bar);  // before the expect_tx: the phase cannot end without them
    }
    mbar_expect_tx(bar, bytes + (scales && bulk_scales ? 4 * page : 0));
    bulk_g2s(dst, k_pool + row * page_bytes + (size_t)j * part_rows * D, bytes, bar);
    if (scales && bulk_scales) {
      bulk_g2s(dst + L.kbytes, ksrc, 2 * page, bar);
      bulk_g2s(dst + L.kbytes + L.sbytes, vsrc, 2 * page, bar);
    }
  };
  auto issue_v = [&](int i, int j) {
    const int s = i % stages;
    const uint32_t bar = bar0 + 8 * (stages + s);
    const int bytes = min(part_rows, half - j * part_rows) * D;
    mbar_expect_tx(bar, bytes);
    bulk_g2s(smem_u32(smem + L.off_v + s * L.kbytes), v_pool + page_row(i) * page_bytes + (size_t)j * part_rows * D,
             bytes, bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * stages + 1; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (!PARTS)
      for (int i = 0; i < mine && i < stages; ++i) {
        issue_k(i, 0, true);
        issue_v(i, 0);
      }
    if (ring) {
      const uint32_t bar = bar0 + 16 * stages;
      mbar_expect_tx(bar, 2 * C * D);
      bulk_g2s(smem_u32(smem + L.off_ring), stage_k + ring_cell0 * D, C * D, bar);
      bulk_g2s(smem_u32(smem + L.off_ring + C * D), stage_v + ring_cell0 * D, C * D, bar);
    }
  }

  // q -> int8 once per (head, row), one warp a head (padding heads zero)
  for (int g = warp; g < G16; g += warps) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (g < G) {
      const uint2 raw = *reinterpret_cast<const uint2*>(q_rows + g * D + 4 * lane);
      const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[0] = f0.x, v[1] = f0.y, v[2] = f1.x, v[3] = f1.y;
    }
    const float qa = warp_max(fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
    const float qs = fmaxf(qa, 1e-8f) * (1.0f / 127.0f);
    uint32_t packed4 = 0;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float r = rintf(v[j] / qs);
      sq += r;
      packed4 |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xFFu) << (8 * j);
    }
    sq = warp_sum(sq);
    *reinterpret_cast<uint32_t*>(q8 + g * D + 4 * lane) = packed4;
    if (C > 0) *reinterpret_cast<float4*>(qf + g * (D + 4) + 4 * lane) = make_float4(v[0], v[1], v[2], v[3]);
    if (lane == 0) {
      qscale_sh[g] = qs;
      sumq8_sh[g] = KV4_BIAS * sq;
    }
  }
  if (ring)
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      rks[c] = __bfloat162float(stage_ks[ring_cell0 + c]) * scale;
      rvs[c] = __bfloat162float(stage_vs[ring_cell0 + c]);
      rseg[c] = stage_seg[(size_t)slot * C + c] != 0;
    }
  __syncthreads();  // barriers initialised, q8 and the ring's scales visible

  // the scores' B fragments: k position 4 tig + j of step ks is d = 32 tig + 8 ks + j, 16 + 4 tig + j
  // is d = 32 tig + 8 ks + 4 + j (the order in which a thread holds its row's 32 bytes)
  uint32_t qb[NT][4][2];
  float hqs[NT][2], hsq[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint2 w = *reinterpret_cast<const uint2*>(q8 + (nt * 8 + gid) * D + 32 * tig + 8 * ks);
      qb[nt][ks][0] = w.x;
      qb[nt][ks][1] = w.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      hqs[nt][e] = qscale_sh[nt * 8 + 2 * tig + e];
      hsq[nt][e] = sumq8_sh[nt * 8 + 2 * tig + e];
    }
  }

  float m_run[NT][2], l_w[NT][2], acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) m_run[nt][e] = NEG_INF, l_w[nt][e] = 0.f;
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][x][c] = 0.f;
  }

  // ---- a page's phases on this warp's blocks of the part of the page at byte row row0 (0 where the
  // page is one part), K rows and both scale vectors at kbuf, V rows at vbuf ----
  float sc[BPW][NT][8];
  float mx[NT][2], m_new[NT][2], psum[NT][2], pmax[NT][2], pscale[NT][2], inv_pscale[NT][2], sp[NT][2];
  int ai[NT][8][4];
  // cell of fragment value c (0-3 lo, 4-7 hi) of block ib, or -1 where it holds none
  auto cell_of = [&](int row0, int cells, int ib, int c) {
    const int row = row0 + (warp + ib * warps) * SPLIT_ROWS + gid + 8 * ((c >> 1) & 1);
    const int cell = c < 4 ? row : half + row;
    return row < half && cell < cells ? cell : -1;
  };
  auto has_block = [&](int row0, int ib) { return row0 / SPLIT_ROWS + warp + ib * warps < nblk; };
  // the per-value work below is branch-free (a dead cell reads cell 0's scale and its score is -1e30,
  // whose exp is 0), so the compiler overlaps the values' loads and arithmetic
  // scores ((q8 . nibbles - 8 sum q8) qscale) (k_scale scale) into sc, their row max into mx
  auto scores = [&](const unsigned char* kbuf, int row0, int cells) {
    const __nv_bfloat16* ksc = reinterpret_cast<const __nv_bfloat16*>(kbuf + L.kbytes);
#pragma unroll
    for (int ib = 0; ib < BPW; ++ib) {
      if (!has_block(row0, ib)) break;
      const int b = warp + ib * warps;
      uint32_t w[2][8];  // rows r0 + gid and r0 + gid + 8: bytes 32 tig .. 32 tig + 31
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const unsigned char* rowp = kbuf + (b * SPLIT_ROWS + gid + 8 * rr) * D + 32 * tig;
        const int first = 16 * (gid & 1);  // odd rows read their second half first: no bank conflict
        const uint4 x0 = *reinterpret_cast<const uint4*>(rowp + first);
        const uint4 x1 = *reinterpret_cast<const uint4*>(rowp + 16 - first);
        const uint4 lo = (gid & 1) ? x1 : x0, hi = (gid & 1) ? x0 : x1;
        w[rr][0] = lo.x, w[rr][1] = lo.y, w[rr][2] = lo.z, w[rr][3] = lo.w;
        w[rr][4] = hi.x, w[rr][5] = hi.y, w[rr][6] = hi.z, w[rr][7] = hi.w;
      }
      int cl[NT][4], ch[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) cl[nt][c] = ch[nt][c] = 0;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t a_lo[4] = {w[0][2 * ks] & NIB, w[1][2 * ks] & NIB, w[0][2 * ks + 1] & NIB,
                                  w[1][2 * ks + 1] & NIB};
        const uint32_t a_hi[4] = {(w[0][2 * ks] >> 4) & NIB, (w[1][2 * ks] >> 4) & NIB,
                                  (w[0][2 * ks + 1] >> 4) & NIB, (w[1][2 * ks + 1] >> 4) & NIB};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_s8(cl[nt], a_lo, qb[nt][ks][0], qb[nt][ks][1]);
          mma_s8(ch[nt], a_hi, qb[nt][ks][0], qb[nt][ks][1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int e = c & 1;
          const int cell = cell_of(row0, cells, ib, c);
          const float dot = static_cast<float>(c < 4 ? cl[nt][c] : ch[nt][c - 4]);
          const float ks = __bfloat162float(ksc[cell < 0 ? 0 : cell]) * scale;
          const float sv = cell >= 0 ? ((dot - hsq[nt][e]) * hqs[nt][e]) * ks : NEG_INF;
          sc[ib][nt][c] = sv;
          mx[nt][e] = fmaxf(mx[nt][e], sv);
        }
      }
    }
  };
  // the page's row max across warps (a CTA barrier) -> m_new
  auto exchange_max = [&]() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[nt][e] = gid_max(mx[nt][e]);
        if (gid == 0) red_a[warp * G16 + nt * 8 + 2 * tig + e] = mx[nt][e];
      }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mp = NEG_INF;
#pragma unroll
        for (int w2 = 0; w2 < SPLIT_MAX_WARPS; ++w2)
          if (w2 < warps) mp = fmaxf(mp, red_a[w2 * G16 + nt * 8 + 2 * tig + e]);
        m_new[nt][e] = fmaxf(m_run[nt][e], mp);
        psum[nt][e] = pmax[nt][e] = 0.f;
      }
  };
  // weights p = exp(s - m_new) into psum, p * v_scale into sc and its row max into pmax
  auto weights = [&](const unsigned char* kbuf, int row0, int cells) {
    const __nv_bfloat16* vsc = reinterpret_cast<const __nv_bfloat16*>(kbuf + L.kbytes + L.sbytes);
#pragma unroll
    for (int ib = 0; ib < BPW; ++ib) {
      if (!has_block(row0, ib)) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int e = c & 1;
          const int cell = cell_of(row0, cells, ib, c);
          float p = __expf(sc[ib][nt][c] - m_new[nt][e]);  // 0 for a dead cell
          psum[nt][e] += p;
          p *= __bfloat162float(vsc[cell < 0 ? 0 : cell]);
          pmax[nt][e] = fmaxf(pmax[nt][e], p);
          sc[ib][nt][c] = p;
        }
    }
  };
  // the row max of p * v_scale across warps (a CTA barrier) -> pscale; (m, l, acc) move to m_new
  auto exchange_pmax = [&]() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        psum[nt][e] = gid_sum(psum[nt][e]);
        pmax[nt][e] = gid_max(pmax[nt][e]);
        if (gid == 0) red_b[warp * G16 + nt * 8 + 2 * tig + e] = pmax[nt][e];
      }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pm = 0.f;
#pragma unroll
        for (int w2 = 0; w2 < SPLIT_MAX_WARPS; ++w2)
          if (w2 < warps) pm = fmaxf(pm, red_b[w2 * G16 + nt * 8 + 2 * tig + e]);
        pscale[nt][e] = fmaxf(pm, 1e-20f) * (1.0f / 127.0f);
        inv_pscale[nt][e] = 1.0f / pscale[nt][e];
        const float corr = __expf(m_run[nt][e] - m_new[nt][e]);
        l_w[nt][e] = l_w[nt][e] * corr + psum[nt][e];
        m_run[nt][e] = m_new[nt][e];
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[nt][x][e] *= corr, acc[nt][x][2 + e] *= corr;
        sp[nt][e] = 0.f;
      }
  };
  // int8 weights, one scale per row per page, into this warp's records (their sum into sp);
  // record (block, head): byte k < 16 is the lo cell of row r0 + k, byte 16 + k its hi cell
  auto quantize = [&](int row0) {
#pragma unroll
    for (int ib = 0; ib < BPW; ++ib) {
      if (!has_block(row0, ib)) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned char* rec = p8 + (ib * NT + nt) * 8 * 32;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int e = c & 1;
          const float r = rintf(sc[ib][nt][c] * inv_pscale[nt][e]);
          sp[nt][e] += r;
          rec[(2 * tig + e) * 32 + (c >> 2) * 16 + gid + 8 * ((c >> 1) & 1)] =
              static_cast<unsigned char>(static_cast<int>(r));
        }
      }
    }
  };
  auto zero_ai = [&]() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int c = 0; c < 4; ++c) ai[nt][x][c] = 0;
  };
  // p . v into ai: this thread's rows r0 + 4 tig + j, columns 16 gid .. 16 gid + 15
  auto pv = [&](const unsigned char* vbuf, int row0) {
#pragma unroll
    for (int ib = 0; ib < BPW; ++ib) {
      if (!has_block(row0, ib)) break;
      const int b = warp + ib * warps;
      uint32_t b_lo[NT], b_hi[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* rec = p8 + ((ib * NT + nt) * 8 + gid) * 32;
        b_lo[nt] = *reinterpret_cast<const uint32_t*>(rec + 4 * tig);
        b_hi[nt] = *reinterpret_cast<const uint32_t*>(rec + 16 + 4 * tig);
      }
      const unsigned char* vrow = vbuf + (b * SPLIT_ROWS + 4 * tig) * D + 16 * gid;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        uint32_t rw[4], cw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) rw[j] = *reinterpret_cast<const uint32_t*>(vrow + j * D + 4 * qq);
        transpose4x4(rw, cw);  // cw[c]: rows r0 + 4 tig .. + 3 of column 16 gid + 4 qq + c
#pragma unroll
        for (int xx = 0; xx < 2; ++xx) {
          // M row gid: column 16 gid + 2x, row gid + 8: 16 gid + 2x + 1 (x = 2 qq + xx)
          const uint32_t a[4] = {cw[2 * xx] & NIB, cw[2 * xx + 1] & NIB, (cw[2 * xx] >> 4) & NIB,
                                 (cw[2 * xx + 1] >> 4) & NIB};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_s8(ai[nt][2 * qq + xx], a, b_lo[nt], b_hi[nt]);
        }
      }
    }
  };
  // acc += (int dot - 8 sum p8) pscale, per warp (its cells)
  auto finish_page = [&]() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) sp[nt][e] = gid_sum(sp[nt][e]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = c & 1;
          acc[nt][x][c] += (static_cast<float>(ai[nt][x][c]) - KV4_BIAS * sp[nt][e]) * pscale[nt][e];
        }
  };
  auto reset_max = [&]() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mx[nt][0] = mx[nt][1] = NEG_INF;
  };

  if constexpr (!PARTS) {
    for (int i = 0; i < mine; ++i) {
      const int cells = min(page, len - (rank + i * n_split) * page);  // valid cells of the page, >= 1
      const int s = i % stages, par = (i / stages) & 1;
      const unsigned char* kbuf = smem + s * L.kslot;
      mbar_wait(bar0 + 8 * s, par);
      reset_max();
      scores(kbuf, 0, cells);
      exchange_max();  // the first barrier
      if (threadIdx.x == 0 && i >= 1 && i - 1 + stages < mine) issue_v(i - 1 + stages, 0);  // page i-1's V slot is free
      weights(kbuf, 0, cells);
      exchange_pmax();  // the second barrier
      if (threadIdx.x == 0 && i + stages < mine) issue_k(i + stages, 0, true);  // this page's K slot is free
      quantize(0);
      __syncwarp();
      mbar_wait(bar0 + 8 * (stages + s), par);
      zero_ai();
      pv(smem + L.off_v + s * L.kbytes, 0);
      finish_page();
    }
  } else {
    // a page of more byte rows than the CTA's blocks cover: its parts of part_rows rows pass one K
    // slot and one V slot three times -- the scores' row max; the weights' sum and row max; the int8
    // weights and p . v -- the scores computed anew in each pass (the same arithmetic, so the same
    // values), no copy in flight while a part is computed
    const int nparts = (half + part_rows - 1) / part_rows;
    int kn = 0, vn = 0;  // phases of the K and the V slot's barrier waited for
    for (int i = 0; i < mine; ++i) {
      const int cells = min(page, len - (rank + i * n_split) * page);
      const int live = min(nparts, (cells + part_rows - 1) / part_rows);  // parts holding a valid cell
      reset_max();
      for (int pass = 0; pass < 3; ++pass) {
        if (pass == 2) zero_ai();
        for (int j = 0; j < live; ++j) {
          if (threadIdx.x == 0) {
            issue_k(i, j, pass == 0 && j == 0);
            if (pass == 2) issue_v(i, j);
          }
          mbar_wait(bar0, kn++ & 1);
          scores(smem, j * part_rows, cells);
          if (pass > 0) weights(smem, j * part_rows, cells);
          if (pass == 2) {
            quantize(j * part_rows);
            __syncwarp();
            mbar_wait(bar0 + 8, vn++ & 1);
            pv(smem + L.off_v, j * part_rows);
          }
          __syncthreads();  // every warp is done with both slots: the next part may land
        }
        if (pass == 0) exchange_max();
        if (pass == 1) exchange_pmax();
      }
      finish_page();
    }
  }

  if (ring) {
    // ---- the staged block: the float q, bf16 weights (the TPU helper's arithmetic) ----
    mbar_wait(bar0 + 16 * stages, 0);
    const signed char* rk = reinterpret_cast<const signed char*>(smem + L.off_ring);
    const signed char* rv = rk + C * D;
    // scores: a thread a (cell, head) dot over the 128 columns, four partial sums (q rows padded to
    // D + 4 floats: the heads of one cell read distinct banks)
    for (int pr = threadIdx.x; pr < C * G16; pr += blockDim.x) {
      const int c = pr / G16, g = pr % G16;
      const float4* q4 = reinterpret_cast<const float4*>(qf + g * (D + 4));
      const char4* k4 = reinterpret_cast<const char4*>(rk + c * D);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int j = 0; j < D / 4; j += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 qv = q4[j + u];
          const char4 kv = k4[j + u];
          part[u] = fmaf(qv.x, static_cast<float>(kv.x), part[u]);
          part[u] = fmaf(qv.y, static_cast<float>(kv.y), part[u]);
          part[u] = fmaf(qv.z, static_cast<float>(kv.z), part[u]);
          part[u] = fmaf(qv.w, static_cast<float>(kv.w), part[u]);
        }
      }
      const float dot = (part[0] + part[1]) + (part[2] + part[3]);
      sring[g * C + c] = rseg[c] ? dot * rks[c] : NEG_INF;
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* srow = sring + (nt * 8 + 2 * tig + e) * C;
        float mr = NEG_INF;
        for (int c = 0; c < C; ++c) mr = fmaxf(mr, srow[c]);
        const float mn = fmaxf(m_run[nt][e], mr);
        const float corr = expf(m_run[nt][e] - mn);
        float ps = 0.f;
        for (int c = warp; c < C; c += warps) ps += rseg[c] ? expf(srow[c] - mn) : 0.f;
        l_w[nt][e] = l_w[nt][e] * corr + ps;
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[nt][x][e] *= corr, acc[nt][x][2 + e] *= corr;
        m_run[nt][e] = mn;
      }
    for (int c = warp; c < C; c += warps) {  // p . v of this warp's cells
      if (!rseg[c]) continue;
      float pb[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sring[(nt * 8 + 2 * tig + e) * C + c] - m_run[nt][e]) * rvs[c];
          pb[nt][e] = __bfloat162float(__float2bfloat16(p));  // the p . v dot takes bf16 weights
        }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const char2 v2 = *reinterpret_cast<const char2*>(rv + c * D + 16 * gid + 2 * x);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[nt][x][e] = fmaf(pb[nt][e], static_cast<float>(v2.x), acc[nt][x][e]);
            acc[nt][x][2 + e] = fmaf(pb[nt][e], static_cast<float>(v2.y), acc[nt][x][2 + e]);
          }
      }
    }
  }

  split_end<NT>(smem, red_a, fin_m, m_run, l_w, acc, o, m_out, l_out, slot, h, Hq, G);
}

// ---- modes 0, 1, 3: the split kernel of bf16, int8 and int4 (widened-nibble) pools ----
//
// Replaces `_paged_kernel` (:113, bf16 and int8 pools) and `_paged_kernel_int4` (:225) of
// spatialthinker_tpu/ops/paged_attention.py, with their `_staged_block_update` (:59). Bounded by
// bytes: at most 4 G operations a value, far under the card's operations-per-byte balance; what the
// design does about latency is below (parts in flight in a slot ring, the split over a cluster).
//
// #9's plan, cluster, copies and combine, with bf16 products. CTA (rank, slot, kv head), grid (n, S,
// Hkv), the n CTAs of a (slot, kv head) a cluster, rank r taking the slot's pages r, r + n, ... and
// the last rank the staging ring after them; the ranks meet in rank order (`split_end`).
//
// The unit a CTA computes at a time is a PART of a page: `warps` blocks of 16 pool rows (a bf16 or an
// int8 cell, or a packed byte row of two int4 cells), warp w taking block w. A page of more rows
// passes in several parts, one streaming pass with an online-softmax step per part (the running max
// carried across parts). Why a part and not a page: a bf16 row is 4x an int4 row, so at the shipped
// page of 1,024 cells a bf16 page's K and V are 512 KB and an int8 page's 256 KB, over the 227 KB a
// CTA may hold; a part of 8 x 16 rows is 32 KB of bf16 K (16 KB int8, 16 KB packed = 256 int4
// cells), so a ring of slots fits beside it. Each part arrives by bulk asynchronous copies
// (`cp.async.bulk`, completion on mbarriers): its live K rows with its scales (mode 1 the part's
// cells', mode 3 its two runs of lo and hi cells where a page is a multiple of 16 cells, else the
// page's vectors; 4-byte `cp.async`s where a page is not a multiple of 8 cells) into a K slot, its V
// rows into a V slot, `stages` slot pairs deep. Part u has one CTA barrier, which carries its row
// maxima; after it thread 0 refills part u's K slot and part u - 1's V slot. Every warp keeps the
// CTA's running max, so the weights of a part are rounded to bf16 against the running max after that
// part (the plain versions: after the page; only the weights' rounding and the exp move).
//
// Both products on `mma.sync` m16n8k16 bf16 in fp32 (the bf16 arithmetic of the TPU kernels and the
// plain versions; 4 G operations a value are far under the card's operations-per-byte balance, so
// tensor cores only keep the dots off the FMA pipe of a latency-bound loop):
//   scores S^T = K q^T with the block's 16 rows as M and up to 8 query heads as N (two N tiles for
//     G > 8). A thread holds 32 d-values of its rows gid, gid + 8 (bf16 rows: 64 bytes in four
//     16-byte loads whose order is rotated by tig and gid, so a quarter warp's loads meet in no bank;
//     int8 and packed rows: 32 bytes, odd rows their second half first, as #9), and q's B fragments
//     follow the same d order. Mode 1 converts the int8 values to bf16 in registers, mode 3 widens
//     the unsigned nibbles u = value + 8 of a byte row (cells r and r + page/2: two products), both
//     exact;
//   the weights P^T reach the B layout of the next product by `movmatrix.trans`;
//   O^T += V^T P^T with 16 columns of d as M and the block's cells as K: a thread loads rows 2 tig,
//     2 tig + 1, 2 tig + 8, 2 tig + 9 at columns 16 gid .. 16 gid + 15 and pairs them in registers
//     (bf16 rows past the live ones are zeroed there: a stale slot may hold any bits).
// Arithmetic per cell, as the plain versions: mode 0 scores q . k times scale; mode 1 times
// k_scale * scale, the weights times v_scale; mode 3 (q . u - 8 sum q) times k_scale * scale, the
// weights times v_scale rounded to bf16 for p . u, debiased by -8 sum(p v_scale) of the UNROUNDED fp32
// weights. The staged block is one more unit (or several, of warps x 16 ring cells) on the last rank:
// the ring's K and V cells (bf16 in mode 0, int8 with scales in modes 1 and 3) arrive by one bulk
// copy each at the kernel's start and pass the same products in the bf16 / int8 format.
// What it does not do yet: a warp takes one block of a part, so each part's barrier and its chain (K
// wait, scores, exp, p . v) serve 16 rows a warp (#9 takes up to 4 blocks a warp); the int4 nibbles
// are widened by 4-5 ALU operations a pair; the V loads of a quarter warp meet in 2 (bf16) or 4
// (int8, int4) banks.

constexpr int FMT_BF16 = 0, FMT_INT8 = 1, FMT_INT4 = 2;  // a unit's rows: bf16 cells, int8 cells, packed nibbles

template <int F>
struct Fmt {
  static constexpr int value = F;
};

// bytes i of words x and y (int8) as a bf16 pair, x's in the low half: exact, and off the conversion
// pipe (a quarter of the ALU rate), which bounds the int8 modes' loop otherwise. 1.5 * 2^23 + b is
// exact in fp32 and minus 1.5 * 2^23 it is b; an int8 value's fp32 bits end in 16 zero bits, so its
// bf16 is their top half.
__device__ __forceinline__ uint32_t i8_pair_alu(uint32_t x, uint32_t y, int i) {
  const float fx = __int_as_float(0x4B400000 + static_cast<int8_t>(x >> (8 * i))) - 12582912.0f;
  const float fy = __int_as_float(0x4B400000 + static_cast<int8_t>(y >> (8 * i))) - 12582912.0f;
  return __byte_perm(__float_as_uint(fx), __float_as_uint(fy), 0x7632);
}

// NT: N tiles of 8 heads (1: G <= 8, 2: G <= 16). Fragments (gid = lane / 4, tig = lane % 4): scores of
// the block's rows gid, gid + 8 (mode 3: their lo and hi cells) and heads nt * 8 + 2 tig (+ 1); outputs
// of columns 16 gid + 2 x (+ 1), the same heads.
// TWO: the plan leaves shared memory for two CTAs an SM (at most SMEM_BUDGET_TWO bytes), so registers
// are bounded to hold two as well (G <= 8 only: 128 a thread, a few bytes of spills); a CTA alone on
// its SM keeps its registers.
template <int MODE, int NT, bool TWO>
__global__ void __launch_bounds__(SPLIT_MAX_WARPS * 32, TWO ? 2 : 1)
paged_kernel_split(const __nv_bfloat16* __restrict__ q, const unsigned char* __restrict__ k_pool,
                   const unsigned char* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ page_table,
                   const int* __restrict__ lengths, __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ l_out, const unsigned char* __restrict__ stage_k,
                   const unsigned char* __restrict__ stage_v, const __nv_bfloat16* __restrict__ stage_ks,
                   const __nv_bfloat16* __restrict__ stage_vs, const int* __restrict__ stage_seg, int Hq, int Hkv,
                   int page, int p_max, int C, float scale, int stages) {
  static_assert(MODE == MODE_BF16 || MODE == MODE_INT8 || MODE == MODE_INT4, "mode 2 runs paged_kernel_int4_i8");
  constexpr int G16 = 8 * NT;
  constexpr bool PACKED = MODE == MODE_INT4;
  constexpr int RB = MODE == MODE_BF16 ? 2 * D : D;  // bytes of a pool row and of a ring row
  constexpr int POOL_FMT = MODE == MODE_BF16 ? FMT_BF16 : MODE == MODE_INT8 ? FMT_INT8 : FMT_INT4;
  constexpr int RING_FMT = MODE == MODE_BF16 ? FMT_BF16 : FMT_INT8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_split = gridDim.x, rank = blockIdx.x, slot = blockIdx.y, h = blockIdx.z;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int G = Hq / Hkv;
  const int half = page >> 1;
  const int rows = PACKED ? half : page;     // pool rows of a page
  const int part_rows = warps * SPLIT_ROWS;  // pool rows of a unit
  const SplitLayout L = split_layout(MODE, NT, page, C, warps, 1, stages);
  const int cap = L.kbytes / RB;             // rows a slot holds
  const bool runs = MODE == MODE_INT8 || page % 16 == 0;  // a slot's scales are the part's (else the page's)
  float* red = reinterpret_cast<float*>(smem + L.off_red);  // [parity][warp][head]
  float* fin_m = reinterpret_cast<float*>(smem + L.off_stat);
  float* rks = reinterpret_cast<float*>(smem + L.off_rs);
  float* rvs = rks + C;
  int* rseg = reinterpret_cast<int*>(rvs + C);
  unsigned char* ring_k = smem + L.off_ring;
  unsigned char* ring_v = ring_k + round_up(C, SPLIT_ROWS) * RB;
  // K slot s: bar0 + 8 s; V slot s: bar0 + 8 (stages + s); the ring: bar0 + 16 stages
  const uint32_t bar0 = smem_u32(smem + L.off_bar);

  const int first_page = threadIdx.x == 0 && rank < p_max ? page_table[(size_t)slot * p_max + rank] : 0;
  const int len = lengths[slot];
  const int npg = min((len + page - 1) / page, p_max);
  const int mine = npg > rank ? (npg - rank + n_split - 1) / n_split : 0;  // pages rank, rank + n, ...
  const bool ring = C > 0 && rank == n_split - 1;
  const size_t ring_cell0 = ((size_t)slot * Hkv + h) * C;
  auto cells_of = [&](int i) { return min(page, len - (rank + i * n_split) * page); };  // >= 1
  auto live_rows = [&](int cells) { return PACKED ? min(half, cells) : cells; };      // rows with a valid cell
  // page id of this rank's i-th page (i >= 1: a load whose value is used a page later)
  auto page_id = [&](int i) { return i < mine ? page_table[(size_t)slot * p_max + rank + i * n_split] : 0; };

  // thread 0: the K rows (with the scales) or the V rows of the next part into its slot; a cursor
  // (part j of this rank's page i, units issued, the page's (page, kv head) row, the next page's id)
  // each, K ahead of V
  struct Cursor {
    int i, j, n;
    size_t row;
    int next;
  };
  Cursor kc{0, 0, 0, (size_t)first_page * Hkv + h, 0}, vc = kc;
  auto issue = [&](Cursor& cur, bool k_side) {
    if (cur.i >= mine) return;
    const int s = cur.n % stages;
    const size_t row = cur.row;
    const int lr = live_rows(cells_of(cur.i));
    const int row0 = cur.j * part_rows, n = min(part_rows, lr - row0);
    const size_t src = (row * rows + row0) * (size_t)RB;
    if (k_side) {
      const uint32_t kbar = bar0 + 8 * s, kdst = smem_u32(smem + s * L.kslot);
      int scale_tx = 0;
      if (MODE != MODE_BF16) {
        // runs: the part's cells from row0 (mode 3 also from half + row0); else the page's vectors
        const int n_runs = runs ? (PACKED ? 2 : 1) : 1;
        const int run_bytes = runs ? 2 * min(part_rows, rows - row0) : 2 * page;
        const bool bulk = page % 8 == 0;  // 16-byte aligned runs
        auto from = [&](int vec, int r) {
          return reinterpret_cast<const unsigned char*>((vec ? v_scale : k_scale) + row * page +
                                                         (runs ? r * half + row0 : 0));
        };
        auto to = [&](int vec, int r) { return kdst + L.kbytes + vec * L.sbytes + r * cap * 2; };
        if (!bulk) {
          for (int vec = 0; vec < 2; ++vec)
            for (int r = 0; r < n_runs; ++r)
              for (int c = 0; c < run_bytes; c += 4) cp_async4(to(vec, r) + c, from(vec, r) + c);
          cp_async_arrive(kbar);  // before the expect_tx: the phase cannot end without them
        }
        scale_tx = bulk ? 2 * n_runs * run_bytes : 0;
        mbar_expect_tx(kbar, n * RB + scale_tx);
        if (bulk)
          for (int vec = 0; vec < 2; ++vec)
            for (int r = 0; r < n_runs; ++r) bulk_g2s(to(vec, r), from(vec, r), run_bytes, kbar);
      } else {
        mbar_expect_tx(kbar, n * RB);
      }
      bulk_g2s(kdst, k_pool + src, n * RB, kbar);
    } else {
      const uint32_t vbar = bar0 + 8 * (stages + s);
      mbar_expect_tx(vbar, n * RB);
      bulk_g2s(smem_u32(smem + L.off_v + s * L.kbytes), v_pool + src, n * RB, vbar);
    }
    ++cur.n;
    if (++cur.j * part_rows >= lr) {
      cur.j = 0, ++cur.i;
      cur.row = (size_t)cur.next * Hkv + h;
      cur.next = page_id(cur.i + 1);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * stages + 1; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    kc.next = vc.next = page_id(1);
    for (int k = 0; k < stages; ++k) issue(kc, true), issue(vc, false);
    if (ring) {
      const uint32_t bar = bar0 + 16 * stages;
      mbar_expect_tx(bar, 2 * C * RB);
      bulk_g2s(smem_u32(ring_k), stage_k + ring_cell0 * RB, C * RB, bar);
      bulk_g2s(smem_u32(ring_v), stage_v + ring_cell0 * RB, C * RB, bar);
    }
  }
  if (ring)
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      rks[c] = MODE == MODE_BF16 ? scale : __bfloat162float(stage_ks[ring_cell0 + c]) * scale;
      rvs[c] = MODE == MODE_BF16 ? 1.f : __bfloat162float(stage_vs[ring_cell0 + c]);
      rseg[c] = stage_seg[(size_t)slot * C + c] != 0;
    }

  // q as the scores' B fragments (padding heads zero): k positions 2 tig (+ 1) of step ks are d0 + 0, 1,
  // k 2 tig + 8 (+ 1) are d0 + 2, 3 -- the d order in which a thread holds its K rows (below)
  uint32_t qb[NT][8][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int head = nt * 8 + gid;
    const __nv_bfloat16* qh = q + ((size_t)slot * Hq + (size_t)h * G + (head < G ? head : 0)) * D;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int d0 = MODE == MODE_BF16 ? 32 * tig + 8 * (((ks >> 1) + 2 * (tig >> 1)) & 3) + 4 * (ks & 1)
                                       : 32 * tig + 4 * ks;
      uint2 w = make_uint2(0u, 0u);
      if (head < G) w = *reinterpret_cast<const uint2*>(qh + d0);
      qb[nt][ks][0] = w.x, qb[nt][ks][1] = w.y;
    }
  }
  // mode 3: 8 sum(q) of heads nt * 8 + 2 tig + e (a head's 128 columns are its four lanes' fragments)
  float hsq[NT][2] = {};
  if (MODE == MODE_INT4) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float sq = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sq += __uint_as_float(qb[nt][ks][j] << 16) + __uint_as_float(qb[nt][ks][j] & 0xFFFF0000u);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
#pragma unroll
      for (int e = 0; e < 2; ++e) hsq[nt][e] = KV4_BIAS * __shfl_sync(0xffffffffu, sq, 4 * (2 * tig + e));
    }
  }
  __syncthreads();  // barriers initialised, the ring's scales visible

  // the CTA's running max; this thread's l and (mode 3) sum of p * v_scale, summed over lanes at the end
  float m_run[NT][2], l_run[NT][2], sv_run[NT][2], acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) m_run[nt][e] = NEG_INF, l_run[nt][e] = 0.f, sv_run[nt][e] = 0.f;
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][x][c] = 0.f;
  }

  // One unit u: this warp's block of the n live rows at kbuf / vbuf (rows row0 + 16 warp .. of the
  // page, or of the ring), `cells` valid cells of the page; a pool unit waits for its V at vbar.
  auto unit = [&](auto fmt, const unsigned char* kbuf, const unsigned char* vbuf, int u, int row0, int n, int cells,
                  uint32_t vbar, int par, bool is_ring) {
    constexpr int F = decltype(fmt)::value;
    constexpr int HF = F == FMT_INT4 ? 2 : 1;  // cells a row: lo (and hi)
    const int rw = warp * SPLIT_ROWS;          // the block's first row in the unit
    const bool has = rw < n;
    // this thread's score cells: rows rw + gid + 8 rr, half hf; validity and scale factors
    bool ok[HF][2];
    float kf[HF][2], vf[HF][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rw + gid + 8 * rr;
#pragma unroll
      for (int hf = 0; hf < HF; ++hf) {
        bool v;
        float a = 0.f, b = 0.f;
        if (is_ring) {
          v = r < n && rseg[row0 + r];
          if (v) a = rks[row0 + r], b = rvs[row0 + r];
        } else {
          v = r < n && (hf == 0 || half + row0 + r < cells);
          if (MODE == MODE_BF16) {
            a = scale, b = 1.f;
          } else if (v) {
            const __nv_bfloat16* kss = reinterpret_cast<const __nv_bfloat16*>(kbuf + L.kbytes);
            const __nv_bfloat16* vss = reinterpret_cast<const __nv_bfloat16*>(kbuf + L.kbytes + L.sbytes);
            const int j = runs ? hf * cap + r : hf * half + row0 + r;
            a = __bfloat162float(kss[j]) * scale, b = __bfloat162float(vss[j]);
          }
        }
        ok[hf][rr] = v, kf[hf][rr] = a, vf[hf][rr] = b;
      }
    }

    // ---- scores into sc[nt][hf * 4 + 2 rr + e] (-1e30 where no valid cell), their row max into mx ----
    float sc[NT][4 * HF], mx[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[nt][0] = mx[nt][1] = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4 * HF; ++c) sc[nt][c] = NEG_INF;
    }
    if (has) {
      float dot[HF][NT][4];
#pragma unroll
      for (int hf = 0; hf < HF; ++hf)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[hf][nt][c] = 0.f;
      if constexpr (F == FMT_BF16) {
        // 64 bytes (d 32 tig ..) of rows gid, gid + 8: load c takes chunk (c + 2 (tig >> 1) + (gid & 1)) & 3,
        // so a quarter warp's 16-byte loads fall in 8 distinct bank groups; logical chunk k is physical
        // chunk (k + 2 (tig >> 1)) & 3 (q's d order), held in kr[rr][k]
        const int odd = gid & 1, rot = 2 * (tig >> 1);
        uint4 kr[2][4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const unsigned char* rowp = kbuf + (rw + gid + 8 * rr) * RB + 64 * tig;
          uint4 x[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) x[c] = *reinterpret_cast<const uint4*>(rowp + 16 * ((c + rot + odd) & 3));
#pragma unroll
          for (int k = 0; k < 4; ++k) kr[rr][k] = odd ? x[(k + 3) & 3] : x[k];
        }
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int c = ks >> 1, hh = 2 * (ks & 1);
          const uint32_t a[4] = {word(kr[0][c], hh), word(kr[1][c], hh), word(kr[0][c], hh + 1),
                                 word(kr[1][c], hh + 1)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(dot[0][nt], a, qb[nt][ks][0], qb[nt][ks][1]);
        }
      } else {
        // bytes 32 tig .. 32 tig + 31 of rows gid, gid + 8 (odd rows read their second half first: no bank conflict)
        uint32_t w[2][8];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const unsigned char* rowp = kbuf + (rw + gid + 8 * rr) * RB + 32 * tig;
          const int first = 16 * (gid & 1);
          const uint4 x0 = *reinterpret_cast<const uint4*>(rowp + first);
          const uint4 x1 = *reinterpret_cast<const uint4*>(rowp + 16 - first);
          const uint4 lo = (gid & 1) ? x1 : x0, hi = (gid & 1) ? x0 : x1;
          w[rr][0] = lo.x, w[rr][1] = lo.y, w[rr][2] = lo.z, w[rr][3] = lo.w;
          w[rr][4] = hi.x, w[rr][5] = hi.y, w[rr][6] = hi.z, w[rr][7] = hi.w;
        }
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const uint32_t w0 = w[0][ks], w1 = w[1][ks];
#pragma unroll
          for (int hf = 0; hf < HF; ++hf) {
            uint32_t a[4];
            if constexpr (F == FMT_INT8) {
              a[0] = i8_pair_alu(w0, w0 >> 8, 0), a[1] = i8_pair_alu(w1, w1 >> 8, 0);
              a[2] = i8_pair_alu(w0, w0 >> 8, 2), a[3] = i8_pair_alu(w1, w1 >> 8, 2);
            } else {
              a[0] = nib_pair(w0, w0, 0, 1, hf), a[1] = nib_pair(w1, w1, 0, 1, hf);
              a[2] = nib_pair(w0, w0, 2, 3, hf), a[3] = nib_pair(w1, w1, 2, 3, hf);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(dot[hf][nt], a, qb[nt][ks][0], qb[nt][ks][1]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < HF; ++hf)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = c & 1, rr = c >> 1;
            const float d = F == FMT_INT4 ? dot[hf][nt][c] - hsq[nt][e] : dot[hf][nt][c];
            const float sv = ok[hf][rr] ? d * kf[hf][rr] : NEG_INF;
            sc[nt][hf * 4 + c] = sv;
            mx[nt][e] = fmaxf(mx[nt][e], sv);
          }
    }

    // ---- the unit's row max across warps: the CTA barrier; then part u's K slot and part u - 1's V
    // slot are free ----
    float* red_u = red + (u & 1) * warps * G16;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float mg = gid_max(mx[nt][e]);
        if (gid == 0) red_u[warp * G16 + nt * 8 + 2 * tig + e] = mg;
      }
    __syncthreads();
    if (!is_ring && threadIdx.x == 0) {
      issue(kc, true);              // part u + stages
      if (u >= 1) issue(vc, false);  // part u - 1 + stages
    }

    // ---- weights: p = exp(s - m_new); l, acc (and mode 3's sum of p * v_scale) move to m_new ----
    uint32_t pb[HF][NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float pw[HF][2][2];  // [hf][rr][e]: p * v_scale
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mp = NEG_INF;
#pragma unroll
        for (int w2 = 0; w2 < SPLIT_MAX_WARPS; ++w2)
          if (w2 < warps) mp = fmaxf(mp, red_u[w2 * G16 + nt * 8 + 2 * tig + e]);
        const float m_new = fmaxf(m_run[nt][e], mp);
        const float corr = __expf(m_run[nt][e] - m_new);
        float ps = 0.f, sv = 0.f;
#pragma unroll
        for (int hf = 0; hf < HF; ++hf)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float p = ok[hf][rr] ? __expf(sc[nt][hf * 4 + 2 * rr + e] - m_new) : 0.f;
            ps += p;
            pw[hf][rr][e] = p * vf[hf][rr];
            sv += pw[hf][rr][e];
          }
        l_run[nt][e] = l_run[nt][e] * corr + ps;
        if (F == FMT_INT4) sv_run[nt][e] = sv_run[nt][e] * corr + sv;
        else sv_run[nt][e] *= corr;
        m_run[nt][e] = m_new;
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[nt][x][e] *= corr, acc[nt][x][2 + e] *= corr;
      }
      // the p . v product takes bf16 weights, as the TPU kernels do; (cell, head) -> (head, cell)
      if (has)
#pragma unroll
        for (int hf = 0; hf < HF; ++hf)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) pb[hf][nt][rr] = movmatrix_trans(pack_bf16(pw[hf][rr][0], pw[hf][rr][1]));
    }

    // ---- O^T += V^T P^T: 8 M tiles of 16 columns, K = the block's 16 rows (mode 3: twice) ----
    if (!is_ring) mbar_wait(vbar, par);
    if (has) {
      // rows rw + 2 tig, + 1, + 8, + 9 (the k of this thread's B values)
      auto vrow = [&](int j) { return vbuf + (rw + 2 * tig + (j & 1) + 8 * (j >> 1)) * RB; };
      if constexpr (F == FMT_BF16) {
        // columns 16 gid .. 16 gid + 15: two 16-byte chunks a row, odd tig the second first (2 banks a quarter)
        uint4 vr[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = rw + 2 * tig + (j & 1) + 8 * (j >> 1);
          const bool live = r < n && (!is_ring || rseg[row0 + r]);
          const int t = tig & 1;
          const uint4 x0 = *reinterpret_cast<const uint4*>(vrow(j) + 32 * gid + 16 * t);
          const uint4 x1 = *reinterpret_cast<const uint4*>(vrow(j) + 32 * gid + 16 * (1 - t));
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          vr[j][0] = live ? (t ? x1 : x0) : zero;
          vr[j][1] = live ? (t ? x0 : x1) : zero;
        }
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          // word x: columns 16 gid + 2 x (low half, M row gid) and + 1 (high half, M row gid + 8)
          const uint32_t w0 = word(vr[0][x >> 2], x & 3), w1 = word(vr[1][x >> 2], x & 3);
          const uint32_t w2 = word(vr[2][x >> 2], x & 3), w3 = word(vr[3][x >> 2], x & 3);
          const uint32_t a[4] = {__byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632), __byte_perm(w2, w3, 0x5410),
                                 __byte_perm(w2, w3, 0x7632)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][x], a, pb[0][nt][0], pb[0][nt][1]);
        }
      } else {
        uint4 vr[4];  // columns 16 gid .. 16 gid + 15 of the four rows
#pragma unroll
        for (int j = 0; j < 4; ++j) vr[j] = *reinterpret_cast<const uint4*>(vrow(j) + 16 * gid);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          // M row gid: column 16 gid + 2 x, row gid + 8: 16 gid + 2 x + 1 (bytes 2 x, 2 x + 1 of the chunk)
          const int wi = x >> 1, sh = 2 * (x & 1);
          const uint32_t x0 = word(vr[0], wi), x1 = word(vr[1], wi), x2 = word(vr[2], wi), x3 = word(vr[3], wi);
#pragma unroll
          for (int hf = 0; hf < HF; ++hf) {
            uint32_t a[4];
            if constexpr (F == FMT_INT8) {
              a[0] = i8_pair_alu(x0, x1, sh), a[1] = i8_pair_alu(x0, x1, sh + 1);
              a[2] = i8_pair_alu(x2, x3, sh), a[3] = i8_pair_alu(x2, x3, sh + 1);
            } else {
              a[0] = nib_pair(x0, x1, sh, 4 + sh, hf), a[1] = nib_pair(x0, x1, sh + 1, 5 + sh, hf);
              a[2] = nib_pair(x2, x3, sh, 4 + sh, hf), a[3] = nib_pair(x2, x3, sh + 1, 5 + sh, hf);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][x], a, pb[hf][nt][0], pb[hf][nt][1]);
          }
        }
      }
    }
  };

  int u = 0;  // units walked
  for (int i = 0; i < mine; ++i) {
    const int cells = cells_of(i), lr = live_rows(cells);
    for (int row0 = 0; row0 < lr; row0 += part_rows, ++u) {
      const int s = u % stages, par = (u / stages) & 1;
      mbar_wait(bar0 + 8 * s, par);
      unit(Fmt<POOL_FMT>{}, smem + s * L.kslot, smem + L.off_v + s * L.kbytes, u, row0, min(part_rows, lr - row0),
           cells, bar0 + 8 * (stages + s), par, false);
    }
  }
  if (ring) {
    mbar_wait(bar0 + 16 * stages, 0);
    for (int r0 = 0; r0 < C; r0 += part_rows, ++u)
      unit(Fmt<RING_FMT>{}, ring_k + r0 * RB, ring_v + r0 * RB, u, r0, min(part_rows, C - r0), 0, 0u, 0, true);
  }

  float l_w[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_w[nt][e] = gid_sum(l_run[nt][e]);
      if (MODE == MODE_INT4) {  // the -8 debias with the unrounded weights, per warp (its cells)
        const float sv = KV4_BIAS * gid_sum(sv_run[nt][e]);
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[nt][x][e] -= sv, acc[nt][x][2 + e] -= sv;
      }
    }
  split_end<NT>(smem, red, fin_m, m_run, l_w, acc, o, m_out, l_out, slot, h, Hq, G);
}

// The ring's layer bases, by the caller (all null when C = 0).
struct Staged {
  const unsigned char* k;
  const unsigned char* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int* seg;
  int C;
};

// The split kernel's plan (ops/paged_attention.py `paged_plan`).
struct SplitPlan {
  int n_split, warps, stages, bpw;
};

// One launch of a split kernel: mode 2's `paged_kernel_int4_i8<NT, BPW, PARTS>`, or the other modes'
// `paged_kernel_split<MODE, NT, TWO>` (BPW 1; PARTS stands for TWO).
template <int MODE, int NT, int BPW, bool PARTS>
int launch_split(const void* q, const unsigned char* kp, const unsigned char* vp, const void* ks,
                 const void* vs, const void* table, const void* lengths, void* o, void* m, void* l,
                 const Staged& st, int S, int Hq, int Hkv, int page, int p_max, float scale,
                 const SplitPlan& p, int smem, cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (MODE == MODE_INT4_I8)
      return paged_kernel_int4_i8<NT, BPW, PARTS>;
    else
      return paged_kernel_split<MODE, NT, PARTS>;
  }();
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
  config.gridDim = dim3(p.n_split, S, Hkv);
  config.blockDim = dim3(32 * p.warps, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  if (p.n_split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
  return static_cast<int>(cudaLaunchKernelEx(
      &config, kernel, static_cast<const __nv_bfloat16*>(q), kp, vp, static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(m), static_cast<float*>(l), st.k, st.v, st.ks, st.vs,
      st.seg, Hq, Hkv, page, p_max, st.C, scale, p.stages));
}

// Whether a mode-2 page passes in parts: more blocks than the CTA's warps x blocks a warp.
bool split_parts(int page, const SplitPlan& p) {
  return p.warps * p.bpw < (page / 2 + SPLIT_ROWS - 1) / SPLIT_ROWS;
}

// Bytes of dynamic shared memory of a split plan of `mode`; -1 for a plan its kernel cannot run (mode
// 2: a page in parts needs 4 blocks a warp and one K and one V slot; modes 0, 1, 3 take one block a
// warp of each part, any ring depth).
int split_smem(int mode, int G, int page, int C, const SplitPlan& p) {
  if (mode < MODE_BF16 || mode > MODE_INT4 || G < 1 || G > GMAX || page < 2 || page % 2 != 0 || C < 0 ||
      p.n_split < 1 || p.n_split > SPLIT_MAX_CLUSTER || p.warps < 1 || p.warps > SPLIT_MAX_WARPS ||
      p.stages < 1 || p.stages > SPLIT_MAX_STAGES)
    return -1;
  if (mode == MODE_INT4_I8 ? !(p.bpw == 1 || p.bpw == 2 || p.bpw == 4) ||
                                 (split_parts(page, p) && (p.bpw != 4 || p.stages != 1))
                           : p.bpw != 1)
    return -1;
  return split_layout(mode, G <= 8 ? 1 : 2, page, C, p.warps, p.bpw, p.stages).total;
}

}  // namespace

// Dynamic shared memory (bytes) of a mode's split kernel under a plan
// (cluster size, warps a CTA, ring slots, blocks a warp of a page); -1 for
// a plan it cannot run.
extern "C" int st_paged_split_smem(int mode, int G, int page, int C, int n_split, int warps, int stages, int bpw) {
  return split_smem(mode, G, page, C, SplitPlan{n_split, warps, stages, bpw});
}

// `page` is in token cells for every mode. The staging ring (C > 0): stage_k,
// stage_v (L, S, Hkv, C, 128) bf16 (mode 0) | int8 (modes 1-3), stage_ks,
// stage_vs (L, S, Hkv, C) bf16 (modes 1-3), stage_seg (S, C) int32; with
// C = 0 they are not read. Every mode runs its split kernel under the plan
// (n_split, warps, stages, bpw) from ops/paged_attention.py `paged_plan` and
// refuses (cudaErrorInvalidValue, before anything launches) a plan it cannot
// run. Returns the launch's error (0 = launched).
extern "C" int st_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* page_table, const void* lengths, void* o, void* m,
                                  void* l, const void* stage_k, const void* stage_v,
                                  const void* stage_ks, const void* stage_vs, const void* stage_seg,
                                  int S, int Hq, int Hkv, int page, int D_, int p_max,
                                  int n_pages, int layer, int mode, int C, int n_split, int warps,
                                  int stages, int bpw, float scale, void* stream) {
  if (D_ != D || Hq % Hkv != 0 || Hq / Hkv > GMAX || page < 2 || page % 2 != 0 || S < 1 ||
      S > 65535 || Hkv > 65535 || mode < MODE_BF16 || mode > MODE_INT4 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitPlan plan{n_split, warps, stages, bpw};
  const int smem = split_smem(mode, Hq / Hkv, page, C, plan);
  if (smem < 0 || smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = packed(mode) ? page / 2 : page;
  const size_t row_bytes = mode == MODE_BF16 ? D * 2 : D;
  const size_t layer_bytes = (size_t)n_pages * Hkv * rows * row_bytes;
  const unsigned char* kp = static_cast<const unsigned char*>(k_pool) + layer * layer_bytes;
  const unsigned char* vp = static_cast<const unsigned char*>(v_pool) + layer * layer_bytes;
  const size_t layer_cells = (size_t)n_pages * Hkv * page;
  const __nv_bfloat16* ks = nullptr;
  const __nv_bfloat16* vs = nullptr;
  if (mode != MODE_BF16) {
    ks = static_cast<const __nv_bfloat16*>(k_scale) + layer * layer_cells;
    vs = static_cast<const __nv_bfloat16*>(v_scale) + layer * layer_cells;
  }
  Staged st{nullptr, nullptr, nullptr, nullptr, nullptr, C};
  if (C > 0) {
    const size_t ring_cells = (size_t)S * Hkv * C;  // cells of one layer of the ring
    const size_t cell_bytes = mode == MODE_BF16 ? D * 2 : D;
    st.k = static_cast<const unsigned char*>(stage_k) + layer * ring_cells * cell_bytes;
    st.v = static_cast<const unsigned char*>(stage_v) + layer * ring_cells * cell_bytes;
    if (mode != MODE_BF16) {
      st.ks = static_cast<const __nv_bfloat16*>(stage_ks) + layer * ring_cells;
      st.vs = static_cast<const __nv_bfloat16*>(stage_vs) + layer * ring_cells;
    }
    st.seg = static_cast<const int*>(stage_seg);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = Hq / Hkv <= 8 ? 1 : 2;
  if (mode == MODE_INT4_I8) {
    const bool parts = split_parts(page, plan);
#define SPLIT_LAUNCH(NT, BPW, PARTS)                                                                          \
  if (nt == NT && bpw == BPW && parts == PARTS)                                                               \
    return launch_split<MODE_INT4_I8, NT, BPW, PARTS>(q, kp, vp, ks, vs, page_table, lengths, o, m, l, st, S, Hq, \
                                                      Hkv, page, p_max, scale, plan, smem, s);
    SPLIT_LAUNCH(1, 1, false) SPLIT_LAUNCH(1, 2, false) SPLIT_LAUNCH(1, 4, false) SPLIT_LAUNCH(1, 4, true)
    SPLIT_LAUNCH(2, 1, false) SPLIT_LAUNCH(2, 2, false) SPLIT_LAUNCH(2, 4, false) SPLIT_LAUNCH(2, 4, true)
#undef SPLIT_LAUNCH
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool two = nt == 1 && smem <= SMEM_BUDGET_TWO;
#define POOL_LAUNCH(MODE, NT, TWO)                                                                            \
  if (mode == MODE && nt == NT && two == TWO)                                                                 \
    return launch_split<MODE, NT, 1, TWO>(q, kp, vp, ks, vs, page_table, lengths, o, m, l, st, S, Hq, Hkv, page,  \
                                          p_max, scale, plan, smem, s);
  POOL_LAUNCH(MODE_BF16, 1, false) POOL_LAUNCH(MODE_BF16, 1, true) POOL_LAUNCH(MODE_BF16, 2, false)
  POOL_LAUNCH(MODE_INT8, 1, false) POOL_LAUNCH(MODE_INT8, 1, true) POOL_LAUNCH(MODE_INT8, 2, false)
  POOL_LAUNCH(MODE_INT4, 1, false) POOL_LAUNCH(MODE_INT4, 1, true) POOL_LAUNCH(MODE_INT4, 2, false)
#undef POOL_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
