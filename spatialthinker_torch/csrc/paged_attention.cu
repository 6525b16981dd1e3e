// Paged decode attention for Hopper (sm_90a): one new query token per slot
// attends the slot's pages of a global KV page pool through its page table.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/paged_attention.py:
//   `_paged_kernel`          bf16 pools, and int8 pools with per-cell scales
//                            (modes 0 and 1 here);
//   `_paged_kernel_int4_i8`  int4 pools, both dots on int8 operands (mode 2);
//   `_paged_kernel_int4`     int4 pools, dots on the unsigned nibbles widened
//                            to floating point (mode 3).
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
// What bounds it on the H100: bytes — a step reads every live cell once
// (0.5 to 2 bytes per value) and does 4 * G operations per value, far under
// the card's operations-per-byte balance. Design: one CTA per (slot, kv head)
// so all G query heads share every byte read (G = 8 for the 3B model, 7 for
// the 7B, any G <= 16 unpadded; any even page size). Each page goes through
// three phases that keep the whole page's scores in shared memory (the
// per-page weight quantization of mode 2 needs the page's row max before the
// p . v dot): A) stage K in 64-row tiles with 16-byte loads and form scores
// (fp32 FMAs in modes 0/1, `__dp4a` on packed nibbles in mode 2), B) one warp
// per head does the online-softmax update, C) stage V tiles and accumulate
// one output column per thread (mode 2: four byte rows packed per `__dp4a`).
// What it does not do yet: tensor-core dots (mma/wgmma s8), cp.async or TMA
// double buffering, and a split of long slots across CTAs; with S * Hkv CTAs
// of 4 warps a small batch fills only part of the 132 SMs.
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
// update is the TPU helper's: scores = bf16(q) . bf16(k) in fp32 — the float
// q also in mode 2, never its int8 copy — times (k_scale * scale) with
// scales, else times scale; dead cells masked; m, l and acc corrected;
// weights times v_scale rounded to bf16 for the p . v dot. It reuses the
// pool loop's staging tile and score buffer, and its three phases are those
// of modes 0/1 over one "page" of C cells. With the ring fused, the returned
// (m, l) are final: the caller has nothing left to merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head dim (text heads of the 3B/7B presets)
constexpr int THREADS = 128;  // 4 warps; phase C maps one thread per column
constexpr int GMAX = 16;      // largest query group per kv head
constexpr int TILE = 64;      // pool rows staged per tile
constexpr int KV4_BIAS = 8;
constexpr float NEG_INF = -1e30f;
constexpr int MODE_BF16 = 0, MODE_INT8 = 1, MODE_INT4_I8 = 2, MODE_INT4 = 3;
constexpr int MAX_SMEM = 232448;  // bytes a block may opt in to on sm_90

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// both int4 modes read packed pages: byte row r = cells r and r + page/2
__host__ __device__ inline bool packed(int mode) { return mode == MODE_INT4_I8 || mode == MODE_INT4; }

// Shared-memory plan, computed alike on host and device.
struct Layout {
  int pg;          // padded score slots per page (int4: two padded halves)
  int half_pad;    // int4: padded byte rows per page
  int cp;          // padded score slots of the staged block (0: no ring)
  int tile_stride; // bytes per staged row (padded against bank conflicts)
  int off_s, off_ksc, off_vsc, off_p8, off_q, off_qf, off_seg, off_small, total;
};

__host__ __device__ inline Layout make_layout(int mode, int G, int page, int C) {
  Layout L;
  if (packed(mode)) {
    L.half_pad = round_up(page / 2, 4);
    L.pg = 2 * L.half_pad;
  } else {
    L.half_pad = 0;
    L.pg = round_up(page, 4);
  }
  L.cp = round_up(C, 4);
  const int slots = L.pg > L.cp ? L.pg : L.cp;  // the score buffer serves pages and the ring
  L.tile_stride = mode == MODE_BF16 ? (D + 8) * 2 : D + 16;
  int off = TILE * L.tile_stride;
  L.off_s = off;          off += G * slots * 4;
  L.off_ksc = off;        off += slots * 4;
  L.off_vsc = off;        off += slots * 4;
  L.off_p8 = off;         off += mode == MODE_INT4_I8 ? round_up(G * L.pg, 16) : 0;
  L.off_q = off;          off += mode == MODE_INT4_I8 ? GMAX * D : GMAX * D * 4;
  // the staged block's float q: mode 2 keeps only the int8 q above
  L.off_qf = mode == MODE_INT4_I8 && C > 0 ? off : L.off_q;
  off += mode == MODE_INT4_I8 && C > 0 ? GMAX * D * 4 : 0;
  L.off_seg = off;        off += L.cp * 4;
  L.off_small = off;      off += 8 * GMAX * 4;
  L.total = off;
  return L;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage `n_rows` (<= TILE) rows of `row_bytes` bytes into the padded tile;
// rows beyond n_rows are zero-filled.
__device__ __forceinline__ void load_tile(const unsigned char* __restrict__ src, int row_bytes,
                                          int n_rows, unsigned char* tile, int tile_stride) {
  const int chunks = row_bytes / 16;
  for (int i = threadIdx.x; i < TILE * chunks; i += THREADS) {
    const int r = i / chunks;
    const int c = (i % chunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)r * row_bytes + c);
    *reinterpret_cast<uint4*>(tile + r * tile_stride + c) = val;
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const __nv_bfloat16* __restrict__ q,
             const unsigned char* __restrict__ k_pool,  // layer base
             const unsigned char* __restrict__ v_pool,
             const __nv_bfloat16* __restrict__ k_scale,  // layer base (modes 1, 2)
             const __nv_bfloat16* __restrict__ v_scale,
             const int* __restrict__ page_table, const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
             const unsigned char* __restrict__ stage_k,  // layer base of the ring (C > 0)
             const unsigned char* __restrict__ stage_v,
             const __nv_bfloat16* __restrict__ stage_ks,  // layer base (quantized pools)
             const __nv_bfloat16* __restrict__ stage_vs,
             const int* __restrict__ stage_seg,
             int Hq, int Hkv, int page, int p_max, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = Hq / Hkv;
  const Layout L = make_layout(MODE, G, page, C);
  unsigned char* tile = smem;
  float* s_sh = reinterpret_cast<float*>(smem + L.off_s);
  float* ksc = reinterpret_cast<float*>(smem + L.off_ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.off_vsc);
  signed char* p8 = reinterpret_cast<signed char*>(smem + L.off_p8);
  float* qs = reinterpret_cast<float*>(smem + L.off_q);               // modes 0, 1, 3
  signed char* q8 = reinterpret_cast<signed char*>(smem + L.off_q);   // mode 2
  float* qf = reinterpret_cast<float*>(smem + L.off_qf);              // staged block, every mode
  int* seg_sh = reinterpret_cast<int*>(smem + L.off_seg);
  float* small = reinterpret_cast<float*>(smem + L.off_small);
  float* m_sh = small;
  float* l_sh = small + GMAX;
  float* corr_sh = small + 2 * GMAX;
  float* qscale_sh = small + 3 * GMAX;
  float* sumq_sh = small + 4 * GMAX;
  float* pscale_sh = small + 5 * GMAX;
  float* sump_sh = small + 6 * GMAX;

  const int slot = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int PG = L.pg;
  const int half = page / 2;
  const int half_pad = L.half_pad;
  // pool rows per page and bytes per row
  constexpr bool PACKED = MODE == MODE_INT4_I8 || MODE == MODE_INT4;
  const int rows_per_page = PACKED ? half : page;
  const int row_bytes = MODE == MODE_BF16 ? D * 2 : D;

  const __nv_bfloat16* qg = q + ((size_t)slot * Hq + (size_t)h * G) * D;
  if (tid < GMAX) {
    m_sh[tid] = NEG_INF;
    l_sh[tid] = 0.f;
  }
  if (MODE == MODE_INT4_I8 && C > 0)
    for (int i = tid; i < G * D; i += THREADS) qf[i] = __bfloat162float(qg[i]);
  if (MODE == MODE_INT4_I8) {
    // q -> int8 once, one scale per (head, row)
    for (int g = warp; g < G; g += THREADS / 32) {
      float qf[D / 32];
      float qa = 0.f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        qf[j] = __bfloat162float(qg[(size_t)g * D + lane + 32 * j]);
        qa = fmaxf(qa, fabsf(qf[j]));
      }
      qa = warp_max(qa);
      const float qscale = fmaxf(qa, 1e-8f) * (1.0f / 127.0f);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const float r = rintf(qf[j] / qscale);
        q8[g * D + lane + 32 * j] = static_cast<signed char>(static_cast<int>(r));
        sq += r;
      }
      sq = warp_sum(sq);
      if (lane == 0) {
        qscale_sh[g] = qscale;
        sumq_sh[g] = sq;
      }
    }
  } else {
    for (int i = tid; i < G * D; i += THREADS) qs[i] = __bfloat162float(qg[i]);
    if (MODE == MODE_INT4) {  // sum(q) per head, for the -8 debias of the scores
      for (int g = warp; g < G; g += THREADS / 32) {
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) sq += __bfloat162float(qg[(size_t)g * D + lane + 32 * j]);
        sq = warp_sum(sq);
        if (lane == 0) sumq_sh[g] = sq;
      }
    }
  }

  float acc[GMAX];  // column d = tid of every head's output
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;

  const int len = lengths[slot];
  const int n_pg = min((len + page - 1) / page, p_max);
  const int tok = tid % TILE;   // phase A: one staged row per thread ...
  const int part = tid / TILE;  // ... modes 0/1: heads part, part+2, ..; int4: nibble half

  for (int pi = 0; pi < n_pg; ++pi) {
    const int page_id = page_table[(size_t)slot * p_max + pi];
    const size_t page_row = (size_t)page_id * Hkv + h;
    const unsigned char* kp = k_pool + page_row * (size_t)rows_per_page * row_bytes;
    const unsigned char* vp = v_pool + page_row * (size_t)rows_per_page * row_bytes;
    const int cells = min(page, len - pi * page);  // valid cells of this page, >= 1
    // pool rows that hold a valid cell
    const int rows = PACKED ? min(half, cells) : cells;

    __syncthreads();  // previous page fully consumed (and q / state initialised)
    if (MODE != MODE_BF16) {
      const __nv_bfloat16* ksp = k_scale + page_row * (size_t)page;
      const __nv_bfloat16* vsp = v_scale + page_row * (size_t)page;
      for (int c = tid; c < cells; c += THREADS) {
        const int j = PACKED ? (c >= half ? half_pad + c - half : c) : c;
        ksc[j] = __bfloat162float(ksp[c]) * scale;
        vsc[j] = __bfloat162float(vsp[c]);
      }
    }

    // ---- phase A: scores of the whole page into s_sh ----
    for (int t0 = 0; t0 < rows; t0 += TILE) {
      __syncthreads();  // tile free, scales visible
      load_tile(kp + (size_t)t0 * row_bytes, row_bytes, min(TILE, rows - t0), tile, L.tile_stride);
      __syncthreads();
      const unsigned char* krow = tile + tok * L.tile_stride;
      const int r = t0 + tok;
      if (MODE == MODE_INT4_I8) {
        int iacc[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) iacc[g] = 0;
        const int* q8w = reinterpret_cast<const int*>(q8);
#pragma unroll
        for (int c = 0; c < D; c += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
          const unsigned int w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int nib = static_cast<int>((part ? (w4[e] >> 4) : w4[e]) & 0x0F0F0F0Fu);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
              if (g < G) iacc[g] = __dp4a(nib, q8w[g * (D / 4) + c / 4 + e], iacc[g]);
          }
        }
        if (r < half) {
          const int j = part * half_pad + r;
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
              float s = (static_cast<float>(iacc[g]) - KV4_BIAS * sumq_sh[g]) * qscale_sh[g];
              s_sh[g * PG + j] = s * ksc[j];
            }
          }
        }
      } else if (MODE == MODE_INT4) {
        float sc[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) sc[g] = 0.f;
#pragma unroll 2
        for (int c = 0; c < D; c += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
          const unsigned char* b16 = reinterpret_cast<const unsigned char*>(&raw);
          float kf[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) kf[e] = static_cast<float>((b16[e] >> (4 * part)) & 15);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
#pragma unroll
              for (int e = 0; e < 16; ++e) sc[g] = fmaf(qs[g * D + c + e], kf[e], sc[g]);
            }
          }
        }
        if (r < half) {
          const int j = part * half_pad + r;
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) s_sh[g * PG + j] = (sc[g] - KV4_BIAS * sumq_sh[g]) * ksc[j];
        }
      } else {
        float sc[GMAX / 2];
#pragma unroll
        for (int j = 0; j < GMAX / 2; ++j) sc[j] = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 8) {
          float kf[8];
          if (MODE == MODE_BF16) {
            const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 2);
            const __nv_bfloat16* k8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[e] = __bfloat162float(k8[e]);
          } else {
            const uint2 raw = *reinterpret_cast<const uint2*>(krow + c);
            const signed char* k8 = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[e] = static_cast<float>(k8[e]);
          }
#pragma unroll
          for (int j = 0; j < GMAX / 2; ++j) {
            const int g = part + 2 * j;
            if (g < G) {
#pragma unroll
              for (int e = 0; e < 8; ++e) sc[j] = fmaf(qs[g * D + c + e], kf[e], sc[j]);
            }
          }
        }
        if (r < page) {
#pragma unroll
          for (int j = 0; j < GMAX / 2; ++j) {
            const int g = part + 2 * j;
            if (g < G) s_sh[g * PG + r] = MODE == MODE_INT8 ? sc[j] * ksc[r] : sc[j] * scale;
          }
        }
      }
    }
    __syncthreads();

    // ---- phase B: online softmax of the page, one warp per head ----
    for (int g = warp; g < G; g += THREADS / 32) {
      float* srow = s_sh + g * PG;
      const float m_prev = m_sh[g];
      float mx = NEG_INF;
      for (int j = lane; j < PG; j += 32) {
        bool valid;
        if (PACKED) {
          const int hf = j >= half_pad;
          const int r = j - hf * half_pad;
          valid = r < half && hf * half + r < cells;
        } else {
          valid = j < cells;
        }
        if (valid) mx = fmaxf(mx, srow[j]);
      }
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f, pmax = 0.f, pvsum = 0.f;
      for (int j = lane; j < PG; j += 32) {
        bool valid;
        if (PACKED) {
          const int hf = j >= half_pad;
          const int r = j - hf * half_pad;
          valid = r < half && hf * half + r < cells;
        } else {
          valid = j < cells;
        }
        float p = 0.f;
        if (valid) {
          p = expf(srow[j] - m_new);
          psum += p;
          if (MODE != MODE_BF16) p *= vsc[j];
          pvsum += p;  // mode 3 debiases with the unrounded weights
          // modes 0/1/3: the p . v dot takes bf16 weights, as the TPU kernel does
          if (MODE != MODE_INT4_I8) p = __bfloat162float(__float2bfloat16(p));
        }
        srow[j] = p;
        pmax = fmaxf(pmax, p);
      }
      const float corr = expf(m_prev - m_new);
      psum = warp_sum(psum);
      if (MODE == MODE_INT4_I8) {
        // weights -> int8, one scale per row per page
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
        load_tile(vp + (size_t)t0 * row_bytes, row_bytes, min(TILE, rows - t0), tile, L.tile_stride);
        __syncthreads();
        const int n4 = min(TILE, round_up(rows - t0, 4));
        for (int t = 0; t < n4; t += 4) {
          const unsigned int w = static_cast<unsigned int>(tile[(t + 0) * L.tile_stride + tid]) |
                                 static_cast<unsigned int>(tile[(t + 1) * L.tile_stride + tid]) << 8 |
                                 static_cast<unsigned int>(tile[(t + 2) * L.tile_stride + tid]) << 16 |
                                 static_cast<unsigned int>(tile[(t + 3) * L.tile_stride + tid]) << 24;
          const int lo = static_cast<int>(w & 0x0F0F0F0Fu);
          const int hi = static_cast<int>((w >> 4) & 0x0F0F0F0Fu);
          const int wl = (t0 + t) / 4;               // low-half cells t0+t .. +3
          const int wh = (half_pad + t0 + t) / 4;    // their high-half partners
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
    } else if (MODE == MODE_INT4) {
      for (int t0 = 0; t0 < rows; t0 += TILE) {
        __syncthreads();
        load_tile(vp + (size_t)t0 * row_bytes, row_bytes, min(TILE, rows - t0), tile, L.tile_stride);
        __syncthreads();
        const int nt = min(TILE, rows - t0);
        for (int t = 0; t < nt; ++t) {
          const unsigned int byte = tile[t * L.tile_stride + tid];
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
    } else {
      for (int t0 = 0; t0 < rows; t0 += TILE) {
        __syncthreads();
        load_tile(vp + (size_t)t0 * row_bytes, row_bytes, min(TILE, rows - t0), tile, L.tile_stride);
        __syncthreads();
        const int nt = min(TILE, rows - t0);
        for (int t = 0; t < nt; ++t) {
          float vv;
          if (MODE == MODE_BF16)
            vv = __bfloat162float(
                reinterpret_cast<const __nv_bfloat16*>(tile + t * L.tile_stride)[tid]);
          else
            vv = static_cast<float>(reinterpret_cast<const signed char*>(tile + t * L.tile_stride)[tid]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) acc[g] = fmaf(s_sh[g * PG + t0 + t], vv, acc[g]);
        }
      }
    }
  }

  if (C > 0) {
    // ---- the staged block: one more online-softmax update over the ring ----
    constexpr int st_row_bytes = MODE == MODE_BF16 ? D * 2 : D;  // bf16 | int8 cells
    const int CP = L.cp;
    const size_t cell0 = ((size_t)slot * Hkv + h) * C;  // the (slot, head)'s first cell
    const unsigned char* skp = stage_k + cell0 * st_row_bytes;
    const unsigned char* svp = stage_v + cell0 * st_row_bytes;
    __syncthreads();  // the pages' last phase C is done with the tile and the scores
    for (int c = tid; c < C; c += THREADS) {
      seg_sh[c] = stage_seg[(size_t)slot * C + c] != 0;
      if (MODE != MODE_BF16) {
        ksc[c] = __bfloat162float(stage_ks[cell0 + c]) * scale;
        vsc[c] = __bfloat162float(stage_vs[cell0 + c]);
      }
    }
    for (int t0 = 0; t0 < C; t0 += TILE) {  // phase A: scores from the float q
      __syncthreads();
      load_tile(skp + (size_t)t0 * st_row_bytes, st_row_bytes, min(TILE, C - t0), tile, L.tile_stride);
      __syncthreads();
      const unsigned char* krow = tile + tok * L.tile_stride;
      float sc[GMAX / 2];
#pragma unroll
      for (int j = 0; j < GMAX / 2; ++j) sc[j] = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float kf[8];
        if (MODE == MODE_BF16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 2);
          const __nv_bfloat16* k8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = __bfloat162float(k8[e]);
        } else {
          const uint2 raw = *reinterpret_cast<const uint2*>(krow + c);
          const signed char* k8 = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = static_cast<float>(k8[e]);
        }
#pragma unroll
        for (int j = 0; j < GMAX / 2; ++j) {
          const int g = part + 2 * j;
          if (g < G) {
#pragma unroll
            for (int e = 0; e < 8; ++e) sc[j] = fmaf(qf[g * D + c + e], kf[e], sc[j]);
          }
        }
      }
      const int r = t0 + tok;
      if (r < C) {
#pragma unroll
        for (int j = 0; j < GMAX / 2; ++j) {
          const int g = part + 2 * j;
          if (g < G) s_sh[g * CP + r] = MODE == MODE_BF16 ? sc[j] * scale : sc[j] * ksc[r];
        }
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {  // phase B, one warp per head
      float* srow = s_sh + g * CP;
      const float m_prev = m_sh[g];
      float mx = NEG_INF;
      for (int j = lane; j < C; j += 32)
        if (seg_sh[j]) mx = fmaxf(mx, srow[j]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
      for (int j = lane; j < C; j += 32) {
        float p = 0.f;
        if (seg_sh[j]) {
          p = expf(srow[j] - m_new);
          psum += p;
          if (MODE != MODE_BF16) p *= vsc[j];
          p = __bfloat162float(__float2bfloat16(p));  // the p . v dot takes bf16 weights
        }
        srow[j] = p;
      }
      const float corr = expf(m_prev - m_new);
      psum = warp_sum(psum);
      if (lane == 0) {
        l_sh[g] = l_sh[g] * corr + psum;
        m_sh[g] = m_new;
        corr_sh[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GMAX; ++g)  // phase C: p . v, one output column per thread
      if (g < G) acc[g] *= corr_sh[g];
    for (int t0 = 0; t0 < C; t0 += TILE) {
      __syncthreads();
      load_tile(svp + (size_t)t0 * st_row_bytes, st_row_bytes, min(TILE, C - t0), tile, L.tile_stride);
      __syncthreads();
      const int nt = min(TILE, C - t0);
      for (int t = 0; t < nt; ++t) {
        const float vv = MODE == MODE_BF16
            ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(tile + t * L.tile_stride)[tid])
            : static_cast<float>(reinterpret_cast<const signed char*>(tile + t * L.tile_stride)[tid]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) acc[g] = fmaf(s_sh[g * CP + t0 + t], vv, acc[g]);
      }
    }
  }

  __syncthreads();
  __nv_bfloat16* og = o + ((size_t)slot * Hq + (size_t)h * G) * D;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const float l = l_sh[g];
      og[(size_t)g * D + tid] = __float2bfloat16(acc[g] / (l == 0.f ? 1.f : l));
    }
  }
  if (tid < G) {
    m_out[(size_t)slot * Hq + h * G + tid] = m_sh[tid];
    l_out[(size_t)slot * Hq + h * G + tid] = l_sh[tid];
  }
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

template <int MODE>
int launch(const void* q, const unsigned char* kp, const unsigned char* vp, const void* ks,
           const void* vs, const void* table, const void* lengths, void* o, void* m, void* l,
           const Staged& st, int S, int Hq, int Hkv, int page, int p_max, float scale, int smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(paged_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_kernel<MODE><<<S * Hkv, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kp, vp, static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(o), static_cast<float*>(m),
      static_cast<float*>(l), st.k, st.v, st.ks, st.vs, st.seg, Hq, Hkv, page, p_max, st.C, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory (bytes) one CTA needs; the wrapper refuses shapes
// beyond the card's opt-in limit before launching. C = staged ring cells (0: none).
extern "C" int st_paged_attention_smem(int mode, int G, int page, int C) {
  return make_layout(mode, G, page, C).total;
}

// `page` is in token cells for every mode. The staging ring (C > 0): stage_k,
// stage_v (L, S, Hkv, C, 128) bf16 (mode 0) | int8 (modes 1-3), stage_ks,
// stage_vs (L, S, Hkv, C) bf16 (modes 1-3), stage_seg (S, C) int32; with
// C = 0 they are not read. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int st_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* page_table, const void* lengths, void* o, void* m,
                                  void* l, const void* stage_k, const void* stage_v,
                                  const void* stage_ks, const void* stage_vs, const void* stage_seg,
                                  int S, int Hq, int Hkv, int page, int D_, int p_max,
                                  int n_pages, int layer, int mode, int C, float scale, void* stream) {
  if (D_ != D || Hq % Hkv != 0 || Hq / Hkv > GMAX || page < 2 || page % 2 != 0 || S < 1 ||
      mode < MODE_BF16 || mode > MODE_INT4 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = make_layout(mode, Hq / Hkv, page, C).total;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
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
  switch (mode) {
    case MODE_BF16:
      return launch<MODE_BF16>(q, kp, vp, ks, vs, page_table, lengths, o, m, l, st, S, Hq, Hkv,
                               page, p_max, scale, smem, s);
    case MODE_INT8:
      return launch<MODE_INT8>(q, kp, vp, ks, vs, page_table, lengths, o, m, l, st, S, Hq, Hkv,
                               page, p_max, scale, smem, s);
    case MODE_INT4_I8:
      return launch<MODE_INT4_I8>(q, kp, vp, ks, vs, page_table, lengths, o, m, l, st, S, Hq, Hkv,
                                  page, p_max, scale, smem, s);
    default:
      return launch<MODE_INT4>(q, kp, vp, ks, vs, page_table, lengths, o, m, l, st, S, Hq, Hkv,
                               page, p_max, scale, smem, s);
  }
}
