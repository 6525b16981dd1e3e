// Decode attention for Hopper (sm_90a): one new query token per sequence
// against one layer of the stacked dense KV cache.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/decode_attention.py
// (launched by `_pallas_decode`):
//   `_decode_kernel`          bf16 cache (mode 0, `decode_kernel` below) and
//                             int8 cache with per-cell scales (mode 1);
//   `_decode_kernel_int4`     int4 cache, dots on the unsigned nibbles widened
//                             to floating point (mode 2);
//   `_decode_kernel_int4_i8`  int4 cache, both dots on int8 operands (mode 3).
// Modes 1-3 are `decode_quant_kernel` in the second half of this file.
// Same contract:
//   q (B, Hq, D) bf16; k/v cache (L, B, Hkv, S, D) bf16 | int8, or uint8
//   (L, B, Hkv, S/2, D) for int4 (byte row r holds token r in its low nibble
//   and token r + S/2 in its high nibble, both +8 biased: split-half over the
//   WHOLE cache width); scales (L, B, Hkv, S) bf16 per token cell;
//   kv_seg (B, S) int32, nonzero = valid cell; layer = which layer to attend;
//   o (B, Hq, D) bf16, zero rows where no cell is valid.
// The layer is selected by a pointer offset into the stacked cache — no
// (B, Hkv, S, D) slice is copied, as on the TPU.
//
// What bounds it on the H100: bytes. A step reads every live K/V cell once
// (2 * S * D * 2 bytes per (row, kv head)) and does ~4 * G * D flops per
// cell, well under the card's flops-per-byte balance, so the goal is a
// coalesced stream of the (S, D) stripe. Each CTA streams one (row, kv head)
// stripe in 64-token tiles with 16-byte loads, and all G query heads of the
// group share each tile read (G = 8 for the 3B model, 7 for the 7B; any
// G <= 16 runs without padding the caller's tensors). The dots are plain
// fp32 FMAs from shared memory — the work per byte is small enough that the
// tensor cores are not needed to keep up with the stream.
// What it does not do yet: split S across CTAs (flash-decoding). With
// B * Hkv CTAs a small batch occupies only part of the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 64;        // tokens per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int GMAX = 16;      // largest query group per kv head
constexpr float NEG_INF = -1e30f;

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

template <int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ kc,  // layer base of the k cache
              const __nv_bfloat16* __restrict__ vc,  // layer base of the v cache
              const int* __restrict__ kv_seg, __nv_bfloat16* __restrict__ o,
              int S, int Hq, int Hkv, float scale) {
  static_assert(D % 8 == 0 && D <= THREADS, "head dim");
  __shared__ __align__(16) __nv_bfloat16 ks[BS][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vs[BS][D];
  __shared__ float qs[GMAX][D];
  __shared__ float ps[GMAX][BS];
  __shared__ float corr_s[GMAX];
  __shared__ float l_s[GMAX];
  __shared__ int valid_s[BS];

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t stripe = ((size_t)b * Hkv + h) * (size_t)S * D;
  const __nv_bfloat16* kb = kc + stripe;
  const __nv_bfloat16* vb = vc + stripe;

  const __nv_bfloat16* qg = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i / D][i % D] = __bfloat162float(qg[i]);

  // softmax state of head g lives in warp g % 4, slot g / 4
  float m_run[GMAX / 4], l_run[GMAX / 4];
#pragma unroll
  for (int j = 0; j < GMAX / 4; ++j) {
    m_run[j] = NEG_INF;
    l_run[j] = 0.f;
  }
  float acc[GMAX];  // column d = tid of every head's output
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;

  const int tok = tid % BS;   // score phase: one token per thread ...
  const int half = tid / BS;  // ... for heads half, half + 2, ...
  constexpr int CH = D / 8;
  for (int s0 = 0; s0 < S; s0 += BS) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BS * CH; i += THREADS) {
      const int r = i / CH;
      const int c = (i % CH) * 8;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (s0 + r < S) {
        const size_t off = (size_t)(s0 + r) * D + c;
        kval = *reinterpret_cast<const uint4*>(kb + off);
        vval = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kval;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vval;
    }
    for (int i = tid; i < BS; i += THREADS)
      valid_s[i] = (s0 + i < S) && kv_seg[(size_t)b * S + s0 + i] != 0;
    __syncthreads();

    // scores: q . k for this thread's token, every head of its half
    float sc[GMAX / 2];
#pragma unroll
    for (int j = 0; j < GMAX / 2; ++j) sc[j] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(&ks[tok][c]);
      const __nv_bfloat16* kv8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = __bfloat162float(kv8[e]);
#pragma unroll
      for (int j = 0; j < GMAX / 2; ++j) {
        const int g = half + 2 * j;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < 8; ++e) sc[j] = fmaf(qs[g][c + e], kf[e], sc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < GMAX / 2; ++j) {
      const int g = half + 2 * j;
      if (g < G) ps[g][tok] = valid_s[tok] ? sc[j] * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax, one head per warp at a time
#pragma unroll
    for (int j = 0; j < GMAX / 4; ++j) {
      const int g = warp + 4 * j;
      if (g < G) {
        const float x0 = ps[g][lane];
        const float x1 = ps[g][lane + 32];
        const float m_new = fmaxf(m_run[j], warp_max(fmaxf(x0, x1)));
        const float p0 = valid_s[lane] ? __expf(x0 - m_new) : 0.f;
        const float p1 = valid_s[lane + 32] ? __expf(x1 - m_new) : 0.f;
        const float c = __expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * c + warp_sum(p0 + p1);
        m_run[j] = m_new;
        // the PV dot takes bf16 weights, as the TPU kernel does
        ps[g][lane] = __bfloat162float(__float2bfloat16(p0));
        ps[g][lane + 32] = __bfloat162float(__float2bfloat16(p1));
        if (lane == 0) corr_s[g] = c;
      }
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] *= corr_s[g];
      for (int t = 0; t < BS; ++t) {
        const float vv = __bfloat162float(vs[t][tid]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) acc[g] = fmaf(ps[g][t], vv, acc[g]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < GMAX / 4; ++j) {
    const int g = warp + 4 * j;
    if (g < G && lane == 0) l_s[g] = l_run[j];
  }
  __syncthreads();
  if (tid < D) {
    __nv_bfloat16* og = o + ((size_t)b * Hq + (size_t)h * G) * D;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float l = l_s[g];
        og[(size_t)g * D + tid] = __float2bfloat16(acc[g] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

template <int D>
void launch(const void* q, const void* kc, const void* vc, const void* kv_seg, void* o,
            int B, int Hq, int Hkv, int S, float scale, cudaStream_t stream) {
  decode_kernel<D><<<B * Hkv, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(kv_seg),
      static_cast<__nv_bfloat16*>(o), S, Hq, Hkv, scale);
}

// ---------------------------------------------------------------------------
// Quantized caches (modes 1-3), head dim 128.
//
// The cache is walked in BLOCKS of `block_rows` stored rows. An int8 block is
// block_rows consecutive tokens. An int4 block is block_rows packed byte rows
// [r0, r0 + block_rows) = tokens [r0, ..) in the low nibbles and tokens
// [S/2 + r0, ..) in the high nibbles, so kv_seg and the scales are read at
// both halves. The block matters to the RESULT only in mode 3, whose softmax
// weights are rounded to int8 against the largest weight of their block: the
// caller passes the block the TPU kernel tiles with, and the plain PyTorch
// version quantizes over the same blocks.
//
// Arithmetic per block, as the TPU kernels:
//   mode 1: scores = q . k (int8 k exact in fp32) * (k_scale * scale); online
//     softmax against the running max; weights * v_scale rounded to bf16 for
//     the p . v dot.
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

constexpr int QD = 128;
constexpr int TILE = 64;
constexpr int KV4_BIAS = 8;
constexpr int MODE_BF16 = 0, MODE_INT8 = 1, MODE_INT4 = 2, MODE_INT4_I8 = 3;
constexpr int MAX_SMEM = 232448;  // bytes a block may opt in to on sm_90
constexpr int TILE_STRIDE = QD + 16;  // bytes per staged row (padded against bank conflicts)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory plan, computed alike on host and device.
struct QLayout {
  int pg;        // padded score slots per block (int4: two padded halves)
  int half_pad;  // int4: padded byte rows per block
  int off_s, off_ksc, off_vsc, off_valid, off_p8, off_q, off_small, total;
};

__host__ __device__ inline QLayout make_qlayout(int mode, int G, int block_rows) {
  QLayout L;
  if (mode == MODE_INT8) {
    L.half_pad = 0;
    L.pg = round_up(block_rows, 4);
  } else {
    L.half_pad = round_up(block_rows, 4);
    L.pg = 2 * L.half_pad;
  }
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
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool PACKED = MODE != MODE_INT8;
  const int G = Hq / Hkv;
  const QLayout L = make_qlayout(MODE, G, block_rows);
  unsigned char* tile = smem;
  float* s_sh = reinterpret_cast<float*>(smem + L.off_s);
  float* ksc = reinterpret_cast<float*>(smem + L.off_ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.off_vsc);
  unsigned char* valid_sh = smem + L.off_valid;
  signed char* p8 = reinterpret_cast<signed char*>(smem + L.off_p8);
  float* qs = reinterpret_cast<float*>(smem + L.off_q);              // modes 1, 2
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
  const int rows_total = PACKED ? S / 2 : S;  // stored rows of the stripe
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
    if (MODE == MODE_INT4) {  // sum(q) per head, for the -8 debias of the scores
      for (int g = warp; g < G; g += THREADS / 32) {
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < QD / 32; ++j) sq += __bfloat162float(qg[(size_t)g * QD + lane + 32 * j]);
        sq = warp_sum(sq);
        if (lane == 0) sumq_sh[g] = sq;
      }
    }
  }

  float acc[GMAX];  // column d = tid of every head's output
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;

  const int tok = tid % TILE;   // phase A: one staged row per thread ...
  const int part = tid / TILE;  // ... int8: heads part, part+2, ..; int4: nibble half

  for (int r0 = 0; r0 < rows_total; r0 += block_rows) {
    const int rows = min(block_rows, rows_total - r0);  // stored rows of this block
    __syncthreads();  // previous block fully consumed (and q / state initialised)
    // score slot j -> token: int8 slot j = token r0 + j; int4 slot j < half_pad
    // = token r0 + j, slot half_pad + j = token S/2 + r0 + j
    int any = 0;
    for (int j = tid; j < PG; j += THREADS) {
      int t = -1;
      if (PACKED) {
        const int hf = j >= half_pad;
        const int r = j - hf * half_pad;
        if (r < rows) t = hf * rows_total + r0 + r;
      } else if (j < rows) {
        t = r0 + j;
      }
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
      } else if (MODE == MODE_INT4) {
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
      } else {
        float sc[GMAX / 2];
#pragma unroll
        for (int j = 0; j < GMAX / 2; ++j) sc[j] = 0.f;
#pragma unroll
        for (int c = 0; c < QD; c += 8) {
          const uint2 raw = *reinterpret_cast<const uint2*>(krow + c);
          const signed char* k8 = reinterpret_cast<const signed char*>(&raw);
          float kf[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = static_cast<float>(k8[e]);
#pragma unroll
          for (int j = 0; j < GMAX / 2; ++j) {
            const int g = part + 2 * j;
            if (g < G) {
#pragma unroll
              for (int e = 0; e < 8; ++e) sc[j] = fmaf(qs[g * QD + c + e], kf[e], sc[j]);
            }
          }
        }
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < GMAX / 2; ++j) {
            const int g = part + 2 * j;
            if (g < G) s_sh[g * PG + r] = sc[j] * ksc[r];
          }
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
          // modes 1/2: the p . v dot takes bf16 weights, as the TPU kernels do
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
          if (MODE == MODE_INT4) {
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
          } else {
            const float vv =
                static_cast<float>(reinterpret_cast<const signed char*>(tile + t * TILE_STRIDE)[tid]);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
              if (g < G) acc[g] = fmaf(s_sh[g * PG + t0 + t], vv, acc[g]);
          }
        }
      }
      if (MODE == MODE_INT4) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) acc[g] -= KV4_BIAS * sump_sh[g];
      }
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

// Dynamic shared memory (bytes) one CTA of a quantized mode needs; the wrapper
// refuses shapes beyond the card's opt-in limit before launching.
extern "C" int st_decode_attention_smem(int mode, int G, int block_rows) {
  return mode == MODE_BF16 ? 0 : make_qlayout(mode, G, block_rows).total;
}

// `S` is the cache width in tokens for every mode; `block_rows` (modes 1-3) is
// the number of stored rows per block. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int st_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                   const void* k_scale, const void* v_scale,
                                   const void* kv_seg, void* o, int B, int Hq, int Hkv,
                                   int S, int D, int layer, int mode, int block_rows,
                                   float scale, void* stream) {
  if (Hq % Hkv != 0 || Hq / Hkv > GMAX || mode < MODE_BF16 || mode > MODE_INT4_I8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != MODE_BF16) {
    const bool int4 = mode != MODE_INT8;
    if (D != QD || block_rows < 1 || (int4 && S % 2 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = make_qlayout(mode, Hq / Hkv, block_rows).total;
    if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    const size_t layer_bytes = (size_t)B * Hkv * (size_t)(int4 ? S / 2 : S) * QD;
    const size_t layer_cells = (size_t)B * Hkv * (size_t)S;
    const unsigned char* kc = static_cast<const unsigned char*>(k_cache) + layer * layer_bytes;
    const unsigned char* vc = static_cast<const unsigned char*>(v_cache) + layer * layer_bytes;
    const __nv_bfloat16* ks = static_cast<const __nv_bfloat16*>(k_scale) + layer * layer_cells;
    const __nv_bfloat16* vs = static_cast<const __nv_bfloat16*>(v_scale) + layer * layer_cells;
    switch (mode) {
      case MODE_INT8:
        return launch_quant<MODE_INT8>(q, kc, vc, ks, vs, kv_seg, o, B, Hq, Hkv, S, block_rows,
                                       scale, smem, s);
      case MODE_INT4:
        return launch_quant<MODE_INT4>(q, kc, vc, ks, vs, kv_seg, o, B, Hq, Hkv, S, block_rows,
                                       scale, smem, s);
      default:
        return launch_quant<MODE_INT4_I8>(q, kc, vc, ks, vs, kv_seg, o, B, Hq, Hkv, S,
                                          block_rows, scale, smem, s);
    }
  }
  const size_t layer_off = (size_t)layer * B * Hkv * (size_t)S * D;
  const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(k_cache) + layer_off;
  const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(v_cache) + layer_off;
  switch (D) {
    case 128:
      launch<128>(q, kc, vc, kv_seg, o, B, Hq, Hkv, S, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
