// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v, fp32 online
// softmax, GQA, segment-id + causal masking, per-row logsumexp.
//
// Replaces the Pallas TPU kernel spatialthinker_tpu/ops/flash_attention.py
// `_fwd_kernel_gqa` (launched by `_flash_fwd`). Same contract:
//   q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) bf16, contiguous;
//   q_seg (B, Sq), kv_seg (B, Skv) int32 — a query attends a key iff both
//   segment ids are equal and nonzero, and (causal) kv_pos <= causal_offset + q_pos;
//   o (B, Sq, Hq, D) bf16, lse (B, Hq, Sq) fp32.
//   A fully masked row gives o = 0 and lse = -1e30.
//
// What bounds it on the H100: at the slice's shapes (text prefill D=128
// G=8, vision D=80 G=1) attention is tensor-core work — S = QK^T and O = PV
// are ~4*Sq*Skv*D flops per head against O(S*D) bytes. This first version
// issues mma.sync m16n8k16 (bf16 in, fp32 accumulate), well below wgmma's
// rate; K/V tiles are staged through shared memory by plain 16-byte loads
// (no TMA, no double buffering), so load latency is exposed once per tile.
//
// Design: one CTA per (batch, kv head, q tile). Its warps cover all G query
// heads of the kv group (up to 8 per CTA; larger groups split over CTAs), so
// each K/V tile read from device memory feeds every head of the group, as the
// TPU kernel's G-batched program does. Each warp owns 16 query rows of one
// head: Q fragments stay in registers, S = QK^T lands in registers and is
// reused in place as the A operand of PV (no shared-memory round trip for P).
// V is stored transposed in shared memory so both B operands are 32-bit
// reads; rows are padded by 8 bf16 to keep those reads bank-conflict free.
// kv tiles strictly above the causal diagonal are skipped; the ragged edge
// (Sq, Skv not tile multiples) is masked in-kernel — out-of-range kv rows get
// segment id 0, which no live query matches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;    // kv rows per shared-memory tile
constexpr int PAD = 8;    // bf16 padding per shared-memory row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D(16x8 f32) += A(16x16 bf16, row) * B(16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const int* __restrict__ q_seg,
                                 const int* __restrict__ kv_seg,
                                 __nv_bfloat16* __restrict__ o,
                                 float* __restrict__ lse,
                                 int Sq, int Skv, int Hq, int Hkv,
                                 int heads_per_cta, int pos_tiles,
                                 int causal, int causal_offset, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 ks[BK][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 vts[D][BK + PAD];  // V transposed
  __shared__ int segs[BK];

  const int G = Hq / Hkv;
  const int n_sub = (G + heads_per_cta - 1) / heads_per_cta;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / n_sub;
  const int sub = blockIdx.y % n_sub;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // row within the 8-row half of the fragment
  const int tig = lane & 3;   // column pair within the fragment

  const int rows_per_cta = 16 * pos_tiles;
  const int p0 = blockIdx.x * rows_per_cta;
  const int g = sub * heads_per_cta + warp / pos_tiles;
  const int head = kvh * G + g;
  const int row0 = p0 + (warp % pos_tiles) * 16;
  const bool warp_live = g < G && row0 < Sq;  // warp-uniform
  const int r_lo = row0 + gid;
  const int r_hi = row0 + gid + 8;
  const bool lo_ok = warp_live && r_lo < Sq;
  const bool hi_ok = warp_live && r_hi < Sq;

  // Q fragments (A operand, row-major 16 x D), kept in registers.
  uint32_t qf[D / 16][4];
  const size_t q_row = (size_t)Hq * D;
  const __nv_bfloat16* q_lo = q + ((size_t)b * Sq + (lo_ok ? r_lo : 0)) * q_row + (size_t)(g < G ? head : 0) * D;
  const __nv_bfloat16* q_hi = q + ((size_t)b * Sq + (hi_ok ? r_hi : 0)) * q_row + (size_t)(g < G ? head : 0) * D;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + tig * 2;
    qf[kc][0] = lo_ok ? ld32(q_lo + c) : 0u;
    qf[kc][1] = hi_ok ? ld32(q_hi + c) : 0u;
    qf[kc][2] = lo_ok ? ld32(q_lo + c + 8) : 0u;
    qf[kc][3] = hi_ok ? ld32(q_hi + c + 8) : 0u;
  }
  const int seg_lo = lo_ok ? q_seg[(size_t)b * Sq + r_lo] : 0;
  const int seg_hi = hi_ok ? q_seg[(size_t)b * Sq + r_hi] : 0;

  float oacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {
    const int last_q = min(p0 + rows_per_cta, Sq) - 1;
    n_tiles = min(n_tiles, (causal_offset + last_q) / BK + 1);
  }

  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int r = i / CH;
      const int c = (i % CH) * 8;
      const int kv = kv0 + r;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (kv < Skv) {
        const size_t off = (((size_t)b * Skv + kv) * Hkv + kvh) * D + c;
        kval = *reinterpret_cast<const uint4*>(k + off);
        vval = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kval;
      const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[c + j][r] = vv[j];
    }
    for (int i = threadIdx.x; i < BK; i += blockDim.x) {
      const int kv = kv0 + i;
      segs[i] = kv < Skv ? kv_seg[(size_t)b * Skv + kv] : 0;
    }
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T: 16 x BK per warp, in BK/8 n8 tiles.
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* kr = &ks[nt * 8 + gid][kc * 16 + tig * 2];
        mma_16816(s[nt], qf[kc], ld32(kr), ld32(kr + 8));
      }
    }

    // mask + scale; bit (nt*4 + e) of `live` marks an attended cell
    uint32_t live = 0u;
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const bool lo = e < 2;
        const int sq = lo ? seg_lo : seg_hi;
        const int qpos = lo ? r_lo : r_hi;
        const bool ok = sq != 0 && segs[col] == sq &&
                        (!causal || kv0 + col <= causal_offset + qpos);
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        if (ok) live |= 1u << (nt * 4 + e);
        if (lo) mx_lo = fmaxf(mx_lo, s[nt][e]);
        else mx_hi = fmaxf(mx_hi, s[nt][e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = __expf(m_lo - mn_lo);
    const float corr_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float p = (live >> (nt * 4 + e)) & 1u ? __expf(s[nt][e] - (lo ? mn_lo : mn_hi)) : 0.f;
        s[nt][e] = p;
        if (lo) sum_lo += p;
        else sum_hi += p;
      }
    }
    // per-thread partial row sums; the quad reduction happens once at the end
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      oacc[dt][0] *= corr_lo;
      oacc[dt][1] *= corr_lo;
      oacc[dt][2] *= corr_hi;
      oacc[dt][3] *= corr_hi;
    }

    // O += P V: the S accumulator layout of two n8 tiles is the A layout of
    // one k16 chunk, so P is rounded to bf16 and fed from registers.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = &vts[dt * 8 + gid][kc * 16 + tig * 2];
        mma_16816(oacc[dt], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float safe_lo = l_lo == 0.f ? 1.f : l_lo;
  const float safe_hi = l_hi == 0.f ? 1.f : l_hi;
  if (lo_ok) {
    __nv_bfloat16* out = o + ((size_t)b * Sq + r_lo) * q_row + (size_t)head * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
          pack_bf16x2(oacc[dt][0] / safe_lo, oacc[dt][1] / safe_lo);
    if (tig == 0)
      lse[((size_t)b * Hq + head) * Sq + r_lo] = l_lo == 0.f ? NEG_INF : m_lo + logf(safe_lo);
  }
  if (hi_ok) {
    __nv_bfloat16* out = o + ((size_t)b * Sq + r_hi) * q_row + (size_t)head * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
          pack_bf16x2(oacc[dt][2] / safe_hi, oacc[dt][3] / safe_hi);
    if (tig == 0)
      lse[((size_t)b * Hq + head) * Sq + r_hi] = l_hi == 0.f ? NEG_INF : m_hi + logf(safe_hi);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* q_seg,
            const void* kv_seg, void* o, void* lse, int B, int Sq, int Skv,
            int Hq, int Hkv, int causal, int causal_offset, float scale,
            cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int heads_per_cta = G < 8 ? G : 8;
  const int pos_tiles = heads_per_cta >= 4 ? 1 : 4 / heads_per_cta;
  const int n_sub = (G + heads_per_cta - 1) / heads_per_cta;
  const int rows = 16 * pos_tiles;
  dim3 grid((Sq + rows - 1) / rows, Hkv * n_sub, B);
  dim3 block(32 * heads_per_cta * pos_tiles);
  flash_fwd_kernel<D><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, heads_per_cta, pos_tiles,
      causal, causal_offset, scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int st_flash_fwd(const void* q, const void* k, const void* v,
                            const void* q_seg, const void* kv_seg, void* o,
                            void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                            int D, int causal, int causal_offset, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      launch<80>(q, k, v, q_seg, kv_seg, o, lse, B, Sq, Skv, Hq, Hkv, causal, causal_offset, scale, s);
      break;
    case 128:
      launch<128>(q, k, v, q_seg, kv_seg, o, lse, B, Sq, Skv, Hq, Hkv, causal, causal_offset, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
