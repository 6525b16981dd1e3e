// Flash-attention backward for Hopper (sm_90a): two kernels, dQ and dK/dV,
// from the forward's saved logsumexp and delta = rowsum(dO * O).
//
// Replace the Pallas TPU kernels of spatialthinker_tpu/ops/flash_attention.py:
// `_bwd_dq_kernel_gqa` and `_bwd_dkv_kernel_gqa` (both launched by
// `_flash_bwd`). Same contract:
//   q, dO (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) bf16, contiguous;
//   lse, delta (B, Hq, Sq) fp32; q_seg (B, Sq), kv_seg (B, Skv) int32;
//   mask = same nonzero segment and (causal) kv_pos <= q_pos;
//   p  = mask ? exp(scale * q.k - lse) : 0   (selected, never multiplied: a
//        fully masked row has lse = -1e30 and exp() overflows there);
//   dp = dO.v,  ds = p * (dp - delta);
//   dq = scale * ds.k,  dk = scale * ds^T.q,  dv = p^T.dO,
//   with dk/dv summed over the G query heads of the kv group in the kernel.
//   Padding rows (segment 0) get exact zeros in all three gradients.
//
// What bounds them on the H100: tensor-core work. dQ is three products and
// dK/dV four, each 2*Sq*Skv*D flops per query head (half when causal),
// against O(S*D) bytes. Both run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate) from shared-memory tiles filled by plain 16-byte loads, so they
// run well below the wgmma rate; p and ds are rounded to bf16 before the
// second products (the TPU kernels keep them in fp32).
//
// dQ: one CTA per (batch, kv head, q tile); its warps cover the G query heads
// of the group as the forward does, each warp 16 query rows of one head with
// its Q and dO fragments in registers. kv tiles of 32 rows stream through
// shared memory up to the causal diagonal: K and V row-major (B operands of
// S = QK^T and dP = dO V^T) and K transposed (B operand of dQ += dS K).
//
// dK/dV: one CTA per (batch, kv head, kv tile of 64 rows); each of its four
// warps owns 16 kv rows and keeps their dK and dV accumulators in registers
// across the whole loop over the G heads and over the q tiles from the causal
// diagonal on, so the group sum costs no atomics and no per-head buffers. The
// K and V tiles stay in shared memory (A operands of S^T = K Q^T and
// dP^T = V dO^T are re-read from there: fragments plus two accumulators would
// not fit the register file); Q and dO tiles of 32 rows are staged row-major
// and transposed (B operands of dV += P^T dO and dK += dS^T Q). Shared-memory
// rows are padded by 8 bf16, so D = 80 needs no padded tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 8;        // bf16 padding per shared-memory row
constexpr int DQ_BK = 32;     // kv rows per tile of the dQ kernel
constexpr int DKV_BK = 64;    // kv rows per CTA of the dK/dV kernel
constexpr int DKV_BQ = 32;    // q rows per tile of the dK/dV kernel
constexpr int DKV_THREADS = 32 * (DKV_BK / 16);

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

// The accumulator layout of two n8 tiles is the A layout of one k16 chunk.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
                    int heads_per_cta, int pos_tiles, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BK = DQ_BK;
  __shared__ __align__(16) __nv_bfloat16 ks[BK][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 kts[D][BK + PAD];  // K transposed
  __shared__ int segs[BK];

  const int G = Hq / Hkv;
  const int n_sub = (G + heads_per_cta - 1) / heads_per_cta;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / n_sub;
  const int sub = blockIdx.y % n_sub;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

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

  // Q and dO fragments (A operands, row-major 16 x D), kept in registers.
  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  const size_t q_row = (size_t)Hq * D;
  const size_t off_lo = ((size_t)b * Sq + (lo_ok ? r_lo : 0)) * q_row + (size_t)(g < G ? head : 0) * D;
  const size_t off_hi = ((size_t)b * Sq + (hi_ok ? r_hi : 0)) * q_row + (size_t)(g < G ? head : 0) * D;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + tig * 2;
    qf[kc][0] = lo_ok ? ld32(q + off_lo + c) : 0u;
    qf[kc][1] = hi_ok ? ld32(q + off_hi + c) : 0u;
    qf[kc][2] = lo_ok ? ld32(q + off_lo + c + 8) : 0u;
    qf[kc][3] = hi_ok ? ld32(q + off_hi + c + 8) : 0u;
    dof[kc][0] = lo_ok ? ld32(dout + off_lo + c) : 0u;
    dof[kc][1] = hi_ok ? ld32(dout + off_hi + c) : 0u;
    dof[kc][2] = lo_ok ? ld32(dout + off_lo + c + 8) : 0u;
    dof[kc][3] = hi_ok ? ld32(dout + off_hi + c + 8) : 0u;
  }
  const int seg_lo = lo_ok ? q_seg[(size_t)b * Sq + r_lo] : 0;
  const int seg_hi = hi_ok ? q_seg[(size_t)b * Sq + r_hi] : 0;
  const size_t stat_row = ((size_t)b * Hq + (g < G ? head : 0)) * Sq;
  const float lse_lo = lo_ok ? lse[stat_row + r_lo] : 0.f;
  const float lse_hi = hi_ok ? lse[stat_row + r_hi] : 0.f;
  const float delta_lo = lo_ok ? delta[stat_row + r_lo] : 0.f;
  const float delta_hi = hi_ok ? delta[stat_row + r_hi] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {
    const int last_q = min(p0 + rows_per_cta, Sq) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
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
      *reinterpret_cast<uint4*>(&vs[r][c]) = vval;
      const __nv_bfloat16* kk = reinterpret_cast<const __nv_bfloat16*>(&kval);
#pragma unroll
      for (int j = 0; j < 8; ++j) kts[c + j][r] = kk[j];
    }
    for (int i = threadIdx.x; i < BK; i += blockDim.x) {
      const int kv = kv0 + i;
      segs[i] = kv < Skv ? kv_seg[(size_t)b * Skv + kv] : 0;
    }
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T and dP = dO V^T: 16 x BK per warp each
    float s[BK / 8][4];
    float dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* kr = &ks[nt * 8 + gid][kc * 16 + tig * 2];
        const __nv_bfloat16* vr = &vs[nt * 8 + gid][kc * 16 + tig * 2];
        mma_16816(s[nt], qf[kc], ld32(kr), ld32(kr + 8));
        mma_16816(dp[nt], dof[kc], ld32(vr), ld32(vr + 8));
      }
    }

    // ds = p * (dp - delta), p selected to 0 outside the mask
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const bool lo = e < 2;
        const int sq = lo ? seg_lo : seg_hi;
        const int qpos = lo ? r_lo : r_hi;
        const bool ok = sq != 0 && segs[col] == sq && (!causal || kv0 + col <= qpos);
        const float p = ok ? __expf(s[nt][e] * scale - (lo ? lse_lo : lse_hi)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (lo ? delta_lo : delta_hi));
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* kr = &kts[dt * 8 + gid][kc * 16 + tig * 2];
        mma_16816(acc[dt], a, ld32(kr), ld32(kr + 8));
      }
    }
  }

  if (!warp_live) return;
  if (lo_ok) {
    __nv_bfloat16* out = dq + off_lo;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
          pack_bf16x2(acc[dt][0] * scale, acc[dt][1] * scale);
  }
  if (hi_ok) {
    __nv_bfloat16* out = dq + off_hi;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
          pack_bf16x2(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int D>
struct DkvLayout {
  static constexpr int kRow = D + PAD;          // bf16 per row-major row
  static constexpr int kTRow = DKV_BQ + PAD;    // bf16 per transposed row
  static constexpr int off_k = 0;
  static constexpr int off_v = off_k + DKV_BK * kRow * 2;
  static constexpr int off_q = off_v + DKV_BK * kRow * 2;
  static constexpr int off_do = off_q + DKV_BQ * kRow * 2;
  static constexpr int off_qt = off_do + DKV_BQ * kRow * 2;
  static constexpr int off_dot = off_qt + D * kTRow * 2;
  static constexpr int off_lse = off_dot + D * kTRow * 2;
  static constexpr int off_delta = off_lse + DKV_BQ * 4;
  static constexpr int off_seg = off_delta + DKV_BQ * 4;
  static constexpr int total = off_seg + DKV_BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(DKV_THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int Sq, int Skv, int Hq, int Hkv, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using L = DkvLayout<D>;
  constexpr int BK = DKV_BK;
  constexpr int BQ = DKV_BQ;
  constexpr int ROW = L::kRow;
  constexpr int TROW = L::kTRow;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::off_k);     // [BK][ROW]
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::off_v);     // [BK][ROW]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::off_q);     // [BQ][ROW]
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + L::off_do);   // [BQ][ROW]
  __nv_bfloat16* qts = reinterpret_cast<__nv_bfloat16*>(smem + L::off_qt);   // [D][TROW]
  __nv_bfloat16* dots = reinterpret_cast<__nv_bfloat16*>(smem + L::off_dot); // [D][TROW]
  float* lse_s = reinterpret_cast<float*>(smem + L::off_lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::off_delta);
  int* qseg_s = reinterpret_cast<int*>(smem + L::off_seg);

  const int G = Hq / Hkv;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int kv0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const int w_row = warp * 16;                // this warp's first row in the tile
  const int kv_lo = kv0 + w_row + gid;
  const int kv_hi = kv_lo + 8;
  const bool warp_live = kv0 + w_row < Skv;   // warp-uniform
  const bool lo_ok = kv_lo < Skv;
  const bool hi_ok = kv_hi < Skv;
  const int seg_lo = lo_ok ? kv_seg[(size_t)b * Skv + kv_lo] : 0;
  const int seg_hi = hi_ok ? kv_seg[(size_t)b * Skv + kv_hi] : 0;

  // resident K and V tiles
  constexpr int CH = D / 8;  // 16-byte chunks per row
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
    *reinterpret_cast<uint4*>(&ks[r * ROW + c]) = kval;
    *reinterpret_cast<uint4*>(&vs[r * ROW + c]) = vval;
  }

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  const int n_q_tiles = (Sq + BQ - 1) / BQ;
  const int first_q_tile = causal ? kv0 / BQ : 0;  // earlier q rows see none of this tile
  const size_t q_row = (size_t)Hq * D;

  for (int g = 0; g < G; ++g) {
    const int head = kvh * G + g;
    const size_t stat_row = ((size_t)b * Hq + head) * Sq;
    for (int qt = first_q_tile; qt < n_q_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous tile (and K/V are in place)
      for (int i = threadIdx.x; i < BQ * CH; i += blockDim.x) {
        const int r = i / CH;
        const int c = (i % CH) * 8;
        const int qr = q0 + r;
        uint4 qval = make_uint4(0u, 0u, 0u, 0u);
        uint4 dval = make_uint4(0u, 0u, 0u, 0u);
        if (qr < Sq) {
          const size_t off = ((size_t)b * Sq + qr) * q_row + (size_t)head * D + c;
          qval = *reinterpret_cast<const uint4*>(q + off);
          dval = *reinterpret_cast<const uint4*>(dout + off);
        }
        *reinterpret_cast<uint4*>(&qs[r * ROW + c]) = qval;
        *reinterpret_cast<uint4*>(&dos[r * ROW + c]) = dval;
        const __nv_bfloat16* qq = reinterpret_cast<const __nv_bfloat16*>(&qval);
        const __nv_bfloat16* dd = reinterpret_cast<const __nv_bfloat16*>(&dval);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          qts[(c + j) * TROW + r] = qq[j];
          dots[(c + j) * TROW + r] = dd[j];
        }
      }
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        const int qr = q0 + i;
        const bool in = qr < Sq;
        lse_s[i] = in ? lse[stat_row + qr] : 0.f;
        delta_s[i] = in ? delta[stat_row + qr] : 0.f;
        qseg_s[i] = in ? q_seg[(size_t)b * Sq + qr] : 0;
      }
      __syncthreads();
      if (!warp_live) continue;

      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x BQ per warp each
      float st[BQ / 8][4];
      float dpt[BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int c = kc * 16 + tig * 2;
        uint32_t ka[4], va[4];
        ka[0] = ld32(&ks[(w_row + gid) * ROW + c]);
        ka[1] = ld32(&ks[(w_row + gid + 8) * ROW + c]);
        ka[2] = ld32(&ks[(w_row + gid) * ROW + c + 8]);
        ka[3] = ld32(&ks[(w_row + gid + 8) * ROW + c + 8]);
        va[0] = ld32(&vs[(w_row + gid) * ROW + c]);
        va[1] = ld32(&vs[(w_row + gid + 8) * ROW + c]);
        va[2] = ld32(&vs[(w_row + gid) * ROW + c + 8]);
        va[3] = ld32(&vs[(w_row + gid + 8) * ROW + c + 8]);
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          const __nv_bfloat16* qr = &qs[(nt * 8 + gid) * ROW + c];
          const __nv_bfloat16* dr = &dos[(nt * 8 + gid) * ROW + c];
          mma_16816(st[nt], ka, ld32(qr), ld32(qr + 8));
          mma_16816(dpt[nt], va, ld32(dr), ld32(dr + 8));
        }
      }

      // p^T (selected to 0 outside the mask) into st, ds^T into dpt
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + tig * 2 + (e & 1);  // q row within the tile
          const bool lo = e < 2;
          const int skv = lo ? seg_lo : seg_hi;
          const int kvpos = lo ? kv_lo : kv_hi;
          const bool ok = skv != 0 && qseg_s[col] == skv && (!causal || kvpos <= q0 + col);
          const float p = ok ? __expf(st[nt][e] * scale - lse_s[col]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - delta_s[col]);
        }
      }

      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, st[2 * kc], st[2 * kc + 1]);
        acc_to_a(dsa, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const __nv_bfloat16* dr = &dots[(dt * 8 + gid) * TROW + kc * 16 + tig * 2];
          const __nv_bfloat16* qr = &qts[(dt * 8 + gid) * TROW + kc * 16 + tig * 2];
          mma_16816(dv_acc[dt], pa, ld32(dr), ld32(dr + 8));
          mma_16816(dk_acc[dt], dsa, ld32(qr), ld32(qr + 8));
        }
      }
    }
  }

  if (!warp_live) return;
  if (lo_ok) {
    const size_t off = (((size_t)b * Skv + kv_lo) * Hkv + kvh) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + tig * 2) =
          pack_bf16x2(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + tig * 2) =
          pack_bf16x2(dv_acc[dt][0], dv_acc[dt][1]);
    }
  }
  if (hi_ok) {
    const size_t off = (((size_t)b * Skv + kv_hi) * Hkv + kvh) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + tig * 2) =
          pack_bf16x2(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + tig * 2) =
          pack_bf16x2(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* q_seg, const void* kv_seg, void* dq, int B, int Sq,
              int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int heads_per_cta = G < 8 ? G : 8;
  const int pos_tiles = heads_per_cta >= 4 ? 1 : 4 / heads_per_cta;
  const int n_sub = (G + heads_per_cta - 1) / heads_per_cta;
  const int rows = 16 * pos_tiles;
  dim3 grid((Sq + rows - 1) / rows, Hkv * n_sub, B);
  dim3 block(32 * heads_per_cta * pos_tiles);
  flash_bwd_dq_kernel<D><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, Hq, Hkv, heads_per_cta, pos_tiles, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* q_seg, const void* kv_seg, void* dk, void* dv, int B,
               int Sq, int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = DkvLayout<D>::total;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Skv + DKV_BK - 1) / DKV_BK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, DKV_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Skv, Hq, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched).
extern "C" int st_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* q_seg,
                               const void* kv_seg, void* dq, int B, int Sq, int Skv, int Hq,
                               int Hkv, int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      return launch_dq<80>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int st_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* q_seg,
                                const void* kv_seg, void* dk, void* dv, int B, int Sq, int Skv,
                                int Hq, int Hkv, int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      return launch_dkv<80>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
