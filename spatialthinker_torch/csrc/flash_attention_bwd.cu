// Flash-attention backward for Hopper (sm_90a): a pre-pass, dQ and dK/dV,
// from the forward's saved logsumexp.
//
// Replace the Pallas TPU kernels of spatialthinker_tpu/ops/flash_attention.py:
// `_bwd_dq_kernel_gqa` (:192) and `_bwd_dkv_kernel_gqa` (:255), both launched
// by `_flash_bwd`, and the XLA rowsum that computes delta there (:343). Same
// contract:
//   q, dO (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) bf16, contiguous, D = 80 or 128;
//   lse (B, Hq, Sq) fp32; q_seg (B, Sq), kv_seg (B, Skv) int32;
//   mask = same nonzero segment and (causal) kv_pos <= q_pos;
//   delta = rowsum(dO * O);
//   p  = mask ? exp(scale * q.k - lse) : 0   (selected, never multiplied: a
//        fully masked row has lse = -1e30 and exp() overflows there);
//   dp = dO.v,  ds = p * (dp - delta);
//   dq = scale * ds.k,  dk = scale * ds^T.q,  dv = p^T.dO,
//   with dk/dv summed over the G query heads of the kv group.
//   Padding rows (segment 0) get exact zeros in all three gradients.
//   p and ds are rounded to bf16 for the second products; accumulators, lse
//   and delta stay fp32.
//
// What bounds them on the H100: tensor-core work on the pairs that are
// unmasked. dQ is three products and dK/dV four, 2*D flops each per
// (query head, q row, kv row) pair, against O(S*D) bytes. The training path
// packs many images or samples into one sequence: at the update's vision pack
// (8 images in 16,384 slots) 7.3% of the pairs are unmasked, so walking every
// tile wastes ~12x the work. The design:
//
// 1. Tile skip. The pre-pass writes, beside delta, the range [lo, hi] of the
//    nonzero segment ids of every TILE-row tile of q_seg and kv_seg (layout
//    below). A (q tile, kv tile) pair runs only when the two ranges intersect
//    and, when causal, the kv tile is not wholly above the diagonal. Two
//    disjoint ranges share no nonzero id, so this is exact for any layout:
//    unsorted or repeated ids, Sq != Skv, q_seg != kv_seg. Each CTA first
//    compacts the list of the streamed side's tiles that meet one of its own
//    two tiles (ballot + prefix over its warps), then walks only that list.
// 2. Asynchronous staging. The streamed tiles (K/V in dQ; Q, dO, lse, delta
//    and q segment ids in dK/dV) go through a STAGES-deep ring filled by
//    cp.async (rows past the end zero-filled), so the next tiles' copies
//    overlap the current tile's products. Every shared tile is stored in
//    wgmma's no-swizzle core-matrix layout: 8 rows x 16 bytes contiguous,
//    the D/8 core matrices of an 8-row block side by side (block_offset).
//    ldmatrix reads whole core matrices from it (conflict-free for D = 80
//    and 128 without padded tensors), ldmatrix.trans the transposed B
//    operands (K in dQ += dS K, Q and dO in dK += dS^T Q, dV += P^T dO).
// 3. Tensor cores. The first products have a 64-row shared-memory A tile
//    (the CTA's own Q and dO in dQ, its K and V in dK/dV) and a 32-row
//    K-major B tile: S = Q K^T, dP = dO V^T, S^T = K Q^T and dP^T = V dO^T
//    run as wgmma m64n32k16 of the CTA's one warpgroup, both operands read
//    from shared memory. Their fp32 accumulators land in the registers of
//    the warp that owns the rows, in the layout of mma.sync's: the second
//    products (dQ += dS K; dV += P^T dO, dK += dS^T Q) take p and ds from
//    there as A fragments and run as mma.sync m16n8k16, each warp on its
//    16 rows, so a warp whose rows cannot meet the tile skips them.
// 4. Grid. dQ: one CTA per (64 q rows, query head, batch). dK/dV: one CTA per
//    (64 kv rows, kv head, head split, batch); the G heads of a group are cut
//    into n_split splits so that small grids (text rows: 16 x 2 x 4 = 128
//    CTAs) still fill the 132 SMs. With one split the CTA writes bf16
//    gradients itself; with several it writes fp32 partials that a second
//    small kernel sums in split order.
// 5. Deterministic: no atomics; every sum has a fixed order.
//
// The range table layout (read by both kernels and by the forward, which
// builds its own tables with st_flash_ranges) and the staging helpers are in
// flash_common.cuh.

#include "flash_common.cuh"

namespace {

// TILE (flash_common.cuh): rows per range-table tile and per streamed tile
constexpr int OWN = 64;       // rows a CTA owns: q rows (dQ), kv rows (dK/dV)
constexpr int THREADS = 128;  // four warps of 16 owned rows
constexpr int STAGES = 3;     // depth of the cp.async ring

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D(16x8 f32) += A(16x16 bf16, row) * B(16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix.x4 lane addresses (m = lane / 8 names the 8x8 matrix, r = lane % 8
// its row) within a tile:
//   B fragments (transposed) of two n8 tiles at columns [n0, n0 + 16), k16
//   chunk at rows [k0, k0 + 16): regs {b0, b1} of n-tile n0/8, then n0/8 + 1.
template <int D>
__device__ __forceinline__ uint32_t bt_frag_addr(uint32_t base, int k0, int n0, int lane) {
  const int m = lane >> 3;
  return base + block_offset<D>(k0 + (m & 1) * 8, n0 + (m >> 1) * 8) + (lane & 7) * 16;
}

// D(64 x 32, fp32) (+)= A(64 x 16) B(32 x 16)^T, both bf16 K-major in shared
// memory; the warpgroup's 128 threads hold D as mma.sync's C fragments of
// their warp's 16 rows: d[4 * j + e] <-> n-tile j, element e.
__device__ __forceinline__ void wgmma_64x32x16(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S = A B^T and P = C E^T (64 x 32 each) over the D columns of four
// shared-memory tiles: 2 * D/16 wgmma, then wait for both.
template <int D>
__device__ __forceinline__ void wgmma_pair(float (&s)[16], float (&p)[16], uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t e) {
  fence_regs(s);
  fence_regs(p);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    wgmma_64x32x16(s, kmajor_desc<D>(a + kc * 256), kmajor_desc<D>(b + kc * 256), kc > 0);
    wgmma_64x32x16(p, kmajor_desc<D>(c + kc * 256), kmajor_desc<D>(e + kc * 256), kc > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(s);
  fence_regs(p);
}

// Compacts into list[] the streamed-side tiles t that meet one of the CTA's
// two own tiles (own0, own0 + 1): entry t * 4 + bits, bit s set when own tile
// own0 + s meets t (ranges intersect; when causal, kv tile <= q tile).
// Called by every thread; returns the count (the same in every thread).
template <bool OWN_IS_Q>
__device__ int build_live_list(int* list, int* warp_n, const int2* __restrict__ own_rng, int own0,
                               int n_own, const int2* __restrict__ oth_rng, int n_oth, int causal) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int2 dead = make_int2(INT_MAX, INT_MIN);
  const int2 own_a = own_rng[own0];
  const int2 own_b = own0 + 1 < n_own ? own_rng[own0 + 1] : dead;
  int n = 0;
  for (int base = 0; base < n_oth; base += THREADS) {
    const int t = base + threadIdx.x;
    int bits = 0;
    if (t < n_oth) {
      const int2 r = oth_rng[t];
      const bool ca = !causal || (OWN_IS_Q ? t <= own0 : t >= own0);
      const bool cb = !causal || (OWN_IS_Q ? t <= own0 + 1 : t >= own0 + 1);
      bits = (ca && ranges_meet(own_a, r) ? 1 : 0) | (cb && ranges_meet(own_b, r) ? 2 : 0);
    }
    const unsigned m = __ballot_sync(0xffffffffu, bits != 0);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int before = n;
    int total = n;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      before += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (bits) list[before + __popc(m & ((1u << lane) - 1u))] = t * 4 + bits;
    n = total;
    __syncthreads();  // warp_n is rewritten by the next round
  }
  return n;
}

// ---------------------------------------------------------------------------
// pre-pass: delta and the range tables
// ---------------------------------------------------------------------------

// Blocks [0, delta_blocks) write delta (B, Hq, Sq): 8 lanes per (b, q, head)
// row of D values, fp32 products of the bf16 inputs. The other blocks write
// the range tables, one warp per tile: first the B * nQt tiles of q_seg, then
// the B * nKt tiles of kv_seg.
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ o,
                      const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                      float* __restrict__ delta, int2* __restrict__ q_rng, int2* __restrict__ kv_rng,
                      int B, int Sq, int Skv, int Hq, int D, int delta_blocks) {
  if (blockIdx.x < delta_blocks) {
    const size_t rows = (size_t)B * Sq * Hq;
    const size_t row = (size_t)blockIdx.x * 32 + (threadIdx.x >> 3);
    const int sub = threadIdx.x & 7;
    float acc = 0.f;
    if (row < rows) {
      const __nv_bfloat16* a = dout + row * D;
      const __nv_bfloat16* c = o + row * D;
      for (int j = sub * 8; j < D; j += 64) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(a + j));
        const uint4 y = __ldg(reinterpret_cast<const uint4*>(c + j));
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xs[e]);
          const float2 yf = __bfloat1622float2(ys[e]);
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (sub == 0 && row < rows) {
      const size_t bq = row / Hq;
      const int h = static_cast<int>(row % Hq);
      const size_t b = bq / Sq;
      const int qpos = static_cast<int>(bq % Sq);
      delta[(b * Hq + h) * Sq + qpos] = acc;
    }
    return;
  }
  write_ranges(q_seg, kv_seg, q_rng, kv_rng, B, Sq, Skv, (blockIdx.x - delta_blocks) * 8 + (threadIdx.x >> 5));
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kTileBytes = TILE * D * 2;                 // core-matrix layout, no padding
  static constexpr int off_q = 0;                                  // own Q rows [OWN][D]
  static constexpr int off_do = off_q + OWN * D * 2;               // own dO rows [OWN][D]
  static constexpr int off_stage = off_do + OWN * D * 2;
  static constexpr int kStage = 2 * kTileBytes + TILE * 4;         // K, V, kv segment ids
  static constexpr int off_warp_n = off_stage + STAGES * kStage;
  static constexpr int off_list = off_warp_n + 16;
  static int bytes(int n_list) { return off_list + 4 * n_list; }
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    const int2* __restrict__ q_rng, const int2* __restrict__ kv_rng,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int causal,
                    float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using L = DqSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  int* warp_n = reinterpret_cast<int*>(smem + L::off_warp_n);
  int* list = reinterpret_cast<int*>(smem + L::off_list);

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int kvh = head / (Hq / Hkv);
  const int q0 = blockIdx.x * OWN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n_qt = (Sq + TILE - 1) / TILE;
  const int n_kt = (Skv + TILE - 1) / TILE;

  // own Q and dO rows (group 0), then the list of kv tiles to walk
  stage_rows<D, OWN>(sbase + L::off_q, q, b, q0, Sq, Hq, head, threadIdx.x, THREADS);
  stage_rows<D, OWN>(sbase + L::off_do, dout, b, q0, Sq, Hq, head, threadIdx.x, THREADS);
  cp_async_commit();
  const int n_live = build_live_list<true>(list, warp_n, q_rng + (size_t)b * n_qt, q0 / TILE, n_qt,
                                           kv_rng + (size_t)b * n_kt, n_kt, causal);

  const int r_lo = q0 + warp * 16 + gid;
  const int r_hi = r_lo + 8;
  const bool lo_ok = r_lo < Sq;
  const bool hi_ok = r_hi < Sq;
  const size_t q_row = (size_t)Hq * D;
  const size_t off_lo = ((size_t)b * Sq + r_lo) * q_row + (size_t)head * D;
  const size_t off_hi = off_lo + 8 * q_row;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (n_live > 0) {
    auto load_tile = [&](int item, int stage) {
      const int kv0 = (list[item] >> 2) * TILE;
      const uint32_t st = sbase + L::off_stage + stage * L::kStage;
      stage_rows<D, TILE>(st, k, b, kv0, Skv, Hkv, kvh, threadIdx.x, THREADS);
      stage_rows<D, TILE>(st + L::kTileBytes, v, b, kv0, Skv, Hkv, kvh, threadIdx.x, THREADS);
      stage_words<TILE>(st + 2 * L::kTileBytes, kv_seg + (size_t)b * Skv, kv0, Skv, 0);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_live) load_tile(s, s);
      cp_async_commit();
    }

    const int seg_lo = lo_ok ? q_seg[(size_t)b * Sq + r_lo] : 0;
    const int seg_hi = hi_ok ? q_seg[(size_t)b * Sq + r_hi] : 0;
    const size_t stat_row = ((size_t)b * Hq + head) * Sq;
    const float lse_lo = lo_ok ? lse[stat_row + r_lo] : 0.f;
    const float lse_hi = hi_ok ? lse[stat_row + r_hi] : 0.f;
    const float delta_lo = lo_ok ? delta[stat_row + r_lo] : 0.f;
    const float delta_hi = hi_ok ? delta[stat_row + r_hi] : 0.f;
    const int sub = warp >> 1;  // own q tile of this warp's rows
    float s[16], dp[16];        // S and dP of this warp's 16 rows: n-tile j, element e at [4 j + e]
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;

    for (int i = 0; i < n_live; ++i) {
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();
      __syncthreads();  // tile i landed; every warp is done with tile i - 1's stage
      if (i + STAGES - 1 < n_live) load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      cp_async_commit();

      const int entry = list[i];
      const int kv0 = (entry >> 2) * TILE;
      const uint32_t ks = sbase + L::off_stage + (i % STAGES) * L::kStage;
      const uint32_t vs = ks + L::kTileBytes;
      const int* segs = reinterpret_cast<const int*>(smem + L::off_stage + (i % STAGES) * L::kStage +
                                                     2 * L::kTileBytes);

      // S = Q K^T and dP = dO V^T: 64 x TILE, the whole warpgroup
      wgmma_pair<D>(s, dp, sbase + L::off_q, ks, sbase + L::off_do, vs);
      if (!((entry >> sub) & 1)) continue;  // warp-uniform: this q tile does not meet the kv tile

      // ds = p * (dp - delta), p selected to 0 outside the mask
      float ds[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = (j >> 2) * 8 + tig * 2 + (j & 1);
        const bool lo = (j & 2) == 0;
        const int sq = lo ? seg_lo : seg_hi;
        const int qpos = lo ? r_lo : r_hi;
        const bool ok = sq != 0 && segs[col] == sq && (!causal || kv0 + col <= qpos);
        const float p = ok ? __expf(s[j] * scale - (lo ? lse_lo : lse_hi)) : 0.f;
        ds[j] = p * (dp[j] - (lo ? delta_lo : delta_hi));
      }

      // dQ += dS K (K read transposed)
#pragma unroll
      for (int kc = 0; kc < TILE / 16; ++kc) {
        uint32_t a[4];
        acc_to_a(a, &ds[8 * kc], &ds[8 * kc + 4]);
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, bt_frag_addr<D>(ks, kc * 16, dp2 * 16, lane));
          mma_16816(acc[2 * dp2], a, kb[0], kb[1]);
          mma_16816(acc[2 * dp2 + 1], a, kb[2], kb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

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
struct DkvSmem {
  static constexpr int kTileBytes = TILE * D * 2;                 // core-matrix layout, no padding
  static constexpr int off_k = 0;                                  // own K rows [OWN][D]
  static constexpr int off_v = off_k + OWN * D * 2;                // own V rows [OWN][D]
  static constexpr int off_stage = off_v + OWN * D * 2;
  // Q, dO tiles, then lse, delta and q segment ids of the tile's rows
  static constexpr int kStage = 2 * kTileBytes + 3 * TILE * 4;
  static constexpr int off_warp_n = off_stage + STAGES * kStage;
  static constexpr int off_list = off_warp_n + 16;
  static int bytes(int n_list) { return off_list + 4 * n_list; }
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     const int2* __restrict__ q_rng, const int2* __restrict__ kv_rng,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ part_dk, float* __restrict__ part_dv, int B, int Sq, int Skv,
                     int Hq, int Hkv, int n_split, int heads_per_split, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using L = DkvSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  int* warp_n = reinterpret_cast<int*>(smem + L::off_warp_n);
  int* list = reinterpret_cast<int*>(smem + L::off_list);

  const int G = Hq / Hkv;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / n_split;
  const int split = blockIdx.y % n_split;
  const int g0 = split * heads_per_split;
  const int n_heads = max(0, min(G, g0 + heads_per_split) - g0);
  const int kv0 = blockIdx.x * OWN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n_qt = (Sq + TILE - 1) / TILE;
  const int n_kt = (Skv + TILE - 1) / TILE;

  // resident K and V rows (group 0), then the list of q tiles to walk
  stage_rows<D, OWN>(sbase + L::off_k, k, b, kv0, Skv, Hkv, kvh, threadIdx.x, THREADS);
  stage_rows<D, OWN>(sbase + L::off_v, v, b, kv0, Skv, Hkv, kvh, threadIdx.x, THREADS);
  cp_async_commit();
  const int n_live = build_live_list<false>(list, warp_n, kv_rng + (size_t)b * n_kt, kv0 / TILE, n_kt,
                                            q_rng + (size_t)b * n_qt, n_qt, causal);
  const int n_items = n_heads * n_live;

  const int kv_lo = kv0 + warp * 16 + gid;
  const int kv_hi = kv_lo + 8;
  const bool lo_ok = kv_lo < Skv;
  const bool hi_ok = kv_hi < Skv;

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  if (n_items > 0) {
    // item j = (head g0 + j / n_live, q tile list[j % n_live])
    auto load_item = [&](int item, int stage) {
      const int head = kvh * G + g0 + item / n_live;
      const int q0 = (list[item % n_live] >> 2) * TILE;
      const uint32_t st = sbase + L::off_stage + stage * L::kStage;
      const size_t stat_row = ((size_t)b * Hq + head) * Sq;
      stage_rows<D, TILE>(st, q, b, q0, Sq, Hq, head, threadIdx.x, THREADS);
      stage_rows<D, TILE>(st + L::kTileBytes, dout, b, q0, Sq, Hq, head, threadIdx.x, THREADS);
      stage_words<TILE>(st + 2 * L::kTileBytes, lse + stat_row, q0, Sq, 0);
      stage_words<TILE>(st + 2 * L::kTileBytes + TILE * 4, delta + stat_row, q0, Sq, TILE);
      stage_words<TILE>(st + 2 * L::kTileBytes + 2 * TILE * 4, q_seg + (size_t)b * Sq, q0, Sq, 2 * TILE);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_items) load_item(s, s);
      cp_async_commit();
    }

    const int seg_lo = lo_ok ? kv_seg[(size_t)b * Skv + kv_lo] : 0;
    const int seg_hi = hi_ok ? kv_seg[(size_t)b * Skv + kv_hi] : 0;
    const int sub = warp >> 1;  // own kv tile of this warp's rows
    float st[16], dpt[16];      // S^T and dP^T of this warp's 16 kv rows, [4 j + e] as in dQ
#pragma unroll
    for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;

    for (int i = 0; i < n_items; ++i) {
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();
      __syncthreads();  // item i (and K/V) landed; every warp is done with item i - 1's stage
      if (i + STAGES - 1 < n_items) load_item(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      cp_async_commit();

      const int entry = list[i % n_live];
      const int q0 = (entry >> 2) * TILE;
      const unsigned char* stp = smem + L::off_stage + (i % STAGES) * L::kStage;
      const uint32_t qs = smem_addr(stp);
      const uint32_t dos = qs + L::kTileBytes;
      const float* lse_s = reinterpret_cast<const float*>(stp + 2 * L::kTileBytes);
      const float* delta_s = lse_s + TILE;
      const int* qseg_s = reinterpret_cast<const int*>(delta_s + TILE);

      // S^T = K Q^T and dP^T = V dO^T: OWN kv rows x TILE q rows, the whole warpgroup
      wgmma_pair<D>(st, dpt, sbase + L::off_k, qs, sbase + L::off_v, dos);
      if (!((entry >> sub) & 1)) continue;  // warp-uniform: this kv tile does not meet the q tile

      // p^T (selected to 0 outside the mask) and ds^T
      float pt[16], dst[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = (j >> 2) * 8 + tig * 2 + (j & 1);  // q row within the tile
        const bool lo = (j & 2) == 0;
        const int skv = lo ? seg_lo : seg_hi;
        const int kvpos = lo ? kv_lo : kv_hi;
        const bool ok = skv != 0 && qseg_s[col] == skv && (!causal || kvpos <= q0 + col);
        pt[j] = ok ? __expf(st[j] * scale - lse_s[col]) : 0.f;
        dst[j] = pt[j] * (dpt[j] - delta_s[col]);
      }

      // dV += P^T dO and dK += dS^T Q (dO and Q read transposed)
#pragma unroll
      for (int kc = 0; kc < TILE / 16; ++kc) {
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, &pt[8 * kc], &pt[8 * kc + 4]);
        acc_to_a(dsa, &dst[8 * kc], &dst[8 * kc + 4]);
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          uint32_t db[4], qb[4];
          ldmatrix_x4_trans(db, bt_frag_addr<D>(dos, kc * 16, dp2 * 16, lane));
          ldmatrix_x4_trans(qb, bt_frag_addr<D>(qs, kc * 16, dp2 * 16, lane));
          mma_16816(dv_acc[2 * dp2], pa, db[0], db[1]);
          mma_16816(dv_acc[2 * dp2 + 1], pa, db[2], db[3]);
          mma_16816(dk_acc[2 * dp2], dsa, qb[0], qb[1]);
          mma_16816(dk_acc[2 * dp2 + 1], dsa, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (n_split == 1) {
    if (lo_ok) {
      const size_t off = (((size_t)b * Skv + kv_lo) * Hkv + kvh) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + tig * 2) =
            pack_bf16x2(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + tig * 2) = pack_bf16x2(dv_acc[dt][0], dv_acc[dt][1]);
      }
    }
    if (hi_ok) {
      const size_t off = (((size_t)b * Skv + kv_hi) * Hkv + kvh) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + tig * 2) =
            pack_bf16x2(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + tig * 2) = pack_bf16x2(dv_acc[dt][2], dv_acc[dt][3]);
      }
    }
    return;
  }
  // fp32 partials of this split: (n_split, B, Skv, Hkv, D)
  const size_t part = (size_t)split * B * Skv * Hkv * D;
  if (lo_ok) {
    const size_t off = part + (((size_t)b * Skv + kv_lo) * Hkv + kvh) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<float2*>(part_dk + off + dt * 8 + tig * 2) = make_float2(dk_acc[dt][0], dk_acc[dt][1]);
      *reinterpret_cast<float2*>(part_dv + off + dt * 8 + tig * 2) = make_float2(dv_acc[dt][0], dv_acc[dt][1]);
    }
  }
  if (hi_ok) {
    const size_t off = part + (((size_t)b * Skv + kv_hi) * Hkv + kvh) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<float2*>(part_dk + off + dt * 8 + tig * 2) = make_float2(dk_acc[dt][2], dk_acc[dt][3]);
      *reinterpret_cast<float2*>(part_dv + off + dt * 8 + tig * 2) = make_float2(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

// Sums the n_split fp32 partials in split order into bf16 dk (times scale) and dv.
__global__ void __launch_bounds__(256)
flash_bwd_dkv_reduce_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, size_t n,
                            int n_split, float scale) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part_dk + s * n + i);
    const float4 y = *reinterpret_cast<const float4*>(part_dv + s * n + i);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  uint2 out_k = make_uint2(pack_bf16x2(a.x * scale, a.y * scale), pack_bf16x2(a.z * scale, a.w * scale));
  uint2 out_v = make_uint2(pack_bf16x2(c.x, c.y), pack_bf16x2(c.z, c.w));
  *reinterpret_cast<uint2*>(dk + i) = out_k;
  *reinterpret_cast<uint2*>(dv + i) = out_v;
}

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on the H100

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* q_seg, const void* kv_seg, const void* q_rng,
              const void* kv_rng, void* dq, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
              float scale, cudaStream_t stream) {
  const int smem = DqSmem<D>::bytes((Skv + TILE - 1) / TILE);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + OWN - 1) / OWN, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const int2*>(q_rng), static_cast<const int2*>(kv_rng),
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* q_seg, const void* kv_seg, const void* q_rng,
               const void* kv_rng, void* dk, void* dv, void* part_dk, void* part_dv, int B, int Sq,
               int Skv, int Hq, int Hkv, int n_split, int heads_per_split, int causal, float scale,
               cudaStream_t stream) {
  const int smem = DkvSmem<D>::bytes((Sq + TILE - 1) / TILE);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Skv + OWN - 1) / OWN, Hkv * n_split, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const int2*>(q_rng), static_cast<const int2*>(kv_rng),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(part_dk), static_cast<float*>(part_dv), B, Sq, Skv, Hq, Hkv, n_split,
      heads_per_split, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const size_t n = (size_t)B * Skv * Hkv * D;
  const unsigned blocks = static_cast<unsigned>((n / 4 + 255) / 256);
  flash_bwd_dkv_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part_dk), static_cast<const float*>(part_dv),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All return cudaGetLastError() after the launch (0 = launched).
// delta (B, Hq, Sq) fp32; q_rng (B, ceil(Sq/32), 2), kv_rng (B, ceil(Skv/32), 2) int32.
extern "C" int st_flash_bwd_prep(const void* dout, const void* o, const void* q_seg,
                                 const void* kv_seg, void* delta, void* q_rng, void* kv_rng, int B,
                                 int Sq, int Skv, int Hq, int D, void* stream) {
  if (D % 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = (size_t)B * Sq * Hq;
  const size_t delta_blocks = (rows + 31) / 32;
  const size_t tiles = (size_t)B * ((Sq + TILE - 1) / TILE + (Skv + TILE - 1) / TILE);
  const size_t blocks = delta_blocks + (tiles + 7) / 8;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_bwd_prep_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(o),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), static_cast<float*>(delta),
      static_cast<int2*>(q_rng), static_cast<int2*>(kv_rng), B, Sq, Skv, Hq, D,
      static_cast<int>(delta_blocks));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int st_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* q_seg,
                               const void* kv_seg, const void* q_rng, const void* kv_rng, void* dq,
                               int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      return launch_dq<80>(q, k, v, dout, lse, delta, q_seg, kv_seg, q_rng, kv_rng, dq, B, Sq, Skv, Hq,
                           Hkv, causal, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, q_rng, kv_rng, dq, B, Sq, Skv, Hq,
                            Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// part_dk / part_dv: fp32 (n_split, B, Skv, Hkv, D) scratch, read only when n_split > 1.
extern "C" int st_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* q_seg,
                                const void* kv_seg, const void* q_rng, const void* kv_rng, void* dk,
                                void* dv, void* part_dk, void* part_dv, int B, int Sq, int Skv,
                                int Hq, int Hkv, int D, int n_split, int heads_per_split, int causal,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || heads_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 80:
      return launch_dkv<80>(q, k, v, dout, lse, delta, q_seg, kv_seg, q_rng, kv_rng, dk, dv, part_dk,
                            part_dv, B, Sq, Skv, Hq, Hkv, n_split, heads_per_split, causal, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, q_rng, kv_rng, dk, dv, part_dk,
                             part_dv, B, Sq, Skv, Hq, Hkv, n_split, heads_per_split, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
