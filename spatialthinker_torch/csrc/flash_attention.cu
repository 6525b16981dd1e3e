// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v, fp32 online
// softmax, GQA, segment-id + causal masking, per-row logsumexp.
//
// Replaces the Pallas TPU kernel spatialthinker_tpu/ops/flash_attention.py
// `_fwd_kernel_gqa` (:45, launched by `_flash_fwd` at :139). Same contract:
//   q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) bf16, contiguous, D = 80 or 128,
//   any G = Hq / Hkv, any Sq, Skv and causal_offset;
//   q_seg (B, Sq), kv_seg (B, Skv) int32 -- a query attends a key iff both
//   segment ids are equal and nonzero and, when causal,
//   kv_pos <= causal_offset + q_pos;
//   o (B, Sq, Hq, D) bf16, lse (B, Hq, Sq) fp32 (natural log).
//   A fully masked row gives o = 0 and lse = -1e30.
//   P is rounded to bf16 for the PV product; scores, softmax state and the
//   output accumulator stay fp32.
//
// What bounds it on the H100: tensor-core work on the (q row, kv row) pairs
// that can be unmasked, 4 * D flops per pair and query head, against O(S * D)
// bytes. The main path packs many images or samples into one sequence: at the
// update's vision pack (8 images in 16,384 slots) 7.3% of the pairs are
// unmasked, at a log-prob piece (16 images in 32,768 slots) 3.6%; text rows
// pack 2-3 samples under a causal mask. The design:
//
// 1. Tile skip. st_flash_fwd first launches flash_ranges_kernel, which writes
//    the range tables of q_seg and kv_seg (flash_common.cuh: per 32-row tile
//    the smallest and largest nonzero id; one C call for both launches keeps
//    the host's share of a short call small). Each CTA compacts the list of
//    BN-row kv tiles whose range meets the range of one of its warpgroups' BM
//    q rows and, when causal, that start at or before the diagonal of the
//    warpgroup's last row (kv_tile_start <= causal_offset + last_row), then
//    walks only that list. Exact for any layout: unsorted or repeated ids,
//    Sq != Skv with an offset (the chunked prefill), left padding. A CTA
//    whose list is empty writes zeros and -1e30.
// 2. Asynchronous staging. K, V and the kv segment ids of the listed tiles
//    stream through a STAGES-deep cp.async ring (rows past Skv zero-filled;
//    two stages when the kv side has at most two tiles, so that the vision
//    windows' CTAs fit four to an SM), so the next tiles' copies are in
//    flight while the current tile's products run. Tiles are stored in
//    wgmma's no-swizzle core-matrix layout (flash_common.cuh block_offset:
//    8 rows x 16 bytes per core matrix), which wgmma reads without bank
//    conflicts for D = 80 and 128; V needs no transpose: PV reads it
//    MN-major through wgmma's transpose bit.
// 3. Tensor cores. Per kv tile and warpgroup, S = Q K^T is D/16 wgmma
//    m64n64k16 with A = the warpgroup's BM q rows and B = the K tile, both
//    K-major in shared memory; O += P V is BN/16 wgmma m64nDk16 with A = P
//    from registers (S's accumulator rounded to bf16: the accumulator layout
//    of a warp's 16 rows is the A-fragment layout) and B = the V tile
//    MN-major (N = 80 is a legal wgmma width: ten core matrices along N).
// 4. Heads. A CTA holds two warpgroups (one when G = 1 and Sq <= BM) that
//    share every staged K/V tile. With G >= 2 the two warpgroups take two
//    query heads of the kv group at the same BM q rows, so one K/V tile read
//    feeds both heads, as the TPU kernel's G-batched program feeds G; more
//    heads per CTA would not fit: at D = 128 a warpgroup holds a 64-register
//    O accumulator and a 32-register S accumulator per thread. With G = 1
//    (vision) they take two consecutive BM-row blocks of the same head.
// 5. Less per-element work. A warp whose 16 rows hold one nonzero id skips
//    the mask on a kv tile that holds only that id and lies wholly below the
//    causal diagonal (a warp vote on the staged ids). Scores are scaled by
//    scale * log2(e) once and exponentiated with ex2; masked cells are
//    selected to p = 0 (a dead row keeps a finite running max). O leaves
//    through shared memory as 16-byte stores.

#include "flash_common.cuh"

namespace {

constexpr int BM = 64;       // q rows of one warpgroup (one wgmma M tile)
constexpr int BN = 64;       // kv rows per streamed tile
constexpr int MAX_WG = 2;    // warpgroups per CTA
constexpr int STAGES = 3;    // depth of the cp.async ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on the H100

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor, no swizzle, MN-major (B read through the
// transpose bit): a core matrix holds 8 K-rows of 8 N-contiguous values (16
// bytes each); core matrices LBO = D * 16 bytes apart along K (the next 8 kv
// rows of a tile in block_offset layout), SBO = 128 bytes apart along N.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((D * 16) >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// D(64 x 64, fp32) (+)= A(64 x 16) B(64 x 16)^T, both bf16 K-major in shared
// memory; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 80, fp32) += A(64 x 16) B(16 x 80): A as bf16 fragments in registers,
// B bf16 MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, fp32) += A(64 x 16) B(16 x 128): A as bf16 fragments in registers,
// B bf16 MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(D == 80 || D == 128, "the forward is built for head dims 80 and 128");
  if constexpr (D == 80) wgmma_m64n80k16_rs(o, a, db);
  else wgmma_m64n128k16_rs(o, a, db);
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Union of the range-table entries [first, first + n) clipped to [0, n_t).
__device__ __forceinline__ int2 range_union(const int2* __restrict__ rng, int first, int n, int n_t) {
  int2 r = make_int2(INT_MAX, INT_MIN);
  for (int t = first; t < min(first + n, n_t); ++t) {
    const int2 x = rng[t];
    r.x = min(r.x, x.x);
    r.y = max(r.y, x.y);
  }
  return r;
}

// Shared memory of a CTA with n_wg warpgroups and a ring of `stages` tiles:
// each warpgroup's BM Q rows (its O rows at the end), the ring, the warps'
// counts and the tile list.
template <int D>
struct FwdSmem {
  static constexpr int kQBytes = BM * D * 2;        // core-matrix layout, no padding
  static constexpr int kTileBytes = BN * D * 2;
  static constexpr int kStage = 2 * kTileBytes + BN * 4;  // K, V, kv segment ids
  __host__ __device__ static int off_stage(int n_wg) { return n_wg * kQBytes; }
  __host__ __device__ static int off_warp_n(int n_wg, int stages) { return off_stage(n_wg) + stages * kStage; }
  __host__ __device__ static int off_list(int n_wg, int stages) { return off_warp_n(n_wg, stages) + 4 * 4 * MAX_WG; }
  __host__ __device__ static int bytes(int n_wg, int stages, int n_list) {
    return off_list(n_wg, stages) + 4 * n_list;
  }
};

// One CTA: n_wg = blockDim.x / 128 warpgroups; warpgroup w takes query head
// g = sub * heads_per_cta + w % heads_per_cta of kv head kvh and the BM q rows
// from (blockIdx.x * (n_wg / heads_per_cta) + w / heads_per_cta) * BM.
template <int D>
__global__ void __launch_bounds__(MAX_WG * 128, D == 80 ? 2 : 1)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, const int2* __restrict__ q_rng,
                 const int2* __restrict__ kv_rng, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int Hq, int Hkv, int heads_per_cta, int stages, int causal,
                 int causal_offset, float scale_log2) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  const int n_wg = blockDim.x >> 7;
  int* warp_n = reinterpret_cast<int*>(smem + L::off_warp_n(n_wg, stages));
  int* list = reinterpret_cast<int*>(smem + L::off_list(n_wg, stages));

  const int G = Hq / Hkv;
  const int n_sub = (G + heads_per_cta - 1) / heads_per_cta;
  const int row_blocks = n_wg / heads_per_cta;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / n_sub;
  const int sub = blockIdx.y % n_sub;
  const int wg = threadIdx.x >> 7;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n_qt = (Sq + TILE - 1) / TILE;
  const int n_kt = (Skv + TILE - 1) / TILE;
  const int n_tiles = (Skv + BN - 1) / BN;

  auto wg_head = [&](int w) { return sub * heads_per_cta + w % heads_per_cta; };
  auto wg_row0 = [&](int w) { return (blockIdx.x * row_blocks + w / heads_per_cta) * BM; };
  const int g = wg_head(wg);
  const int head = kvh * G + g;
  const int q0 = wg_row0(wg);
  const bool wg_live = g < G && q0 < Sq;  // warpgroup-uniform
  const uint32_t q_tile = sbase + wg * L::kQBytes;
  if (wg_live) stage_rows<D, BM>(q_tile, q, b, q0, Sq, Hq, head, threadIdx.x & 127, 128);
  cp_async_commit();

  // The list of kv tiles to walk: entry t * 4 + bits, bit w set when warpgroup
  // w's rows meet kv tile t (ranges intersect; when causal, the tile starts at
  // or before the diagonal of the warpgroup's last row).
  int n_live = 0;
  {
    const int2 dead = make_int2(INT_MAX, INT_MIN);
    int2 own[MAX_WG];
    int own_last[MAX_WG];
#pragma unroll
    for (int w = 0; w < MAX_WG; ++w) {
      const int r0 = wg_row0(w);
      const bool live = w < n_wg && wg_head(w) < G && r0 < Sq;
      own[w] = live ? range_union(q_rng + (size_t)b * n_qt, r0 / TILE, BM / TILE, n_qt) : dead;
      own_last[w] = min(r0 + BM, Sq) - 1;
    }
    const int n_warps = blockDim.x >> 5;
    for (int base = 0; base < n_tiles; base += blockDim.x) {
      const int t = base + threadIdx.x;
      int bits = 0;
      if (t < n_tiles) {
        const int2 r = range_union(kv_rng + (size_t)b * n_kt, t * (BN / TILE), BN / TILE, n_kt);
#pragma unroll
        for (int w = 0; w < MAX_WG; ++w)
          if (ranges_meet(own[w], r) && (!causal || t * BN <= causal_offset + own_last[w])) bits |= 1 << w;
      }
      const unsigned m = __ballot_sync(0xffffffffu, bits != 0);
      if (lane == 0) warp_n[warp] = __popc(m);
      __syncthreads();
      int before = n_live;
      int total = n_live;
      for (int w = 0; w < n_warps; ++w) {
        before += w < warp ? warp_n[w] : 0;
        total += warp_n[w];
      }
      if (bits) list[before + __popc(m & ((1u << lane) - 1u))] = t * 4 + bits;
      n_live = total;
      __syncthreads();  // warp_n is rewritten by the next round; list is complete after the last
    }
  }

  // this thread's two rows (gid, gid + 8 of its warp's 16) and their ids
  const int wrow = (warp & 3) * 16;
  const int r_lo = q0 + wrow + gid;
  const int r_hi = r_lo + 8;
  const int seg_lo = wg_live && r_lo < Sq ? q_seg[(size_t)b * Sq + r_lo] : 0;
  const int seg_hi = wg_live && r_hi < Sq ? q_seg[(size_t)b * Sq + r_hi] : 0;
  // the id all 16 rows of the warp share, 0 if they do not (or one is padding)
  const int seg0 = __shfl_sync(0xffffffffu, seg_lo, 0);
  const int warp_id = __all_sync(0xffffffffu, seg_lo == seg0 && seg_hi == seg0) ? seg0 : 0;

  float acc[D / 2];  // O of the warp's 16 rows: n-tile j of 8 columns, element e at [4 j + e]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;  // max in log2 units

  if (n_live > 0) {
    auto load_tile = [&](int item, int stage) {
      const int kv0 = (list[item] >> 2) * BN;
      const uint32_t st = sbase + L::off_stage(n_wg) + stage * L::kStage;
      stage_rows<D, BN>(st, k, b, kv0, Skv, Hkv, kvh, threadIdx.x, blockDim.x);
      stage_rows<D, BN>(st + L::kTileBytes, v, b, kv0, Skv, Hkv, kvh, threadIdx.x, blockDim.x);
      stage_words<BN>(st + 2 * L::kTileBytes, kv_seg + (size_t)b * Skv, kv0, Skv, 0);
    };
    for (int s = 0; s < stages - 1; ++s) {
      if (s < n_live) load_tile(s, s);
      cp_async_commit();
    }

    float s[BN / 2];  // S, then P, of the warp's 16 rows: [4 j + e] as acc
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] = 0.f;
#pragma unroll 1
    for (int i = 0; i < n_live; ++i) {
      if (stages == STAGES) cp_async_wait<STAGES - 2>();
      else cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // tile i landed; every warpgroup is done with tile i - 1's stage
      if (i + stages - 1 < n_live) load_tile(i + stages - 1, (i + stages - 1) % stages);
      cp_async_commit();

      const int entry = list[i];
      if (!((entry >> wg) & 1)) continue;  // warpgroup-uniform: its rows cannot meet this tile
      const int kv0 = (entry >> 2) * BN;
      const unsigned char* stp = smem + L::off_stage(n_wg) + (i % stages) * L::kStage;
      const uint32_t ks = smem_addr(stp);
      const uint32_t vs = ks + L::kTileBytes;
      const int* segs = reinterpret_cast<const int*>(stp + 2 * L::kTileBytes);

      // S = Q K^T: BM x BN, the warpgroup
      fence_regs(s);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_m64n64k16_ss(s, kmajor_desc<D>(q_tile + kc * 256), kmajor_desc<D>(ks + kc * 256), kc > 0);
      wgmma_commit_wait();
      fence_regs(s);

      // wholly unmasked for this warp: one id on both sides, below the diagonal
      bool full = false;
      if (warp_id != 0)
        full = __all_sync(0xffffffffu, segs[lane] == warp_id && segs[lane + 32] == warp_id) &&
               (!causal || kv0 + BN - 1 <= causal_offset + q0 + wrow);
      // bit j of `live` marks an attended cell; scores to log2 units
      uint32_t live = 0xffffffffu;
      float mx_lo = NEG_INF, mx_hi = NEG_INF;
      if (full) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          s[j] *= scale_log2;
          if (j & 2) mx_hi = fmaxf(mx_hi, s[j]);
          else mx_lo = fmaxf(mx_lo, s[j]);
        }
      } else {
        live = 0u;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          const int2 ids = *reinterpret_cast<const int2*>(segs + nt * 8 + tig * 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = nt * 4 + e;
            const bool lo = e < 2;
            const int sq = lo ? seg_lo : seg_hi;
            const int kpos = kv0 + nt * 8 + tig * 2 + (e & 1);
            const bool ok = sq != 0 && ((e & 1) ? ids.y : ids.x) == sq &&
                            (!causal || kpos <= causal_offset + (lo ? r_lo : r_hi));
            s[j] = ok ? s[j] * scale_log2 : NEG_INF;
            live |= ok ? 1u << j : 0u;
            if (lo) mx_lo = fmaxf(mx_lo, s[j]);
            else mx_hi = fmaxf(mx_hi, s[j]);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo);
      const float mn_hi = fmaxf(m_hi, mx_hi);
      const float corr_lo = exp2_approx(m_lo - mn_lo);
      const float corr_hi = exp2_approx(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        const bool lo = (j & 2) == 0;
        const float p = (live >> j) & 1u ? exp2_approx(s[j] - (lo ? mn_lo : mn_hi)) : 0.f;
        s[j] = p;
        if (lo) sum_lo += p;
        else sum_hi += p;
      }
      // per-thread partial row sums; the quad reduction happens once at the end
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? corr_hi : corr_lo;
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) acc_to_a(pa[kc], &s[8 * kc], &s[8 * kc + 4]);

      // O += P V: the warpgroup, V read MN-major (16 kv rows = two core-matrix rows per k16 step)
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) wgmma_pv<D>(acc, pa[kc], mnmajor_desc<D>(vs + kc * 2 * D * 16));
      wgmma_commit_wait();
      fence_regs(acc);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  __syncthreads();  // every thread's copies into the Q tiles have landed
  // O / l into the warpgroup's Q tile (core-matrix layout), then 16-byte rows out
  unsigned char* ot = smem + wg * L::kQBytes;
  if (wg_live) {
    const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
    const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(ot + block_offset<D>(wrow, col) + gid * 16 + tig * 4) =
          pack_bf16x2(acc[4 * dt] * inv_lo, acc[4 * dt + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(ot + block_offset<D>(wrow + 8, col) + gid * 16 + tig * 4) =
          pack_bf16x2(acc[4 * dt + 2] * inv_hi, acc[4 * dt + 3] * inv_hi);
    }
    if (tig == 0) {
      float* lse_row = lse + ((size_t)b * Hq + head) * Sq;
      if (r_lo < Sq) lse_row[r_lo] = l_lo == 0.f ? NEG_INF : m_lo * LN2 + logf(l_lo);
      if (r_hi < Sq) lse_row[r_hi] = l_hi == 0.f ? NEG_INF : m_hi * LN2 + logf(l_hi);
    }
  }
  __syncthreads();  // the O tiles are written
  if (!wg_live) return;
  constexpr int CH = D / 8;
  for (int i = threadIdx.x & 127; i < BM * CH; i += 128) {
    // eight consecutive threads read one core matrix (conflict-free) and write eight rows
    const int r = (i / (8 * CH)) * 8 + (i & 7);
    const int c = ((i >> 3) % CH) * 8;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(o + (((size_t)b * Sq + q0 + r) * Hq + head) * D + c) =
          *reinterpret_cast<const uint4*>(ot + block_offset<D>(r & ~7, c) + (r & 7) * 16);
  }
}

__global__ void __launch_bounds__(256)
flash_ranges_kernel(const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int2* __restrict__ q_rng,
                    int2* __restrict__ kv_rng, int B, int Sq, int Skv) {
  write_ranges(q_seg, kv_seg, q_rng, kv_rng, B, Sq, Skv, blockIdx.x * 8 + (threadIdx.x >> 5));
}

int launch_ranges(const void* q_seg, const void* kv_seg, void* q_rng, void* kv_rng, int B, int Sq, int Skv,
                  cudaStream_t stream) {
  const size_t tiles = (size_t)B * ((Sq + TILE - 1) / TILE + (Skv + TILE - 1) / TILE);
  const size_t blocks = (tiles + 7) / 8;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_ranges_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), static_cast<int2*>(q_rng),
      static_cast<int2*>(kv_rng), B, Sq, Skv);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* q_seg, const void* kv_seg,
           const void* q_rng, const void* kv_rng, void* o, void* lse, int B, int Sq, int Skv, int Hq,
           int Hkv, int causal, int causal_offset, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int heads_per_cta = G >= 2 ? 2 : 1;
  const int n_wg = heads_per_cta == 2 || Sq > BM ? 2 : 1;
  const int rows = BM * (n_wg / heads_per_cta);
  const int n_sub = (G + heads_per_cta - 1) / heads_per_cta;
  const int n_tiles = (Skv + BN - 1) / BN;
  const int stages = n_tiles > 2 ? STAGES : 2;  // a short kv side needs no deeper ring: more CTAs per SM
  const int smem = FwdSmem<D>::bytes(n_wg, stages, n_tiles);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + rows - 1) / rows, Hkv * n_sub, B);
  flash_fwd_kernel<D><<<grid, 128 * n_wg, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const int2*>(q_rng), static_cast<const int2*>(kv_rng), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, heads_per_cta, stages, causal, causal_offset, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the last launch (0 = launched).
// q_rng (B, ceil(Sq/32), 2), kv_rng (B, ceil(Skv/32), 2) int32: the range tables.
extern "C" int st_flash_ranges(const void* q_seg, const void* kv_seg, void* q_rng, void* kv_rng, int B,
                               int Sq, int Skv, void* stream) {
  return launch_ranges(q_seg, kv_seg, q_rng, kv_rng, B, Sq, Skv, static_cast<cudaStream_t>(stream));
}

// Two launches: the range tables into `ranges` (q's (B, ceil(Sq/32), 2), then
// kv's (B, ceil(Skv/32), 2), int32), then the forward reading them.
extern "C" int st_flash_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                            const void* kv_seg, void* ranges, void* o, void* lse, int B, int Sq, int Skv,
                            int Hq, int Hkv, int D, int causal, int causal_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 80 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  int2* q_rng = static_cast<int2*>(ranges);
  int2* kv_rng = q_rng + (size_t)B * ((Sq + TILE - 1) / TILE);
  const int rc = launch_ranges(q_seg, kv_seg, q_rng, kv_rng, B, Sq, Skv, s);
  if (rc != 0) return rc;
  if (D == 80)
    return launch<80>(q, k, v, q_seg, kv_seg, q_rng, kv_rng, o, lse, B, Sq, Skv, Hq, Hkv, causal,
                      causal_offset, scale, s);
  return launch<128>(q, k, v, q_seg, kv_seg, q_rng, kv_rng, o, lse, B, Sq, Skv, Hq, Hkv, causal,
                     causal_offset, scale, s);
}
