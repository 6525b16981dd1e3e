// Helpers shared by the flash forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels: bf16 packing, cp.async staging into
// wgmma's no-swizzle core-matrix layout, the K-major shared-memory
// descriptor, and the segment-id range tables both directions skip tiles by.
//
// Range table layout: int32 (B, ceil(S / TILE), 2), TILE = 32 rows; entry
// t = {lo, hi}, the smallest and largest nonzero segment id of rows
// [t*TILE, (t+1)*TILE); a tile with no nonzero id holds {INT_MAX, INT_MIN},
// which meets nothing. Two disjoint ranges share no nonzero id, so skipping
// a pair of tiles whose ranges do not intersect is exact for any layout.

#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;  // rows per range-table tile

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 / 4 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// cp.async writes (generic proxy) become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from touching d across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator layout of two n8 tiles is the A layout of one k16 chunk
// (mma.sync's, and wgmma's per warp of its 16 rows).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* lo, const float* hi) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
}

// Byte offset of the core matrix holding (row, col) (both multiples of 8) in
// a tile of D-wide rows: 8-row blocks of D/8 core matrices of 128 bytes
// (8 rows x 16 bytes, contiguous).
template <int D>
__device__ __forceinline__ int block_offset(int row, int col) {
  return (row >> 3) * (D * 16) + (col >> 3) * 128;
}

// wgmma shared-memory descriptor, no swizzle, K-major: core matrices LBO
// = 128 bytes apart along K, SBO = D * 16 bytes apart along M / N.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((D * 16) >> 4) << 32);
}

// Stage ROWS rows from row0 (zero-filled past S) of head h of a (B, S, H, D)
// bf16 tensor into a shared tile in the core-matrix layout: 16-byte chunks
// spread over threads t of [0, n_threads), chunk (r, c) to row r % 8 of its
// core matrix.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                           int b, int row0, int S, int H, int h, int t, int n_threads) {
  constexpr int CH = D / 8;
#pragma unroll 2
  for (int i = t; i < ROWS * CH; i += n_threads) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int gr = row0 + r;
    const bool live = gr < S;
    const __nv_bfloat16* p = live ? src + (((size_t)b * S + gr) * H + h) * D + c : src;
    cp_async16(dst + block_offset<D>(r & ~7, c) + (r & 7) * 16, p, live ? 16 : 0);
  }
}

// Stage N 32-bit words (zero-filled past `limit`) starting at src[row0],
// one word per thread of [t0, t0 + N).
template <int N>
__device__ __forceinline__ void stage_words(uint32_t dst, const void* __restrict__ src, int row0,
                                            int limit, int t0) {
  const int i = threadIdx.x - t0;
  if (i >= 0 && i < N) {
    const bool live = row0 + i < limit;
    const int* p = static_cast<const int*>(src) + (live ? row0 + i : 0);
    cp_async4(dst + i * 4, p, live ? 4 : 0);
  }
}

__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) { return max(a.x, b.x) <= min(a.y, b.y); }

// One warp writes range-table entry `idx` (of B * n_t) of a (B, S) id tensor.
__device__ __forceinline__ void write_tile_range(const int* __restrict__ seg, int S, int n_t, int idx,
                                                 int2* __restrict__ rng) {
  const int lane = threadIdx.x & 31;
  const int b = idx / n_t;
  const int pos = (idx % n_t) * TILE + lane;
  const int id = pos < S ? seg[(size_t)b * S + pos] : 0;
  int lo = id != 0 ? id : INT_MAX;
  int hi = id != 0 ? id : INT_MIN;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) rng[idx] = make_int2(lo, hi);
}

// The range tables of q_seg and kv_seg, one warp per tile from warp `tile`:
// first the B * nQt tiles of q_seg, then the B * nKt tiles of kv_seg.
__device__ __forceinline__ void write_ranges(const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                                             int2* __restrict__ q_rng, int2* __restrict__ kv_rng, int B,
                                             int Sq, int Skv, int tile) {
  const int n_qt = (Sq + TILE - 1) / TILE;
  const int n_kt = (Skv + TILE - 1) / TILE;
  if (tile >= B * (n_qt + n_kt)) return;  // warp-uniform
  if (tile < B * n_qt) write_tile_range(q_seg, Sq, n_qt, tile, q_rng);
  else write_tile_range(kv_seg, Skv, n_kt, tile - B * n_qt, kv_rng);
}

}  // namespace
