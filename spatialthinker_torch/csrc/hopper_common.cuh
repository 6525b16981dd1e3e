// Helpers shared by the kernels that feed shared memory through mbarriers,
// bulk copies and TMA, and meet in thread-block clusters: the dense decode
// split kernels (decode_attention.cu), the paged split kernels
// (paged_attention.cu), kernel A (int8_matmul.cu) and the int4 MLP kernels
// (int4_mlp.cu); and the `mma.sync` fragment helpers both attention files use.

#pragma once

#include <cuda_bf16.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder comes through the runtime)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

// max / sum over the 8 lanes of a column of an mma fragment (the lanes of one tig)
__device__ __forceinline__ float gid_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}
__device__ __forceinline__ float gid_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mma.sync fragments (gid = lane / 4, tig = lane % 4) ----
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
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// r[j] = bytes (row j, columns 0..3) -> c[col] = bytes (rows 0..3, column col)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}
// The low (hi = false) or high nibbles of bytes bx and by (0-3 of x, 4-7 of y) as a bf16 pair, bx's in
// the low half: exact (the bf16 bits 0x4300 | u are 128 + u)
__device__ __forceinline__ uint32_t nib_pair(uint32_t x, uint32_t y, int bx, int by, bool hi) {
  const uint32_t t = __byte_perm(x, y, bx | (by << 8));
  const uint32_t n = ((hi ? t >> 4 : t) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&n), __float2bfloat162_rn(128.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- mbarriers and bulk copies ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned) in one bulk copy that completes `bar`'s transaction bytes
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// A box of a 2-D `map` at (inner coordinate c0, outer c1) into shared memory;
// completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// ---- programmatic dependent launch ----
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// Waits for the grid this one depends on programmatically (a prologue);
// returns at once when there is none.
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// ---- distributed shared memory of a cluster ----
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// this CTA's shared address `p` in cluster rank `rank`'s shared memory, as a
// generic pointer (plain loads the compiler can overlap)
__device__ __forceinline__ const float* rank_ptr(const float* p, int rank, int n) {
  return n == 1 ? p : static_cast<const float*>(__cluster_map_shared_rank(const_cast<float*>(p), rank));
}

// ---- wgmma ----
// Descriptor of a K-major operand tile of 128-byte rows with the 128-byte
// swizzle (as TMA writes it): 8-row atoms SBO = 1024 bytes apart (LBO unused
// for a swizzled K-major operand), layout type 1 (128B swizzle) in bits 62-63.
// Advancing the start address by 32 bytes selects the next k32 step of the
// row; the tile's atoms are 1024-byte aligned, so the hardware's swizzle
// phase stays right.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from reading the accumulator before the wait.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- TMA tensor maps (host) ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to libcuda).
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
