// Helpers shared by the kernels that feed shared memory through mbarriers,
// bulk copies and TMA, and meet in thread-block clusters: the dense decode
// split kernel (decode_attention.cu), the paged split kernel
// (paged_attention.cu), kernel A (int8_matmul.cu) and the int4 MLP kernels
// (int4_mlp.cu).

#pragma once

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
