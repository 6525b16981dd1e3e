// Fused W8A8 matmul for Hopper (sm_90a): per-token int8 quantize of x, the
// int8 x int8 -> int32 dot against per-output-channel int8 weights, and the
// scale epilogue.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/int8_matmul.py:
//   `_kernel_resident_w` (#10) and `_kernel` (#11), reached through
//   `fused_w8a8_matmul`. Both compute one function; this file computes it in
//   the order of #10 and of the XLA path, `(float(acc) * xs) * ws`.
// Contract (the plain versions in ops/int8_matmul.py state the same function):
//   x (m, K) bf16 | fp32; w (N, K) int8, one row per output column (the
//   port's QuantLinear layout: the "col" B operand of the mma, no transpose);
//   ws (N,) fp32. Per row: xs = max(amax |x|, 1e-8) / 127 (an IEEE division),
//   xq = clip(rint(x / xs), +-127). acc = xq . w exactly in int32.
//   out = __fmul_rn(__fmul_rn(float(acc), xs), ws) in bf16 (round to nearest
//   even) or fp32. Bit-equal to the plain version on any device.
//   With `quantize` = 0 the caller passes xq and xs already made (the rows
//   the silu junction quantized) and the prologue does not run.
//
// What bounds it on the H100: at decode m (65 to 136 lanes) bytes — every
// weight byte is read once per call, 4.2 MB for the 3B o_proj up to 45 MB for
// gate_up, against 2 * m * N * K operations, far under the card's
// operations-per-byte balance; at prefill m (4,096 rows) operations — gate_up
// is 369 G int8 operations against 59 MB.
//
// Design:
// - The row quantize is a prologue kernel (one CTA per row), as in the
//   int4 MLP kernels: the TPU kernels quantize a block of rows once into VMEM
//   scratch that later grid steps reuse, but Hopper's blocks share nothing,
//   and each block recomputing the row amax would read the row once per
//   column tile. The prologue writes xq (m x K bytes) and xs once; they stay
//   in the 50 MB L2 for the main kernel. The wrapper counts both kernels as
//   one launch.
// - The main kernel is a tiled tensor-core GEMM: `mma.sync.m16n8k32` s8 x s8
//   into s32, fragments loaded with `ldmatrix` from shared memory, the A (xq)
//   and B (w) tiles staged by a 4-deep `cp.async` pipeline of 64-byte
//   k-slices, XOR-swizzled so `ldmatrix` reads hit 8 different bank groups.
//   Rows beyond m, columns beyond N and the k tail beyond K zero-fill
//   (`cp.async` with a source size of 0), so any m >= 1 runs unpadded and K
//   need only be a multiple of 32.
// - Two tile shapes: m <= 256 (decode) 64 x 64 tiles with 4 warps, so a
//   2048-column linear still spreads over 32 column tiles per 64 rows;
//   larger m (prefill) 128 x 128 tiles with 8 warps. The grid runs the row
//   tiles of one column tile next to each other, so a weight tile read from
//   HBM by one is read from L2 by the others.
// What it does not do yet: `wgmma` / TMA, split-K for the long-K short-N
// decode shapes (down_proj: 32 column tiles x 172 k-slices in series), a
// persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-8f;
constexpr int QTHREADS = 256;
constexpr int BK = 64;      // bytes of K per pipeline stage: two mma k-steps
constexpr int STAGES = 4;
constexpr int SMALL_M = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One CTA per row: xs = max(amax, eps) / 127, xq = clip(rint(x / xs)).
template <typename InT>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const InT* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int k) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const InT* xr = x + (size_t)row * k;
  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += QTHREADS) amax = fmaxf(amax, fabsf(to_float(xr[i])));
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  __shared__ float warp_max[QTHREADS / 32];
  __shared__ float row_scale;
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int w = 0; w < QTHREADS / 32; ++w) v = fmaxf(v, warp_max[w]);
    row_scale = fmaxf(v, EPS) / 127.0f;  // IEEE division, as the plain version
    xs[row] = row_scale;
  }
  __syncthreads();
  const float s = row_scale;
  int8_t* qr = xq + (size_t)row * k;
  for (int i = threadIdx.x; i < k; i += QTHREADS)
    qr[i] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(to_float(xr[i]) / s), -127.f), 127.f)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D = A (16x32 s8, row) * B (32x8 s8, col) + D, s32.
__device__ __forceinline__ void mma_s8s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c (0..3) of row r in a tile of 64-byte rows.
// The XOR spreads the 8 rows one `ldmatrix` phase reads (same c) over the
// 8 16-byte bank groups of a 128-byte line pair.
__device__ __forceinline__ int swz(int r, int c) { return r * BK + ((c ^ ((r >> 1) & 3)) << 4); }

// One k-slice (BK bytes) of `rows` rows of a (total, K) int8 matrix into a tile.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_slice(const int8_t* __restrict__ src, int row0, int total, int k,
                                           int k0, uint32_t tile) {
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * 4; i += THREADS) {
    const int r = i >> 2, c = i & 3;
    const int gr = row0 + r, gk = k0 + c * 16;
    const bool live = gr < total && gk < k;
    const int8_t* p = live ? src + (size_t)gr * k + gk : src;
    cp_async16(tile + swz(r, c), p, live ? 16 : 0);
  }
}

// CTA tile BM x BN, WM x WN warps, warp tile (BM/WM) x (BN/WN).
template <int BM, int BN, int WM, int WN, typename OutT>
__global__ void __launch_bounds__(WM * WN * 32)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ w, const float* __restrict__ ws, OutT* __restrict__ out,
                 int m, int n, int k) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int MT = BM / WM / 16;  // m16 tiles per warp
  constexpr int NT = BN / WN / 8;   // n8 tiles per warp
  static_assert(NT % 2 == 0, "B fragments load two n-tiles per ldmatrix.x4");
  extern __shared__ __align__(128) int8_t smem[];
  const uint32_t a_base = smem_addr(smem);
  const uint32_t b_base = a_base + STAGES * BM * BK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_k = (k + BK - 1) / BK;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) {
      load_slice<BM, THREADS>(xq, m0, m, k, s * BK, a_base + s * BM * BK);
      load_slice<BN, THREADS>(w, n0, n, k, s * BK, b_base + s * BN * BK);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt landed for every thread; slot (kt - 1) % STAGES is free
    const int pre = kt + STAGES - 1;
    if (pre < n_k) {
      const int slot = pre % STAGES;
      load_slice<BM, THREADS>(xq, m0, m, k, pre * BK, a_base + slot * BM * BK);
      load_slice<BN, THREADS>(w, n0, n, k, pre * BK, b_base + slot * BN * BK);
    }
    cp_async_commit();

    const int slot = kt % STAGES;
    const uint32_t a_tile = a_base + slot * BM * BK;
    const uint32_t b_tile = b_base + slot * BN * BK;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // two k32 steps per 64-byte slice
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // lanes 0-15: rows 0-15 of the m-tile, low 16 k-bytes; 16-31: high
        const int r = wm * (BM / WM) + i * 16 + (lane & 15);
        ldmatrix_x4(af[i], a_tile + swz(r, ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // lanes 0-7 / 8-15: n rows 0-7, low / high k-bytes; 16-31: n rows 8-15
        const int r = wn * (BN / WN) + j * 8 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t bf[4];
        ldmatrix_x4(bf, b_tile + swz(r, ks * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8s8(acc[i][j], af[i], bf[0], bf[1]);
          mma_s8s8(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  // epilogue: (float(acc) * xs) * ws, each product rounded (no contraction)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * (BM / WM) + i * 16 + gid + h * 8;
      if (r >= m) continue;
      const float sx = xs[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wn * (BN / WN) + j * 8 + tig * 2;
        if (c >= n) continue;  // n % 8 == 0: c and c + 1 are both in or both out
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), sx), ws[c]);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sx), ws[c + 1]);
        OutT* dst = out + (size_t)r * n + c;
        if constexpr (sizeof(OutT) == 4) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, typename OutT>
int launch_gemm(const void* xq, const void* xs, const void* w, const void* ws, void* out, int m, int n,
                int k, cudaStream_t s) {
  constexpr int smem = STAGES * (BM + BN) * BK;
  auto kernel = int8_gemm_kernel<BM, BN, WM, WN, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kernel<<<grid, WM * WN * 32, smem, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs), static_cast<const int8_t*>(w),
      static_cast<const float*>(ws), static_cast<OutT*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_tiles(const void* xq, const void* xs, const void* w, const void* ws, void* out, int m, int n,
                 int k, cudaStream_t s) {
  if (m <= SMALL_M) return launch_gemm<64, 64, 2, 2, OutT>(xq, xs, w, ws, out, m, n, k, s);
  return launch_gemm<128, 128, 2, 4, OutT>(xq, xs, w, ws, out, m, n, k, s);
}

}  // namespace

// x (m, k) bf16 (x_f32 = 0) | fp32; scratch xq int8 (m, k) and xs fp32 (m,)
// allocated by the caller (with quantize = 0 they hold the caller's
// quantized rows and x is not read); w (n, k) int8; ws (n,) fp32; out (m, n)
// bf16 | fp32 (out_f32). Launches the prologue (quantize = 1) and the GEMM on
// `stream`; returns cudaGetLastError() after the launches (0 = launched).
extern "C" int st_int8_matmul(const void* x, int x_f32, void* xq, void* xs, const void* w, const void* ws,
                              void* out, int out_f32, int m, int n, int k, int quantize, void* stream) {
  if (m < 1 || n < 8 || k < 32 || k % 32 != 0 || n % 8 != 0 || (n + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantize) {
    if (x_f32)
      quantize_rows_kernel<float><<<m, QTHREADS, 0, s>>>(static_cast<const float*>(x),
                                                        static_cast<int8_t*>(xq), static_cast<float*>(xs), k);
    else
      quantize_rows_kernel<__nv_bfloat16><<<m, QTHREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (out_f32) return launch_tiles<float>(xq, xs, w, ws, out, m, n, k, s);
  return launch_tiles<__nv_bfloat16>(xq, xs, w, ws, out, m, n, k, s);
}
