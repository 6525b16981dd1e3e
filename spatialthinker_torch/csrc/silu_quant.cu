// The SwiGLU junction of the W8A8 prefill MLP for Hopper (sm_90a):
// silu(gate) * up fused with the per-row int8 quantize that feeds the down
// projection.
//
// Replaces the Pallas TPU kernel `_silu_quant_kernel` of
// spatialthinker_tpu/ops/int8_matmul.py (launched by `fused_silu_quantize`).
// Contract: gu (M, 2I) bf16 | fp16 | fp32, gate columns first, rows `stride`
// values apart; q (M, I) int8 and s (M) fp32 with, in fp32,
//   h = g * sigmoid(g) * u,  s = max(amax_row(|h|), 1e-8) / 127,
//   q = clip(round_half_even(h / s), -127, 127).
// The arithmetic is the plain PyTorch version's on the card, operation for
// operation: sigmoid as 1 / (1 + exp(-g)) with IEEE division, the two
// products rounded in turn, h / s an IEEE division (the plain version
// divides by a tensor), and the scale a product with the fp32 reciprocal of
// 127 (the plain version divides by a Python scalar, which PyTorch on CUDA
// computes as that product), so the kernel equals it bit for bit.
//
// What bounds it on the H100: bytes, 4 bytes read per output in bf16 and one
// written. One CTA per row reads the row's gate and up halves from memory
// ONCE: 16-byte loads, two chunks of 16 columns a thread in flight before it
// computes, h kept in shared memory (I * 4 bytes: 44 KB at I = 11,008,
// 76 KB at the 7B width of 18,944), the row amax by a block reduction, then
// the quantize from the on-chip h with 16-byte int8 stores. Registers stay
// few (about 60 a thread), so shared memory sets the rows in flight an SM:
// five at the 3B width, two at the 7B width, each with its whole row's loads
// outstanding. Widths that are no multiple of 16 (or rows not 16-byte
// aligned) take scalar loads and stores with the tail masked.
//
// Tensor parallelism splits I over the ranks of a group, and the row's
// scale is the amax over the WHOLE I (the single-device value). The split
// mode runs the same kernel in two passes: pass 1 (MODE 1) writes each
// row's local amax and keeps no h; the group takes the max of the ranks'
// amaxes; pass 2 (MODE 2) recomputes h, quantizes with the group's amax
// and writes q and the scale. The one-pass mode (MODE 0) is the kernel as
// it was.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;         // columns a thread takes at a time: one 16-byte int8 store
constexpr int MAX_THREADS = 256;  // threads a row (a CTA)
constexpr int UNROLL = 2;         // chunks a thread loads before it computes
constexpr int MAX_SMEM = 232448;  // bytes a block may opt in to on sm_90
constexpr float EPS = 1e-8f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = 1.0f / (1.0f + expf(-g));  // torch.sigmoid's arithmetic on the card
  return (g * sig) * u;
}

__device__ __forceinline__ int8_t quantize(float h, float scale) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(h / scale), -127.f), 127.f)));
}

// VEC: every chunk is whole and 16-byte aligned (I % 16 == 0, aligned rows).
// MODE 0: one pass; 1: the row amax into `amax`, nothing else; 2: q and s
// from the row amax read from `amax`.
template <typename T, bool VEC, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
silu_quant_kernel(const T* __restrict__ gu, int8_t* __restrict__ q, float* __restrict__ s, int I,
                  long long stride, float* __restrict__ amax_io) {
  constexpr int PER = 16 / sizeof(T);   // values of a 16-byte load
  constexpr int LOADS = CHUNK / PER;    // 16-byte loads of a chunk, per half
  extern __shared__ float4 h4[];        // h of chunk c, floats 4 j .. 4 j + 3, at h4[j * chunks + c]
  __shared__ float warp_amax[MAX_THREADS / 32];
  const int chunks = (I + CHUNK - 1) / CHUNK;
  const T* g = gu + (size_t)blockIdx.x * stride;
  const T* u = g + I;

  float amax = 0.f;
  for (int c0 = threadIdx.x; c0 < chunks; c0 += UNROLL * blockDim.x) {
    uint4 rg[UNROLL][LOADS], ru[UNROLL][LOADS];
    if (VEC) {
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int c = c0 + k * blockDim.x;
        if (c < chunks) {
#pragma unroll
          for (int j = 0; j < LOADS; ++j) {
            rg[k][j] = __ldg(reinterpret_cast<const uint4*>(g + c * CHUNK + j * PER));
            ru[k][j] = __ldg(reinterpret_cast<const uint4*>(u + c * CHUNK + j * PER));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int c = c0 + k * blockDim.x;
      if (c >= chunks) break;
      float hv[CHUNK];
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) {
        float gf = 0.f, uf = 0.f;  // a column past I: h = 0
        if (VEC) {
          gf = to_f(reinterpret_cast<const T*>(&rg[k][e / PER])[e % PER]);
          uf = to_f(reinterpret_cast<const T*>(&ru[k][e / PER])[e % PER]);
        } else if (c * CHUNK + e < I) {
          gf = to_f(g[c * CHUNK + e]);
          uf = to_f(u[c * CHUNK + e]);
        }
        hv[e] = silu_mul(gf, uf);
        amax = fmaxf(amax, fabsf(hv[e]));
      }
      if (MODE != 1) {
#pragma unroll
        for (int j = 0; j < CHUNK / 4; ++j)
          h4[j * chunks + c] = make_float4(hv[4 * j], hv[4 * j + 1], hv[4 * j + 2], hv[4 * j + 3]);
      }
    }
  }

  // the row amax: warps, then the block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_amax[threadIdx.x >> 5] = amax;
  __syncthreads();  // also: every chunk's h is in shared memory
  float row_amax = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) row_amax = fmaxf(row_amax, warp_amax[w]);
  if (MODE == 1) {
    if (threadIdx.x == 0) amax_io[blockIdx.x] = row_amax;
    return;
  }
  if (MODE == 2) row_amax = amax_io[blockIdx.x];
  const float scale = fmaxf(row_amax, EPS) * (1.0f / 127.0f);
  if (threadIdx.x == 0) s[blockIdx.x] = scale;

  int8_t* qr = q + (size_t)blockIdx.x * I;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    uint32_t w[CHUNK / 4];
#pragma unroll
    for (int j = 0; j < CHUNK / 4; ++j) {
      const float4 f = h4[j * chunks + c];
      w[j] = static_cast<uint32_t>(static_cast<uint8_t>(quantize(f.x, scale))) |
             static_cast<uint32_t>(static_cast<uint8_t>(quantize(f.y, scale))) << 8 |
             static_cast<uint32_t>(static_cast<uint8_t>(quantize(f.z, scale))) << 16 |
             static_cast<uint32_t>(static_cast<uint8_t>(quantize(f.w, scale))) << 24;
    }
    if (VEC) {
      *reinterpret_cast<uint4*>(qr + c * CHUNK) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < CHUNK; ++e)
        if (c * CHUNK + e < I) qr[c * CHUNK + e] = static_cast<int8_t>(w[e / 4] >> (8 * (e % 4)));
    }
  }
}

// Threads of a row's CTA: one chunk each where the row has at most 256, whole warps.
int row_threads(int I) {
  const int chunks = (I + CHUNK - 1) / CHUNK;
  return chunks >= MAX_THREADS ? MAX_THREADS : (chunks + 31) / 32 * 32;
}

int row_smem(int I) { return (I + CHUNK - 1) / CHUNK * CHUNK * 4; }

template <typename T, bool VEC, int MODE>
int launch(const void* gu, void* q, void* s, float* amax, int M, int I, long long stride, cudaStream_t stream) {
  auto kernel = silu_quant_kernel<T, VEC, MODE>;
  int device = 0;
  cudaGetDevice(&device);
  static bool configured[64] = {};  // per device and instance: the opt-in to large dynamic shared memory
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    const int static_bytes = MAX_THREADS / 32 * 4;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM - static_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  kernel<<<M, row_threads(I), MODE == 1 ? 0 : row_smem(I), stream>>>(
      static_cast<const T*>(gu), static_cast<int8_t*>(q), static_cast<float*>(s), I, stride, amax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int launch_dtype(const void* gu, void* q, void* s, float* amax, int M, int I, long long stride,
                 cudaStream_t stream) {
  const bool vec = I % CHUNK == 0 && (stride * (long long)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gu) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  return vec ? launch<T, true, MODE>(gu, q, s, amax, M, I, stride, stream)
             : launch<T, false, MODE>(gu, q, s, amax, M, I, stride, stream);
}

template <int MODE>
int launch_mode(const void* gu, void* q, void* s, float* amax, int M, int I, long long stride, int dtype,
                cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_dtype<__nv_bfloat16, MODE>(gu, q, s, amax, M, I, stride, stream);
    case 1:
      return launch_dtype<__half, MODE>(gu, q, s, amax, M, I, stride, stream);
    default:
      return launch_dtype<float, MODE>(gu, q, s, amax, M, I, stride, stream);
  }
}

bool refused(int M, int I, long long stride, int dtype) {
  return M < 1 || M > 0x7fffffff || I < 1 || stride < 2LL * I || dtype < 0 || dtype > 2 ||
         row_smem(I) > MAX_SMEM - MAX_THREADS / 32 * 4;
}

}  // namespace

// Threads and dynamic shared memory of a row's CTA at width I (the wrapper's
// plan, ops/silu_quant.py `silu_plan`, states the same rule).
extern "C" int st_silu_quant_threads(int I) { return row_threads(I); }
extern "C" int st_silu_quant_smem(int I) { return row_smem(I); }

// gu (M, 2I) with rows `stride` values apart; dtype 0 bf16, 1 fp16, 2 fp32.
// q (M, I) int8 contiguous, s (M) fp32. Refuses (cudaErrorInvalidValue,
// before anything launches) a shape the kernel cannot run. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int st_silu_quant(const void* gu, void* q, void* s, int M, int I, long long stride, int dtype,
                             void* stream) {
  if (refused(M, I, stride, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mode<0>(gu, q, s, nullptr, M, I, stride, dtype, static_cast<cudaStream_t>(stream));
}

// The split mode's two passes, on a rank's I columns: pass 1 writes the row
// amax (M) fp32 into `amax` (q and s untouched); pass 2 reads the group's
// row amax from `amax` and writes q and s as the one-pass mode does.
extern "C" int st_silu_quant_split(const void* gu, void* q, void* s, void* amax, int M, int I,
                                   long long stride, int dtype, int pass, void* stream) {
  if (refused(M, I, stride, dtype) || (pass != 1 && pass != 2) || amax == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(amax);
  return pass == 1 ? launch_mode<1>(gu, q, s, a, M, I, stride, dtype, st)
                   : launch_mode<2>(gu, q, s, a, M, I, stride, dtype, st);
}
