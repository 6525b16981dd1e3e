// Decode attention for Hopper (sm_90a): one new query token per sequence
// against one layer of the stacked bf16 KV cache.
//
// Replaces the Pallas TPU kernel spatialthinker_tpu/ops/decode_attention.py
// `_decode_kernel` (bf16 mode, launched by `_pallas_decode`). Same contract:
//   q (B, Hq, D) bf16; k/v cache (L, B, Hkv, S, D) bf16, head-major;
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

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int st_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                   const void* kv_seg, void* o, int B, int Hq, int Hkv,
                                   int S, int D, int layer, float scale, void* stream) {
  if (Hq % Hkv != 0 || Hq / Hkv > GMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t layer_off = (size_t)layer * B * Hkv * (size_t)S * D;
  const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(k_cache) + layer_off;
  const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(v_cache) + layer_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      launch<128>(q, kc, vc, kv_seg, o, B, Hq, Hkv, S, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
