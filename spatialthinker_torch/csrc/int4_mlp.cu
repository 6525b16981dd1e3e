// W4A8 decode MLP for Hopper (sm_90a): int4 group-quantized weights times
// int8 per-row activations, with the silu junction fused into gate_up.
//
// Replaces the Pallas TPU kernels of spatialthinker_tpu/ops/int4_mlp.py:
//   `_gateup_kernel`  x (m, E) -> h = silu(gate) * up (m, I) bf16   (gateup = 1)
//   `_matmul_kernel`  x (m, K) -> out (m, N) bf16 | fp32           (gateup = 0)
// Contract (the plain versions in ops/int4_mlp.py state the same function):
//   x bf16 (m, K); q4 uint8 (C, K/2): one byte row per output column, byte r
//   holding row r in its LOW nibble and row r + K/2 in its HIGH nibble, both
//   stored +8 biased (C = 2I for gate_up, gate columns first; C = N for down);
//   gscale fp32 (K/group, C). Per row: xs = max(amax |x|, 1e-8) / 127,
//   xq = clip(round_half_even(x / xs), +-127). Per group g: the exact int32
//   dot of xq with the unsigned nibbles u, minus 8 * sum(xq over the group),
//   times gscale[g] in fp32; the groups summed in fp32, times xs. gate_up:
//   h = silu(g) * u in fp32, rounded to bf16.
//
// What bounds it on the H100: bytes. At decode m is the number of lanes (136
// for 128 slots in the continuous engine) and every weight byte is read once
// per step: gate_up reads 22.5 MB of nibbles and 1.4 MB of scales at the 3B
// widths, down 11.3 MB and 0.7 MB, against 12.3 G and 6.1 G int8 operations —
// under the card's operations-per-byte balance at any m the rule admits.
//
// Design:
// - The per-row quantize of the input is a prologue kernel in this file
//   (`quantize_rows_kernel`, one CTA per row), not per-block work: the TPU
//   kernels quantize once at grid step 0 into VMEM scratch that later grid
//   steps reuse, but Hopper's blocks share no scratch, and an m x K int8 copy
//   (278 KB at K = 2048, 1.5 MB at K = 11008 for m = 136) exceeds a block's
//   227 KB of shared memory. The prologue writes xq (m x K bytes), xs and the
//   per-group row sums once; they stay in the 50 MB L2 for the main kernel.
//   It writes xq in the order the mma fragments are read (`frag_offset`),
//   zero-padded to whole 16-row m-tiles, so each warp's A fragment is one
//   coalesced 512-byte load instead of sixteen rows' scattered 8-byte pieces.
//   Its cost is one extra launch and ~3 bytes per input element (read bf16,
//   write int8), against the alternative of every block recomputing the row
//   amax over the whole row — 344 blocks x K reads at K = 11008.
// - The dot runs on the tensor cores: `mma.sync.m16n8k32` with s8 (xq) times
//   u8 (the unsigned nibbles) into s32, exact. One k-step of 32 must lie inside
//   one group, so the kernel takes group sizes of 32, 64 and 128 (the 3B and
//   7B presets use 128). Each thread reads eight consecutive packed
//   rows of one column in one 8-byte load, which serves a k-step of the low
//   half (mask 0x0F0F0F0F) and one of the high half (shift 4, mask): the
//   permutation of k inside a k-step is the same for A and B, so the sum is
//   unchanged.
// - A CTA of 8 warps owns BN output columns and up to BM = 144 rows (the 136
//   lanes of 128 slots in one pass), so each weight byte is read from HBM
//   once. Warp (matrix, n-tile, k-split) streams the packed rows of its
//   8 columns group by group and prefetches the next group's bytes into
//   registers while it multiplies the current ones against every m-tile of
//   the rows; the per-group fp32 sums accumulate in shared memory, one buffer
//   per k-split, each element owned by one thread. gate_up gives one warp to
//   the gate and one to the up n-tile of the same columns j and I + j, and
//   the epilogue forms silu(g) * u from the two sums: the (m, 2I)
//   intermediate never exists, as on the TPU. The A fragments (xq) come
//   through L1 / L2, read once by every warp.
// What it does not do yet: cp.async / TMA staging of the weight panels, a
// shared-memory copy of the A tiles, `wgmma`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIAS = 8;
constexpr float EPS = 1e-8f;
constexpr int QTHREADS = 256;
constexpr int BM = 144;        // rows per CTA: 9 m-tiles, the 136 decode lanes of 128 slots in one pass
constexpr int KMAX_STEPS = 4;  // mma k-steps per group: group <= 128

// Byte offset of xq[r][c] in the fragment order the main kernel reads: for
// each 16-row m-tile and each 32-wide k-step, lane (gid, tig) of a warp finds
// its whole A fragment — rows gid and gid + 8, k = tig * 8 .. + 7 — in 16
// contiguous bytes, so a warp's fragment load is one coalesced 512-byte read.
__device__ __forceinline__ size_t frag_offset(int r, int c, int k) {
  const int rr = r & 15, cc = c & 31;
  const int lane = (rr & 7) * 4 + (cc >> 3);
  return (((size_t)(r >> 4) * (k >> 5) + (c >> 5)) * 32 + lane) * 16 + (rr >> 3) * 8 + (cc & 7);
}

// One CTA per row (rows up to m rounded to 16; the pad rows write zeros):
// xs = max(amax, eps) / 127, xq = clip(rint(x / xs)) in fragment order, and
// the sum of xq over each group (the -8 debias of the nibble dots).
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int* __restrict__ xsum, int m, int k, int group) {
  const int row = blockIdx.x;
  if (row >= m) {  // an m-tile's pad row: zero A rows, never scaled or written out
    for (int c = threadIdx.x; c < k; c += QTHREADS) xq[frag_offset(row, c, k)] = 0;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const __nv_bfloat16* xr = x + (size_t)row * k;
  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += QTHREADS) amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
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
  const int n_groups = k / group;
  for (int g = warp; g < n_groups; g += QTHREADS / 32) {
    int sum = 0;
    for (int i = lane; i < group; i += 32) {
      const int c = g * group + i;
      const float q = fminf(fmaxf(rintf(__bfloat162float(xr[c]) / s), -127.f), 127.f);
      const int qi = static_cast<int>(q);
      xq[frag_offset(row, c, k)] = static_cast<int8_t>(qi);
      sum += qi;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) xsum[(size_t)row * n_groups + g] = sum;
  }
}

// D = A (16x32 s8, row) * B (32x8 u8, col) + D, s32.
__device__ __forceinline__ void mma_s8u8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One CTA owns BN output columns (of each of NMAT matrices) and up to BM rows.
// Warp (mat, nt, ks) streams the packed rows of one matrix's 8-column n-tile
// over every KSPLIT-th packed-row group, prefetching the next group's bytes
// into registers while it multiplies the current ones against every m-tile of
// the CTA's rows, so each weight byte is read once per CTA. The per-group
// fp32 sums accumulate in shared memory (one buffer per k-split, each element
// owned by one thread: no atomics, a fixed summation order). NMAT = 2:
// gate_up (matrices at columns j and n_out + j, silu epilogue, bf16 out);
// NMAT = 1: one matrix, out = acc * xs in OutT.
template <int NMAT, int NT, int KSPLIT, typename OutT>
__global__ void __launch_bounds__(32 * NMAT * NT * KSPLIT)
int4_mlp_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const int* __restrict__ xsum, const uint8_t* __restrict__ q4,
                const float* __restrict__ gscale, OutT* __restrict__ out, int m, int k, int n_out,
                int group) {
  constexpr int BN = NT * 8;
  constexpr int LDA = NMAT * BN + (NMAT * BN >= 64 ? 8 : 4);  // padded accumulator row
  __shared__ float acc[KSPLIT * BM * LDA];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mat = warp % NMAT, nt = (warp / NMAT) % NT, ks = warp / (NMAT * NT);
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, m - row0);
  const int n_mt = (rows + 15) / 16;
  const int col0 = blockIdx.y * BN + nt * 8;  // first output column of this warp's n-tile
  const int half = k / 2;
  const int n_groups = k / group, hg = n_groups / 2, ksteps = group / 32;
  const int ld = NMAT * n_out;  // columns of q4 / gscale
  const uint4* afrag = reinterpret_cast<const uint4*>(xq) + lane;  // fragment order, see frag_offset

  for (int i = threadIdx.x; i < KSPLIT * BM * LDA; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const uint8_t* wcol = q4 + (size_t)(col0 + gid + mat * n_out) * half + tig * 8;
  const float* gcol = gscale + col0 + mat * n_out + tig * 2;
  float* acc_t = acc + (size_t)ks * BM * LDA + gid * LDA + mat * BN + nt * 8 + tig * 2;

  uint2 w[KMAX_STEPS], nxt[KMAX_STEPS];
#pragma unroll
  for (int kk = 0; kk < KMAX_STEPS; ++kk)
    w[kk] = kk < ksteps && ks < hg ? *reinterpret_cast<const uint2*>(wcol + ks * group + kk * 32)
                                   : make_uint2(0u, 0u);
  // packed-row group gi holds group gi (low nibbles) and gi + hg (high)
  for (int gi = ks; gi < hg; gi += KSPLIT) {
    const int gn = gi + KSPLIT;
#pragma unroll
    for (int kk = 0; kk < KMAX_STEPS; ++kk)  // the next group's bytes, in flight meanwhile
      nxt[kk] = kk < ksteps && gn < hg ? *reinterpret_cast<const uint2*>(wcol + gn * group + kk * 32)
                                       : make_uint2(0u, 0u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = gi + h * hg;
      const float2 gs = *reinterpret_cast<const float2*>(gcol + (size_t)g * ld);
      for (int mt = 0; mt < n_mt; ++mt) {
        const int r0 = row0 + mt * 16 + gid;
        const bool live0 = r0 < m, live1 = r0 + 8 < m;
        // this m-tile's fragments at the group's first k-step (pad rows are zeros)
        const uint4* a = afrag + ((size_t)(blockIdx.x * (BM / 16) + mt) * (k / 32)
                                  + (h * half + gi * group) / 32) * 32;
        int part[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < KMAX_STEPS; ++kk) {
          if (kk >= ksteps) break;
          const uint4 f = a[kk * 32];  // .x/.y row gid, .z/.w row gid + 8
          const uint32_t b0 = (h ? (w[kk].x >> 4) : w[kk].x) & 0x0F0F0F0Fu;
          const uint32_t b1 = (h ? (w[kk].y >> 4) : w[kk].y) & 0x0F0F0F0Fu;
          mma_s8u8(part, f.x, f.z, f.y, f.w, b0, b1);
        }
        // group epilogue: debias, scale, accumulate in fp32
        const int bias0 = live0 ? BIAS * xsum[(size_t)r0 * n_groups + g] : 0;
        const int bias1 = live1 ? BIAS * xsum[(size_t)(r0 + 8) * n_groups + g] : 0;
        float* dst = acc_t + mt * 16 * LDA;
        dst[0] += static_cast<float>(part[0] - bias0) * gs.x;
        dst[1] += static_cast<float>(part[1] - bias0) * gs.y;
        dst[8 * LDA] += static_cast<float>(part[2] - bias1) * gs.x;
        dst[8 * LDA + 1] += static_cast<float>(part[3] - bias1) * gs.y;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KMAX_STEPS; ++kk) w[kk] = nxt[kk];
  }
  __syncthreads();

  // the k-split sums in a fixed order, times xs, (silu(gate) * up), out
  for (int idx = threadIdx.x; idx < rows * BN; idx += blockDim.x) {
    const int r = idx / BN, c = idx % BN;
    float v = 0.f, u = 0.f;
#pragma unroll
    for (int j = 0; j < KSPLIT; ++j) {
      v += acc[(j * BM + r) * LDA + c];
      if (NMAT == 2) u += acc[(j * BM + r) * LDA + BN + c];
    }
    const float s = xs[row0 + r];
    v *= s;
    if (NMAT == 2) {
      u *= s;
      v = (v * (1.f / (1.f + expf(-v)))) * u;
    }
    OutT* dst = out + (size_t)(row0 + r) * n_out + blockIdx.y * BN + c;
    if constexpr (sizeof(OutT) == 4) {
      *dst = v;
    } else {
      *dst = __float2bfloat16_rn(v);
    }
  }
}

template <int NMAT, int NT, int KSPLIT, typename OutT>
int launch_main(const void* xq, const void* xs, const void* xsum, const void* q4, const void* gscale,
                void* out, int m, int k, int n_out, int group, cudaStream_t s) {
  if (n_out % (NT * 8) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + BM - 1) / BM, n_out / (NT * 8));
  int4_mlp_kernel<NMAT, NT, KSPLIT, OutT><<<grid, 32 * NMAT * NT * KSPLIT, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs), static_cast<const int*>(xsum),
      static_cast<const uint8_t*>(q4), static_cast<const float*>(gscale), static_cast<OutT*>(out), m,
      k, n_out, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 (m, k); scratch xq int8 (m rounded up to 16, k), xs fp32 (m,), xsum
// int32 (m, k/group) allocated by the caller; q4 (n_cols, k/2) uint8; gscale (k/group, n_cols)
// fp32; out (m, n_cols/2) bf16 for gate_up, (m, n_cols) bf16 | fp32 for down.
// Launches the prologue and the main kernel on `stream`; returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int st_int4_mlp(const void* x, void* xq, void* xs, void* xsum, const void* q4,
                           const void* gscale, void* out, int m, int k, int n_cols, int group,
                           int gateup, int out_f32, void* stream) {
  if (m < 1 || m > 65535 * BM || group < 32 || group > 32 * KMAX_STEPS || group % 32 != 0 ||
      k % (2 * group) != 0 ||
      (gateup && (n_cols % 2 != 0 || out_f32)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<<<(m + 15) / 16 * 16, QTHREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs),
      static_cast<int*>(xsum), m, k, group);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gateup)  // 32 columns of gate and of up per CTA: one warp per (matrix, n-tile)
    return launch_main<2, 4, 1, __nv_bfloat16>(xq, xs, xsum, q4, gscale, out, m, k, n_cols / 2,
                                               group, s);
  if (out_f32)  // 16 columns per CTA, four warps per n-tile split the (many) groups of K = I
    return launch_main<1, 2, 4, float>(xq, xs, xsum, q4, gscale, out, m, k, n_cols, group, s);
  return launch_main<1, 2, 4, __nv_bfloat16>(xq, xs, xsum, q4, gscale, out, m, k, n_cols, group, s);
}
