"""The fused W8A8 matmul: per-token int8 quantize of x, the int8 x int8 ->
int32 dot against per-output-channel int8 weights, and the scale epilogue —
the CUDA kernel (``csrc/int8_matmul.cu``), its plan and its plain PyTorch
version.

Counterpart of ``spatialthinker_tpu/ops/int8_matmul.py``: the kernel replaces
the TPU kernels ``_kernel_resident_w`` (#10, the whole weight panel resident,
epilogue ``(acc * xs) * ws``) and ``_kernel`` (#11, streamed weight blocks,
epilogue ``acc * (xs * ws)``), reached there through ``fused_w8a8_matmul``.
Both TPU kernels compute one function; their VMEM budgets
(``_resident_bm``, ``_pick_blocks``) choose blocks, not results, and are
not copied. The port computes exactly ``ops.quant.quantized_dot``:

- per row of x (bf16 or fp32): ``xs = max(amax |x|, 1e-8) / 127`` (a
  division), ``xq = clip(round_half_even(x / xs), +-127)``;
- the int32 dot of xq with the (N, K) int8 weight rows, exact (K * 127^2
  stays under 2^31 for K < 133,000);
- ``(float(acc) * xs) * ws`` in fp32, rounded to nearest at each product
  (the order of the XLA path and of #10), then the output type (bf16 or
  fp32).

So the kernel equals the plain version bit for bit on any device, whatever
its plan: integer addition is associative, so K cut into ranges whose int32
partials are summed in any order gives the same acc. ``w8a8_plan`` is the
one source of truth for how the card cuts the work (``csrc/int8_matmul.cu``
refuses a plan it cannot run); the CPU tests hold it. ``w8a8_matmul_prequantized``
runs the same kernel without its quantize prologue, for rows an earlier
kernel already quantized (the silu junction).

The weight is the port's (N, K) row-major int8 matrix (``QuantLinear``,
contraction on axis 1) with one fp32 scale per row. The kernel takes K a
multiple of 32 and N a multiple of 8 and raises on any other shape; every
linear of the 3B and 7B presets qualifies (K in {2048, 3584, 11008, 18944},
N a multiple of 128). Any m >= 1 works without padding.

The wrappers run the plain versions for CPU tensors only; a CUDA tensor
launches the kernel or raises — nothing falls back.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from .. import csrc

_EPS = 1e-8
KERNEL_K_MULTIPLE = 32  # whole wgmma k-steps (k32)
KERNEL_N_MULTIPLE = 8   # whole wgmma n8 column groups
OUT_DTYPES = (torch.bfloat16, torch.float32)
_INT_MM_MIN_ROWS = 17    # torch._int_mm on CUDA needs more than 16 rows

# ---- the plan: how the kernel cuts one call over the card's CTAs ----
K_STEP = 128           # bytes of K per ring stage: one TMA box row, the 128-byte swizzle span
DECODE_MAX_M = 256     # up to here one CTA row tile holds all m rows (the decode regime)
MAX_SPLITS = 8         # one split of K per CTA of a portable thread-block cluster (the kernel's limit)
PLAN_MAX_SPLITS = 4    # the plan's: clusters of 8 at one CTA an SM do not all fit the GPCs at once
MAX_STAGES = 8
NUM_SMS = 132          # the H100 SXM's streaming multiprocessors
MIN_SPLIT_STEPS = 10   # a split of K keeps at least this many k-steps (its combine costs ~1 µs)
WIDE_N, LONG_K = 4096, 8192  # decode: 128 columns a CTA from here (fewer re-reads of xq), else 64
PART_PAD = 4           # int32 words of padding per row of a split's partial tile
SMEM_LIMIT = 232_448   # bytes of shared memory a block may use
SMEM_BUDGET_TWO = 110_000  # a ring that leaves room for two CTAs an SM
SMEM_BUDGET_ONE = 200_000  # a ring for one CTA an SM
# (m64 blocks of rows per CTA, columns per CTA) built in csrc/int8_matmul.cu (W8A8_TILES)
TILES = frozenset({(1, 64), (1, 128), (1, 256), (2, 64), (2, 128), (2, 256), (3, 64), (3, 128),
                   (4, 64), (4, 128)})


class W8A8Plan(NamedTuple):
    """How one call runs: CTA (split s, row tile r, column tile c) for
    blockIdx (s + splits * r, c) multiplies rows [r * bm, (r + 1) * bm),
    columns [c * bn, (c + 1) * bn) over bytes ``k_ranges[s]`` of K; the
    ``splits`` CTAs of a tile form one cluster and sum their int32 partials."""
    regime: str            # "decode" (all m rows in one row tile, K split) | "prefill"
    mb: int                # m64 blocks of rows per CTA (one consumer warpgroup each)
    bn: int                # columns per CTA
    splits: int            # CTAs that share a tile's K
    stages: int            # depth of the TMA ring
    row_tiles: int
    col_tiles: int
    k_ranges: Tuple[Tuple[int, int], ...]  # (k0, k1) bytes of K of each split
    a_rows: int            # rows of xq a ring slot holds (``xq_box_rows``)

    @property
    def bm(self) -> int:
        return 64 * self.mb

    @property
    def ctas(self) -> int:
        return self.splits * self.row_tiles * self.col_tiles

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.mb, self.bn, self.stages, self.splits, self.a_rows)

    def describe(self) -> dict:
        return {"regime": self.regime, "tile": [self.bm, self.bn], "splits": self.splits,
                "stages": self.stages, "ctas": self.ctas, "smem_bytes": self.smem_bytes}


def xq_box_rows(m: int, mb: int, bn: int) -> int:
    """Rows of xq's TMA box and ring slot, as ``st_int8_matmul`` computes
    them: with one row tile the live rows rounded up to 8 (but at least
    64 mb - bn, so every warpgroup's rows lie inside its slot), else the
    whole tile of 64 mb rows."""
    return max(-(-m // 8) * 8, 64 * mb - bn) if m <= 64 * mb else 64 * mb


def smem_bytes(mb: int, bn: int, stages: int, splits: int, a_rows: int) -> int:
    """Dynamic shared memory of a CTA, as ``Tile::smem_bytes`` computes it:
    1 KB to align the ring, the ring of (xq box + w box) slots (or a split's
    padded int32 partial tile where that is larger: it reuses the ring), two
    barriers per stage."""
    ring = stages * (a_rows + bn) * K_STEP
    part = 64 * mb * (bn + PART_PAD) * 4
    return 1024 + (part if splits > 1 and part > ring else ring) + 16 * stages


def split_k_ranges(k: int, splits: int) -> Tuple[Tuple[int, int], ...]:
    """K cut into ``splits`` ranges of whole K_STEP steps, the first
    ``steps % splits`` one step longer (the kernel's rule); the last range
    ends at K (TMA reads the tail past K as zeros)."""
    steps = -(-k // K_STEP)
    per, extra = divmod(steps, splits)
    ranges, step = [], 0
    for s in range(splits):
        n = per + (s < extra)
        ranges.append((step * K_STEP, min((step + n) * K_STEP, k)))
        step += n
    return tuple(ranges)


@functools.lru_cache(maxsize=4096)
def w8a8_plan(m: int, n: int, k: int, bn: int = None, splits: int = None, stages: int = None,
              regime: str = None) -> W8A8Plan:
    """The plan the card runs for x (m, k) against w (n, k). ``bn``,
    ``splits``, ``stages`` and ``regime`` override the choice (for
    measurements). The rule is the measured one (``time_w8a8.py --sweep``,
    PERF.md §6): at most about one CTA per SM, each with a deep ring,
    beats more CTAs with shallow rings.

    Decode (m <= DECODE_MAX_M): one row tile of ceil(m / 64) m64 blocks, so
    each weight byte is read by one CTA; 128 columns a CTA for wide N or
    long K (fewer re-reads of xq), else 64. Prefill: 128 x 256 tiles, 128 x
    128 where 256 would leave SMs idle. Both: K split over up to
    PLAN_MAX_SPLITS CTAs of a cluster while the call stays within NUM_SMS CTAs
    and each split keeps MIN_SPLIT_STEPS k-steps. The ring holds as many stages as
    SMEM_BUDGET_ONE allows where the call has no more CTAs than SMs, else as
    SMEM_BUDGET_TWO allows (two CTAs an SM, tiles up to 128 x 128); at most
    MAX_STAGES, no more than a split's steps, two at least (one would stop the
    weight stream while the products run)."""
    steps = -(-k // K_STEP)
    regime = regime or ("decode" if m <= DECODE_MAX_M else "prefill")
    if regime == "decode":
        mb = -(-m // 64)
        if bn is None:
            bn = 128 if n >= WIDE_N or k >= LONG_K else 64
    else:
        mb = 2
        if bn is None:
            bn = 256 if -(-m // 128) * -(-n // 256) >= NUM_SMS else 128
    row_tiles, col_tiles = -(-m // (64 * mb)), -(-n // bn)
    a_rows = xq_box_rows(m, mb, bn)
    if splits is None:
        splits = max(1, min(PLAN_MAX_SPLITS, NUM_SMS // (row_tiles * col_tiles), steps // MIN_SPLIT_STEPS))
    if (mb, bn) not in TILES:
        raise ValueError(f"no W8A8 tile of {64 * mb} x {bn} is built")
    if not 1 <= splits <= min(MAX_SPLITS, steps):
        raise ValueError(f"{splits} splits of {steps} k-steps: 1 to {min(MAX_SPLITS, steps)} run")
    if stages is None:
        two = mb <= 2 and bn <= 128 and splits * row_tiles * col_tiles > NUM_SMS
        budget = SMEM_BUDGET_TWO if two else SMEM_BUDGET_ONE
        stages = max(2, min(MAX_STAGES, budget // ((a_rows + bn) * K_STEP), -(-steps // splits)))
    if not 2 <= stages <= MAX_STAGES or smem_bytes(mb, bn, stages, splits, a_rows) > SMEM_LIMIT:
        raise ValueError(f"a ring of {stages} stages does not fit a {64 * mb} x {bn} tile")
    return W8A8Plan(regime, mb, bn, splits, stages, row_tiles, col_tiles, split_k_ranges(k, splits), a_rows)


def quantize_rows(x: torch.Tensor):
    """(..., K) -> (xq int8 (..., K), xs fp32 (..., 1)): per-row symmetric
    int8. The scale is a true division on every device: CUDA divides a tensor
    by a Python scalar as a multiplication by its reciprocal (one ulp off in
    some rows), so the divisor is a tensor."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=_EPS)
    xs = amax / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def w8a8_epilogue(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor, out_dtype) -> torch.Tensor:
    """(m, N) int32 -> ``(float(acc) * xs) * ws`` in ``out_dtype``."""
    return (acc.float() * xs.reshape(-1, 1) * ws.reshape(1, -1)).to(out_dtype)


def int8_matmul(xq: torch.Tensor, w_kn: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, through the library's
    ``torch._int_mm``: the plain version's dot. On CUDA ``_int_mm`` refuses
    fewer than 17 rows and unaligned k/n: the rows are zero-padded here,
    unaligned k or n raises."""
    m, k = xq.shape
    if not xq.is_cuda:
        return torch._int_mm(xq, w_kn)
    n = w_kn.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"int8 matmul on CUDA needs k and n in multiples of 8, got k={k} n={n}")
    if m >= _INT_MM_MIN_ROWS:
        return torch._int_mm(xq.contiguous(), w_kn)
    padded = xq.new_zeros((32, k))
    padded[:m] = xq
    return torch._int_mm(padded, w_kn)[:m]


def w8a8_matmul_prequantized_plain(xq: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
                                   ws: torch.Tensor, out_dtype) -> torch.Tensor:
    """xq (m, K) int8, xs (m,) or (m, 1) fp32, w (N, K) int8, ws (N,) fp32."""
    return w8a8_epilogue(int8_matmul(xq, w.t()), xs, ws, out_dtype)


def fused_w8a8_matmul_plain(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                            out_dtype=None) -> torch.Tensor:
    """x (m, K) bf16 | fp32 against w (N, K) int8 with per-row scales ws (N,)
    -> (m, N) in ``out_dtype`` (default x's dtype)."""
    xq, xs = quantize_rows(x)
    return w8a8_matmul_prequantized_plain(xq, xs, w, ws, out_dtype or x.dtype)


def _check_cuda_inputs(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor, out_dtype,
                       x_dtypes, xs: torch.Tensor = None) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] or x.shape[0] < 1:
        raise ValueError(f"x {tuple(x.shape)} does not fit the (N, K) weight {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[0]
    if k % KERNEL_K_MULTIPLE or n % KERNEL_N_MULTIPLE:
        raise ValueError(
            f"the W8A8 kernel takes K a multiple of {KERNEL_K_MULTIPLE} and N a multiple of "
            f"{KERNEL_N_MULTIPLE}, got K={k} N={n}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"the W8A8 kernel writes bf16 or fp32, not {out_dtype}")
    if x.dtype not in x_dtypes:
        raise ValueError(f"the W8A8 kernel takes x in {x_dtypes}, got {x.dtype}")
    if tuple(ws.shape) != (n,):
        raise ValueError(f"weight scales must be ({n},), got {tuple(ws.shape)}")
    tensors = [("x", x, x.dtype), ("w", w, torch.int8), ("ws", ws, torch.float32)]
    if xs is not None:
        if xs.numel() != m:
            raise ValueError(f"row scales must hold {m} values, got {tuple(xs.shape)}")
        tensors.append(("xs", xs, torch.float32))
    device = x.device
    for name, t, dtype in tensors:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _launch(x_ptr: int, x_f32: bool, xq_ptr: int, xs_ptr: int, w, ws, out, m: int, k: int,
            quantize: bool) -> None:
    n = w.shape[0]
    plan = w8a8_plan(m, n, k)
    device = out.device
    lib = csrc.library()
    args = (x_ptr, int(x_f32), xq_ptr, xs_ptr, w.data_ptr(), ws.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.float32), m, n, k, int(quantize), plan.mb, plan.bn, plan.splits,
            plan.stages)
    if device.index == torch.cuda.current_device():
        rc = lib.st_int8_matmul(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            rc = lib.st_int8_matmul(*args, _stream(device))
    csrc.check_launch(rc, "W8A8 matmul")


def fused_w8a8_matmul(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (m, K) bf16 | fp32 against w (N, K) int8 with per-row scales ws (N,)
    -> (m, N) in ``out_dtype`` (default x's dtype): the kernel (quantize
    prologue + int8 GEMM with the scale epilogue, counted as one launch) for
    a CUDA tensor, the plain version for a CPU tensor."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return fused_w8a8_matmul_plain(x, w, ws, out_dtype)
    _check_cuda_inputs(x, w, ws, out_dtype, (torch.bfloat16, torch.float32))
    m, k = x.shape
    # one scratch allocation: xq (m, K) int8, then xs (m,) fp32 at a 16-byte boundary
    xs_at = -(-m * k // 16) * 16
    scratch = torch.empty((xs_at + 4 * m,), dtype=torch.uint8, device=x.device)
    out = torch.empty((m, w.shape[0]), dtype=out_dtype, device=x.device)
    xq_ptr = scratch.data_ptr()
    _launch(x.data_ptr(), x.dtype == torch.float32, xq_ptr, xq_ptr + xs_at, w, ws, out, m, k, quantize=True)
    fused_w8a8_matmul.launches += 1
    return out


def w8a8_matmul_prequantized(xq: torch.Tensor, xs: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                             out_dtype) -> torch.Tensor:
    """Already quantized rows xq (m, K) int8 with scales xs (m,) | (m, 1)
    fp32 against w (N, K) -> (m, N): the same kernel without its prologue
    for a CUDA tensor, the plain version for a CPU tensor."""
    if not xq.is_cuda:
        return w8a8_matmul_prequantized_plain(xq, xs, w, ws, out_dtype)
    _check_cuda_inputs(xq, w, ws, out_dtype, (torch.int8,), xs=xs)
    m, k = xq.shape
    out = torch.empty((m, w.shape[0]), dtype=out_dtype, device=xq.device)
    _launch(xq.data_ptr(), False, xq.data_ptr(), xs.data_ptr(), w, ws, out, m, k, quantize=False)
    w8a8_matmul_prequantized.launches += 1
    return out


fused_w8a8_matmul.launches = 0
w8a8_matmul_prequantized.launches = 0
