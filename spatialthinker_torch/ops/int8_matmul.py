"""The fused W8A8 matmul: per-token int8 quantize of x, the int8 x int8 ->
int32 dot against per-output-channel int8 weights, and the scale epilogue —
the CUDA kernel (``csrc/int8_matmul.cu``) and its plain PyTorch version.

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

So the kernel equals the plain version bit for bit on any device.
``w8a8_matmul_prequantized`` runs the same kernel without its quantize
prologue, for rows an earlier kernel already quantized (the silu junction).

The weight is the port's (N, K) row-major int8 matrix (``QuantLinear``,
contraction on axis 1) with one fp32 scale per row. The kernel takes K a
multiple of 32 and N a multiple of 8 and raises on any other shape; every
linear of the 3B and 7B presets qualifies (K in {2048, 3584, 11008, 18944},
N a multiple of 128). Any m >= 1 works without padding.

The wrappers run the plain versions for CPU tensors only; a CUDA tensor
launches the kernel or raises — nothing falls back.
"""

from __future__ import annotations

import torch

from .. import csrc

_EPS = 1e-8
KERNEL_K_MULTIPLE = 32  # whole mma k-steps (m16n8k32)
KERNEL_N_MULTIPLE = 8   # whole mma n-tiles
OUT_DTYPES = (torch.bfloat16, torch.float32)
_INT_MM_MIN_ROWS = 17    # torch._int_mm on CUDA needs more than 16 rows


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
    for name, t, dtype in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(x, xq, xs, w, ws, out, quantize: bool) -> None:
    m, k = xq.shape
    lib = csrc.library()
    with torch.cuda.device(x.device):
        rc = lib.st_int8_matmul(
            x.data_ptr(), int(x.dtype == torch.float32), xq.data_ptr(), xs.data_ptr(), w.data_ptr(),
            ws.data_ptr(), out.data_ptr(), int(out.dtype == torch.float32), m, w.shape[0], k,
            int(quantize), torch.cuda.current_stream().cuda_stream,
        )
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
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, w.shape[0]), dtype=out_dtype, device=x.device)
    _launch(x, xq, xs, w, ws, out, quantize=True)
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
    out = torch.empty((xq.shape[0], w.shape[0]), dtype=out_dtype, device=xq.device)
    _launch(xq, xq, xs, w, ws, out, quantize=False)
    w8a8_matmul_prequantized.launches += 1
    return out


fused_w8a8_matmul.launches = 0
w8a8_matmul_prequantized.launches = 0
