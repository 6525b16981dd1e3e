"""SwiGLU junction: silu(gate) * up fused with the per-row int8 quantize that
feeds the down projection — the Triton kernel and its plain PyTorch version.

Counterpart of ``spatialthinker_tpu/ops/int8_matmul.py`` ``_silu_quant_kernel``
(launched by ``fused_silu_quantize``). Contract: ``gu`` (M, 2I), gate columns
first; returns ``q`` (M, I) int8 and ``scale`` (M, 1) fp32 with
``h = g * sigmoid(g) * u`` in fp32, ``scale = max(amax_row(|h|), 1e-8) / 127``
and ``q = clip(round_half_even(h / scale), +-127)``.

What bounds it on the H100: bytes. The unfused pipeline writes the (M, I)
product, reads it for the row amax and reads it again to scale and cast;
fused, the junction is the gate/up read (4 bytes per output element in
bf16) and the int8 write. One program per row walks the row twice in
column blocks (I = 11008 and 18944 are no powers of two, so the tail block
is masked): pass one reduces the row amax, pass two recomputes ``h`` from
the same gate/up values and writes the int8 row. The second read of the
row's 4 * I bytes comes out of L2.

The kernel is Triton: ``triton`` is imported where the kernel is first
launched, never at module import, so the package imports on a CPU-only
PyTorch. The wrapper runs the plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8
BLOCK = 2048
NUM_WARPS = 8

_kernel = None


def fused_silu_quantize_plain(gu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference: the same arithmetic in fp32 tensor ops."""
    i = gu.shape[-1] // 2
    g = gu[:, :i].float()
    u = gu[:, i:].float()
    h = (g * torch.sigmoid(g)) * u
    amax = h.abs().amax(dim=1, keepdim=True)
    s = torch.clamp(amax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
    return q, s


def _build_kernel():
    """Define the Triton kernel (first launch only)."""
    global _kernel, triton, tl
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def silu_quant_kernel(gu_ptr, q_ptr, s_ptr, n_inter, stride_gu, stride_q,
                          EPS: tl.constexpr, BLOCK_N: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        gate = gu_ptr + row * stride_gu
        up = gate + n_inter
        amax = tl.zeros([BLOCK_N], dtype=tl.float32)
        for start in range(0, n_inter, BLOCK_N):
            cols = start + tl.arange(0, BLOCK_N)
            mask = cols < n_inter
            g = tl.load(gate + cols, mask=mask, other=0.0).to(tl.float32)
            u = tl.load(up + cols, mask=mask, other=0.0).to(tl.float32)
            h = (g * tl.sigmoid(g)) * u
            amax = tl.maximum(amax, tl.abs(h))
        s = tl.maximum(tl.max(amax, axis=0), EPS) / 127.0
        tl.store(s_ptr + row, s)
        out = q_ptr + row * stride_q
        for start in range(0, n_inter, BLOCK_N):
            cols = start + tl.arange(0, BLOCK_N)
            mask = cols < n_inter
            g = tl.load(gate + cols, mask=mask, other=0.0).to(tl.float32)
            u = tl.load(up + cols, mask=mask, other=0.0).to(tl.float32)
            h = (g * tl.sigmoid(g)) * u
            # round half to even, as the reference's round does
            r = tl.inline_asm_elementwise(
                "cvt.rni.f32.f32 $0, $1;", "=f,f", [h / s], dtype=tl.float32,
                is_pure=True, pack=1,
            )
            r = tl.minimum(tl.maximum(r, -127.0), 127.0)
            tl.store(out + cols, r.to(tl.int8), mask=mask)

    _kernel = silu_quant_kernel
    return _kernel


def _check_cuda_input(gu: torch.Tensor) -> None:
    if gu.dim() != 2 or gu.shape[1] % 2 or gu.shape[0] < 1 or gu.shape[1] < 2:
        raise ValueError(f"gu must be a non-empty (M, 2I), got {tuple(gu.shape)}")
    if gu.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"gu must be a floating tensor, got {gu.dtype}")
    if gu.stride(1) != 1:
        raise ValueError("gu rows must be contiguous")


def fused_silu_quantize(gu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q (M, I) int8, scale (M, 1) fp32) through the Triton kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if not gu.is_cuda:
        return fused_silu_quantize_plain(gu)
    _check_cuda_input(gu)
    m, two_i = gu.shape
    i = two_i // 2
    q = torch.empty((m, i), dtype=torch.int8, device=gu.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=gu.device)
    kernel = _build_kernel()
    with torch.cuda.device(gu.device):
        kernel[(m,)](gu, q, s, i, gu.stride(0), q.stride(0),
                     EPS=_EPS, BLOCK_N=BLOCK, num_warps=NUM_WARPS)
    fused_silu_quantize.launches += 1
    return q, s


fused_silu_quantize.launches = 0
