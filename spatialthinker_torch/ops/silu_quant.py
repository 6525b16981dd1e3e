"""SwiGLU junction: silu(gate) * up fused with the per-row int8 quantize that
feeds the down projection -- the CUDA kernel (``csrc/silu_quant.cu``) and its
plain PyTorch version.

Counterpart of ``spatialthinker_tpu/ops/int8_matmul.py`` ``_silu_quant_kernel``
(launched by ``fused_silu_quantize``). Contract: ``gu`` (M, 2I) bf16, fp16 or
fp32, gate columns first; returns ``q`` (M, I) int8 and ``scale`` (M, 1) fp32
with ``h = g * sigmoid(g) * u`` in fp32, ``scale = max(amax_row(|h|), 1e-8) /
127`` and ``q = clip(round_half_even(h / scale), +-127)``.

What bounds it on the H100: bytes. The unfused pipeline writes the (M, I)
product, reads it for the row amax and reads it again to scale and cast;
fused, the junction is the gate/up read (4 bytes per output element in
bf16) and the int8 write. One CTA per row reads the row once with 16-byte
loads, keeps h in shared memory, reduces the row amax over the block and
quantizes from the on-chip copy (``silu_plan`` states the launch). It is
built with the other kernels of ``csrc/`` and launched by one C call; no
Triton is imported on any path of the port.

The wrapper runs the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .. import csrc
from .int8_matmul import _stream

_EPS = 1e-8
CHUNK = 16                # columns a thread takes at a time (one 16-byte int8 store)
MAX_THREADS = 256         # threads of a row's CTA
KERNEL_MAX_SMEM = 232448 - MAX_THREADS // 32 * 4  # dynamic shared memory beside the warps' amax
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


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


@dataclass(frozen=True)
class SiluPlan:
    """A row's CTA at width I: ``threads`` threads (whole warps, at most 256)
    walk the row's ``chunks`` chunks of 16 columns, thread t taking chunks
    t, t + threads, ...; h takes ``smem`` bytes of shared memory."""

    threads: int
    chunks: int
    smem: int


def silu_plan(i: int) -> SiluPlan:
    """The launch at width ``i`` (``row_threads`` / ``row_smem`` in the
    ``.cu`` file). Raises ValueError for a width whose h outgrows a block's
    shared memory (I > 58,096)."""
    if i < 1:
        raise ValueError(f"no silu plan for width {i}")
    chunks = -(-i // CHUNK)
    threads = MAX_THREADS if chunks >= MAX_THREADS else -(-chunks // 32) * 32
    smem = chunks * CHUNK * 4
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(f"width {i} keeps {smem} bytes of h in shared memory; a block holds {KERNEL_MAX_SMEM}")
    return SiluPlan(threads, chunks, smem)


def _check_cuda_input(gu: torch.Tensor) -> None:
    if gu.dim() != 2 or gu.shape[1] % 2 or gu.shape[0] < 1 or gu.shape[1] < 2:
        raise ValueError(f"gu must be a non-empty (M, 2I), got {tuple(gu.shape)}")
    if gu.dtype not in _DTYPES:
        raise ValueError(f"gu must be bf16, fp16 or fp32, got {gu.dtype}")
    if gu.stride(1) != 1 or gu.stride(0) < gu.shape[1]:
        raise ValueError("gu rows must be contiguous and must not overlap")
    silu_plan(gu.shape[1] // 2)


def fused_silu_quantize(gu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q (M, I) int8, scale (M, 1) fp32) through the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if not gu.is_cuda:
        return fused_silu_quantize_plain(gu)
    _check_cuda_input(gu)
    m, two_i = gu.shape
    i = two_i // 2
    q = torch.empty((m, i), dtype=torch.int8, device=gu.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=gu.device)
    args = (gu.data_ptr(), q.data_ptr(), s.data_ptr(), m, i, gu.stride(0), _DTYPES[gu.dtype])
    lib = csrc.library()
    if gu.device.index == torch.cuda.current_device():
        rc = lib.st_silu_quant(*args, _stream(gu.device))
    else:
        with torch.cuda.device(gu.device):
            rc = lib.st_silu_quant(*args, _stream(gu.device))
    csrc.check_launch(rc, "silu quantize")
    fused_silu_quantize.launches += 1
    return q, s


fused_silu_quantize.launches = 0
