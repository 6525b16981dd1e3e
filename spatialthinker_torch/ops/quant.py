"""W8A8 int8 quantization for the rollout path (counterpart of
``spatialthinker_tpu/ops/quant.py``; same values as the JAX functions).

Scheme (dynamic W8A8, no calibration):
- weights: symmetric per-output-channel int8, quantized once per rollout
  phase;
- activations: symmetric per-token dynamic int8, computed at the matmul
  (amax over the contraction dim, round-half-even, clip to +-127);
- the dot runs int8 x int8 -> int32, then both fp32 scales fold into the
  result: ``acc * xs * ws``. No dequantized weight copy exists.

A quantized weight is the dict ``{"qvalue": int8, "scale": fp32}`` (the JAX
package's pytree node): ``scale`` keeps the weight's non-contracted dims in
order. ``QuantLinear`` and ``QuantEmbedding`` hold one inside the model;
their ``weight`` attribute is that dict, so ``linear`` / ``embed_rows``
dispatch on a module's ``weight`` whether it is quantized or plain.

On CUDA the whole product — the activation quantize, the int8 dot and the
scale epilogue — is one hand-written kernel (``ops.int8_matmul``, the port
of the JAX package's fused W8A8 Pallas kernels), equal to the chain below
bit for bit; rows that are already quantized (the silu junction) run the
same kernel without its quantize prologue. On the CPU the chain runs as
plain tensor ops with ``torch._int_mm`` for the exact int32 dot.

``quantize_model(mode="w4a8")`` adds int4 decode copies of each MLP's
gate_up and down weights (``ops.int4_mlp.Int4Weight``); the MLP runs them
through ``ops.int4_mlp.w4_swiglu`` where the JAX package's eligibility rule
admits the shape and takes the int8 path otherwise.

``quantize_model(prefill_dequant_min_m=m)`` is the JAX package's opt-in
prefill-dequant mode (its ``SPATIALTHINKER_PREFILL_DEQUANT_M``, off by
default), taken as an argument: every quantized weight of the copy carries
the threshold (the weight dict's ``"dequant_min_m"``), and a product of at
least ``m`` rows dequantizes the weight (``dequantize_weight``) and runs a
bf16 ``torch.matmul`` instead of the W8A8 kernel, as the JAX package runs an
XLA dot there; the silu junction then stays unfused. Below ``m``, and at 0,
nothing changes.

Under tensor parallelism (a rank's shard of a TP-local model,
``parallel/tensor.py``) every number equals the slice of the single-device
copy: column-parallel weights (qkv, gate_up) quantize as they are; the
row-parallel ones (o, down) take each output channel's amax over the whole
contraction, the group's max (``quantize_weight(..., tp=)``), and so does
the per-row scale of their input (``row_parallel_dot``,
``row_parallel_silu_dot``: the group's max of the rows' amaxes between the
two passes of kernel A's row quantize in its split mode, then kernel A's
prequantized entry; at prefill-sized m the silu junction's split mode).
Each rank's product is a partial sum in fp32 that the caller adds over the
group.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import all_reduce_max, tp_size
from .int4_mlp import Int4Weight
from .int8_matmul import (
    fused_w8a8_matmul, int8_matmul, quantize_rows_split, w8a8_epilogue, w8a8_matmul_prequantized,
)
from .int8_matmul import quantize_rows as quantize_activation  # per-token (last-dim) int8, scale (..., 1)

QWeight = Dict[str, torch.Tensor]

_EPS = 1e-8
FUSED_SILU_MIN_M = 1024  # below it (decode) the junction stays unfused


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "qvalue" in w


def _dequant_at(qw: QWeight, m: int) -> bool:
    """Whether a product of ``m`` rows takes the prefill-dequant path."""
    min_m = qw.get("dequant_min_m", 0)
    return bool(min_m) and m >= min_m


def dequantize_weight(qw: QWeight, contract_axis: int, dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 weight times its per-channel scale, in ``dtype`` (both cast
    to ``dtype`` first, as the JAX package does)."""
    return qw["qvalue"].to(dtype) * qw["scale"].unsqueeze(contract_axis).to(dtype)


def quantize_weight(w: torch.Tensor, contract_axis: int, tp=None) -> QWeight:
    """Symmetric per-output-channel int8: one scale per slice of the
    contraction axis. ``scale`` keeps the weight's non-contracted dims in
    order — the broadcast the int32 dot result needs. ``tp``: ``w`` is a
    row-parallel shard (its contraction split over the group), whose
    channel amax is the group's max."""
    wf = w.float()
    a = all_reduce_max(wf.abs().amax(dim=contract_axis), tp)
    scale = torch.clamp(a, min=_EPS) / 127.0
    q = torch.clamp(torch.round(wf / scale.unsqueeze(contract_axis)), -127, 127).to(torch.int8)
    return {"qvalue": q, "scale": scale}


def _as_kn(qvalue: torch.Tensor, contract_axis: int) -> torch.Tensor:
    """The weight as a (K, N) matrix, N = the non-contracted dims flattened in
    order. A view for the model's (N, K) weights (contract_axis 1)."""
    if qvalue.dim() == 2:
        return qvalue if contract_axis == 0 else qvalue.t()
    moved = qvalue.movedim(contract_axis, 0)
    return moved.reshape(moved.shape[0], -1)


def _kernel_weight(qvalue: torch.Tensor, contract_axis: int) -> torch.Tensor:
    """The (N, K) row-major int8 matrix the CUDA kernel takes: the model's
    2-D weights contracted on axis 1, as they are."""
    if qvalue.dim() != 2 or contract_axis != 1:
        raise ValueError(
            f"the W8A8 kernel takes 2-D (N, K) weights contracted on axis 1, got "
            f"{tuple(qvalue.shape)} on axis {contract_axis}")
    return qvalue


def prequantized_dot(xq: torch.Tensor, xs: torch.Tensor, qw: QWeight, contract_axis: int,
                     out_dtype) -> torch.Tensor:
    """The int8 dot and the scale-folding epilogue for an activation that is
    already int8 (+ per-row scale (..., 1)). Output shape = x's lead dims +
    qw's non-contracted dims in order."""
    qv = qw["qvalue"]
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1])
    if xq.is_cuda:
        out = w8a8_matmul_prequantized(x2.contiguous(), xs.reshape(-1).contiguous(),
                                       _kernel_weight(qv, contract_axis), qw["scale"], out_dtype)
    else:
        out = w8a8_epilogue(int8_matmul(x2, _as_kn(qv, contract_axis)), xs, qw["scale"], out_dtype)
    free = qv.shape[:contract_axis] + qv.shape[contract_axis + 1:]
    return out.reshape(*lead, *free)


def quantized_dot(x: torch.Tensor, qw: QWeight, contract_axis: int, out_dtype=None) -> torch.Tensor:
    """x (..., K) @ qw (K at ``contract_axis``), both operands int8: the fused
    kernel for a CUDA tensor, the quantize -> ``_int_mm`` -> epilogue chain
    for a CPU tensor (the same values)."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if _dequant_at(qw, math.prod(x.shape[:-1])):
        w = _as_kn(dequantize_weight(qw, contract_axis), contract_axis)
        return torch.matmul(x.to(torch.bfloat16), w).to(out_dtype)
    if not x.is_cuda:
        xq, xs = quantize_activation(x)
        return prequantized_dot(xq, xs, qw, contract_axis, out_dtype)
    w = _kernel_weight(qw["qvalue"], contract_axis)
    out = fused_w8a8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w, qw["scale"], out_dtype)
    return out.reshape(*x.shape[:-1], w.shape[0])


def fused_silu_quant_dot(gu: torch.Tensor, qdown: QWeight, out_dtype,
                         contract_axis: int = 1) -> Optional[torch.Tensor]:
    """SwiGLU tail of the quantized tree: silu(gate) * up and the down-proj's
    per-token activation quantize in one pass (``ops.silu_quant``), then the
    int8 down dot on the pre-quantized rows. ``gu`` is (..., 2I), gate columns
    first. Returns None when ineligible (decode-sized m: the caller runs silu
    + ``linear``)."""
    lead = gu.shape[:-1]
    m = math.prod(lead)
    if m < FUSED_SILU_MIN_M or m % 8 or _dequant_at(qdown, m):
        # (prefill-dequant: the down dot runs bf16, so an int8 junction would
        # only quantize what the bf16 product then reads unquantized)
        return None
    from .silu_quant import fused_silu_quantize

    xq, xs = fused_silu_quantize(gu.reshape(m, gu.shape[-1]))
    res = prequantized_dot(xq, xs, qdown, contract_axis, out_dtype)
    return res.reshape(*lead, *res.shape[1:])


def row_parallel_dot(x: torch.Tensor, qw: QWeight, tp, contract_axis: int = 1) -> torch.Tensor:
    """This rank's fp32 partial sum of x (..., K / tp) @ a row-parallel int8
    weight shard: x quantized with the whole row's scale (kernel A's row
    quantize in its split mode, the group's max of the rows' amaxes between
    its passes), then kernel A's prequantized entry (their plain versions on
    the CPU). Prefill-dequant m: the dequantized shard's bf16 product."""
    if _dequant_at(qw, math.prod(x.shape[:-1])):
        w = _as_kn(dequantize_weight(qw, contract_axis), contract_axis)
        return torch.matmul(x.to(torch.bfloat16), w).float()
    lead = x.shape[:-1]
    xq, xs = quantize_rows_split(x.reshape(-1, x.shape[-1]).contiguous(), lambda a: all_reduce_max(a, tp))
    return prequantized_dot(xq.reshape(*lead, -1), xs.reshape(*lead, 1), qw, contract_axis, torch.float32)


def row_parallel_silu_dot(gu: torch.Tensor, qdown: QWeight, tp, fused: bool = True) -> torch.Tensor:
    """The TP shard's SwiGLU tail on the quantized tree: ``gu`` (..., 2I / tp)
    -> this rank's fp32 partial of the down product. Prefill-sized m (as
    ``fused_silu_quant_dot`` admits it) runs the silu junction's split mode
    with the group's row amax; otherwise silu * up and ``row_parallel_dot``."""
    lead = gu.shape[:-1]
    m = math.prod(lead)
    if fused and m >= FUSED_SILU_MIN_M and m % 8 == 0 and not _dequant_at(qdown, m):
        from .silu_quant import fused_silu_quantize_split

        xq, xs = fused_silu_quantize_split(gu.reshape(m, gu.shape[-1]), lambda a: all_reduce_max(a, tp))
        res = prequantized_dot(xq, xs, qdown, 1, torch.float32)
        return res.reshape(*lead, *res.shape[1:])
    gate, up = gu.chunk(2, dim=-1)
    return row_parallel_dot(F.silu(gate) * up, qdown, tp)


def embed_rows(w: Union[torch.Tensor, QWeight], ids: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding-table row gather, quantized or plain. Rows of an int8 table
    dequantize after the gather; ``dtype`` is the model's compute dtype. Plain
    tables keep their own dtype."""
    if is_quantized(w):
        rows = F.embedding(ids, w["qvalue"]).to(dtype)
        return rows * w["scale"][ids].unsqueeze(-1).to(dtype)
    return F.embedding(ids, w)


def linear(x: torch.Tensor, w: Union[torch.Tensor, QWeight], contract_axis: int = 0,
           out_dtype=None) -> torch.Tensor:
    """The decoder stack's one matmul entry point: x (..., K) contracted with
    w's ``contract_axis`` — quantized or plain."""
    if is_quantized(w):
        return quantized_dot(x, w, contract_axis, out_dtype=out_dtype)
    if w.dim() == 2:
        out = F.linear(x, w) if contract_axis == 1 else x @ w
    else:
        out = torch.tensordot(x, w, dims=([x.dim() - 1], [contract_axis]))
    return out if out_dtype is None else out.to(out_dtype)


# ---------------------------------------------------------------------------
# quantized modules and the model pass
# ---------------------------------------------------------------------------


class QuantLinear(nn.Module):
    """An ``nn.Linear`` with its (out, in) weight held as int8 rows + one fp32
    scale per output row. ``bias`` is the source layer's parameter, shared."""

    def __init__(self, qvalue: torch.Tensor, scale: torch.Tensor, bias=None,
                 dequant_min_m: int = 0):
        super().__init__()
        self.register_buffer("qvalue", qvalue)
        self.register_buffer("scale", scale)
        self.bias = bias
        self.dequant_min_m = dequant_min_m

    @classmethod
    def from_linear(cls, lin: nn.Linear, dequant_min_m: int = 0, tp=None) -> "QuantLinear":
        """``tp``: a row-parallel shard (its channel amax is the group's)."""
        qw = quantize_weight(lin.weight.detach(), 1, tp)
        return cls(qw["qvalue"], qw["scale"], lin.bias, dequant_min_m)

    @property
    def weight(self) -> QWeight:
        return {"qvalue": self.qvalue, "scale": self.scale, "dequant_min_m": self.dequant_min_m}


class QuantEmbedding(nn.Module):
    """A (V, E) table as int8 rows + one fp32 scale per vocab row: the scales
    serve the row gather and, for a tied head, the logits' per-column dequant."""

    def __init__(self, qvalue: torch.Tensor, scale: torch.Tensor, dequant_min_m: int = 0):
        super().__init__()
        self.register_buffer("qvalue", qvalue)
        self.register_buffer("scale", scale)
        self.dequant_min_m = dequant_min_m

    @property
    def weight(self) -> QWeight:
        return {"qvalue": self.qvalue, "scale": self.scale, "dequant_min_m": self.dequant_min_m}


def _pick_w4_group(k: int) -> Optional[int]:
    """The int4 group size along a contraction of ``k``: the largest of 128 /
    64 / 32 / 16 / 8 with 2 * group dividing k (split-half packing)."""
    for g in (128, 64, 32, 16, 8):
        if k % (2 * g) == 0:
            return g
    return None


@torch.no_grad()
def quantize_model(model, mode: str = "int8", fused_silu: bool = True,
                   prefill_dequant_min_m: int = 0):
    """A rollout copy of ``model`` (a ``Qwen25VL``) whose text decoder-stack
    matmul weights (qkv / o / gate_up / down), ``embed_tokens`` and an untied
    ``lm_head`` are int8 (counterpart of ``quantize_params``). The vision
    tower, norms and biases are the source model's own modules and
    parameters, shared by reference — no copy. The pass runs layer by layer,
    so its fp32 temporaries are one layer's.

    ``mode="w4a8"`` also packs each MLP's gate_up and down weights into int4
    decode copies (``mlp.gate_up_w4``, ``mlp.down_w4``) where both
    contractions admit a group size; decode-sized m then streams half the MLP
    weight bytes while prefill keeps the int8 path.

    ``fused_silu=False`` keeps the MLP junction unfused at every m (the JAX
    package's ``SPATIALTHINKER_FUSED_SILU=0``). The JAX package's
    ``SPATIALTHINKER_W4=0`` (int4 copies built, never run) is an MLP's ``w4``
    attribute set to False.

    A TP-local ``model`` (its ``tp`` set; ``embed_tokens`` / ``lm_head``
    whole, as the rollout copy keeps them) gives a TP-local copy: o and down
    take the group's channel amax. ``w4a8`` under TP is ROADMAP A13c."""
    if mode not in ("int8", "w4a8"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    from ..models.qwen2_5_vl.model import Qwen25VL

    tp = model.tp
    if tp_size(tp) > 1 and (mode == "w4a8" or model.text.vocab_split):
        raise ValueError("quantize_model under tensor parallelism takes a rollout copy with the whole "
                         "vocab, in mode int8 (w4a8 under TP: ROADMAP A13c)")
    tc = model.cfg.text
    g_e, g_i = _pick_w4_group(tc.hidden_size), _pick_w4_group(tc.intermediate_size)
    want_w4 = mode == "w4a8" and g_e is not None and g_i is not None

    out = Qwen25VL(model.cfg, device="meta", dtype=model.text.norm.weight.dtype, tp=tp, whole_vocab=True)
    out.vision = model.vision
    src_text, dst_text = model.text, out.text
    dst_text.norm = src_text.norm
    for src, dst in zip(src_text.layers, dst_text.layers):
        dst.input_layernorm = src.input_layernorm
        dst.post_attention_layernorm = src.post_attention_layernorm
        m = prefill_dequant_min_m
        dst.self_attn.qkv_proj = QuantLinear.from_linear(src.self_attn.qkv_proj, m)
        dst.self_attn.o_proj = QuantLinear.from_linear(src.self_attn.o_proj, m, tp)
        dst.mlp.gate_up_proj = QuantLinear.from_linear(src.mlp.gate_up_proj, m)
        dst.mlp.down_proj = QuantLinear.from_linear(src.mlp.down_proj, m, tp)
        dst.mlp.fused_silu = fused_silu
        if want_w4:
            dst.mlp.gate_up_w4 = Int4Weight.from_weight(src.mlp.gate_up_proj.weight, g_e)
            dst.mlp.down_w4 = Int4Weight.from_weight(src.mlp.down_proj.weight, g_i)
    emb = quantize_weight(src_text.embed_tokens.weight.detach(), 1)
    dst_text.embed_tokens = QuantEmbedding(emb["qvalue"], emb["scale"], prefill_dequant_min_m)
    if not model.cfg.text.tie_word_embeddings:
        dst_text.lm_head = QuantLinear.from_linear(src_text.lm_head, prefill_dequant_min_m)
    return out.eval()
