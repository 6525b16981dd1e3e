"""Qwen2.5-VL text decoder in PyTorch (counterpart of
``spatialthinker_tpu/models/qwen2_5_vl/text.py``).

GQA attention with QKV biases, mRoPE, RMSNorm with fp32 accumulation, SwiGLU
MLP, optional tied embeddings. Layers are a ``ModuleList`` run by a Python
loop (the JAX package scans stacked (L, ...) leaves). Weight layouts keep
the JAX package's fusions in PyTorch's (out, in) form:

- ``qkv_proj``: one Linear whose output columns are per kv group
  ``[q heads of the group | k | v]`` (the JAX (Hkv, E, G) weight, flattened);
- ``gate_up_proj``: one Linear whose output is ``[gate | up]`` (the JAX
  (2, E, I) weight, and the quantized tree's 2D (E, 2I) one).

Every decoder matmul goes through ``ops.quant.linear`` on the module's
``weight``, so the int8 rollout copy (``ops.quant.quantize_model``) runs the
W8A8 path with no second code path; the w4a8 copy's MLP runs its int4 decode
copies first (``ops.int4_mlp.w4_swiglu``).

The KV cache is head-major (L, B, Hkv, Smax, D) and written in place: bf16,
int8 (per token-head bf16 scales) or int4 (uint8 marker: two tokens per
byte, split-half along the sequence — token t lives in byte row
t % (Smax/2), low nibble for t < Smax/2, high nibble otherwise, stored +8
biased). The int8/int4 encodings are bit-identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import attention
from ...ops.decode_attention import decode_attention
from ...ops.logprobs import matmul_fp32_out
from ...ops.int4_mlp import w4_swiglu
from ...ops.quant import embed_rows, fused_silu_quant_dot, is_quantized, linear, quantized_dot
from .config import TextConfig
from .rope import apply_rotary, compute_cos_sin, make_inv_freq


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


@dataclass
class KVCache:
    """Dense KV cache, head-major (L, B, Hkv, Smax, D). ``length`` is the
    filled prefix, uniform across the batch (a Python int: chunked prefill
    slices the live prefix by it). With dtype int8 the values are quantized
    per token-head with bf16 scales (L, B, Hkv, Smax); with the int4 marker
    dtype uint8 the buffers are (L, B, Hkv, Smax/2, D) packed byte rows and
    the scales stay per token."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def init(cls, num_layers, batch, max_len, num_kv_heads, head_dim, *, dtype, device):
        shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
        if dtype not in (torch.int8, torch.uint8):
            return cls(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
        if dtype == torch.uint8:  # int4 marker: packed (Smax/2, D) byte rows
            if max_len % 2:
                raise ValueError(f"an int4 cache needs an even width, got {max_len}")
            shape = shape[:3] + (max_len // 2, head_dim)
        sshape = (num_layers, batch, num_kv_heads, max_len)
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device), 0,
            torch.zeros(sshape, dtype=torch.bfloat16, device=device),
            torch.zeros(sshape, dtype=torch.bfloat16, device=device),
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def arrays(self) -> tuple:
        """(k, v[, k_scale, v_scale])."""
        if self.quantized:
            return (self.k, self.v, self.k_scale, self.v_scale)
        return (self.k, self.v)


def _quantize_kv(x: torch.Tensor):
    """(..., S, D) -> int8 values + (..., S) bf16 scales (symmetric max-abs)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale.unsqueeze(-1)), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float().unsqueeze(-1)).to(dtype)


def _quantize_kv4(x: torch.Tensor):
    """(..., S, D) -> int4 values in [-7, 7] (as int8) + (..., S) bf16 scales."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 7.0
    q = torch.clamp(torch.round(xf / scale.unsqueeze(-1)), -7, 7)
    return q.to(torch.int8), scale.to(torch.bfloat16)


KV4_BIAS = 8  # stored nibble = value + 8 (unsigned [1, 15]; values clip +-7)


def _biased(q4: torch.Tensor) -> torch.Tensor:
    """int4-valued int8 -> biased uint8 nibble values."""
    return (q4 + KV4_BIAS).to(torch.uint8)


def _pack_nibbles(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Two int4-valued int8 tensors -> one uint8: (low+8) | (high+8) << 4.
    The +8 bias keeps the stored nibbles unsigned, so a kernel unpacks with a
    mask and a shift and folds the -8 into its dot epilogue."""
    return (_biased(low) & 0xF) | (_biased(high) << 4)


def _unpack_nibbles(p: torch.Tensor):
    """uint8 -> (low int8, high int8): unbias the stored nibbles."""
    lo = (p & 15).to(torch.int8) - KV4_BIAS
    hi = (p >> 4).to(torch.int8) - KV4_BIAS
    return lo, hi


def _unpack_kv4(packed: torch.Tensor, seq_axis: int) -> torch.Tensor:
    """Packed (..., S/2, D) -> int8 (..., S, D): low nibbles are tokens
    [0, S/2), high nibbles [S/2, S) (split-half layout)."""
    low, high = _unpack_nibbles(packed)
    return torch.cat([low, high], dim=seq_axis)


def repack_kv4(src: torch.Tensor, total: int) -> torch.Tensor:
    """Re-lay a packed int4 buffer holding tokens [0, p) of a width-p cache
    (L, B, Hkv, p/2, D) into the split-half layout of a width-``total`` cache
    (L, B, Hkv, total/2, D): the nibble half of token t is t // (S/2), so a
    width change is one unpack/repack pass over the prompt KV. Cells beyond
    p hold the value 0 (stored nibble 8)."""
    p = 2 * src.shape[3]
    half_t = total // 2
    toks = _unpack_kv4(src, seq_axis=3)  # (L, B, Hkv, p, D) int8
    n_low = min(p, half_t)
    low = F.pad(toks[:, :, :, :n_low], (0, 0, 0, half_t - n_low))
    high = F.pad(toks[:, :, :, half_t:], (0, 0, 0, half_t - max(p - half_t, 0)))
    return _pack_nibbles(low, high)


def _update_kv4(arr: torch.Tensor, q4: torch.Tensor, layer_idx: int, start: int) -> torch.Tensor:
    """Write int4 token rows [start, start+s) of q4 (B, Hkv, s, D) into the
    packed (L, B, Hkv, Smax/2, D) uint8 buffer, in place; a write that crosses
    the half boundary splits into a low-nibble and a high-nibble part. The
    decode step's single token touches one nibble of a byte whose other
    nibble belongs to another token: a read-modify-write of that byte row."""
    half = arr.shape[3]
    s = q4.shape[2]
    qb = _biased(q4)
    n_low = max(0, min(s, half - start))
    if n_low:
        slab = arr[layer_idx, :, :, start : start + n_low]
        slab.copy_((slab & 0xF0) | (qb[:, :, :n_low] & 0xF))
    if n_low < s:
        row = start + n_low - half
        slab = arr[layer_idx, :, :, row : row + s - n_low]
        slab.copy_((slab & 0x0F) | (qb[:, :, n_low:] << 4))
    return arr


def _layer_kv(ck, cv, layer_idx: int, dtype, k_scale=None, v_scale=None, end=None):
    """One layer's cache as (B, S, Hkv, D) for the chunked-prefill attention
    (decode reads the cache through its kernel instead). ``end`` slices the
    live prefix so only written cells are read; an int4 cache unpacks only
    the written byte rows."""
    k_l, v_l = ck[layer_idx], cv[layer_idx]
    if ck.dtype == torch.uint8:
        half = ck.shape[3]

        def unpack_live(p_l):
            n_low = min(end, half) if end is not None else half
            low, high = _unpack_nibbles(p_l[:, :, :n_low])
            if end is not None and end <= half:
                return low
            n_high = (end - half) if end is not None else half
            return torch.cat([low, high[:, :, :n_high]], dim=2)

        k_l, v_l = unpack_live(k_l), unpack_live(v_l)
    elif end is not None:
        k_l, v_l = k_l[:, :, :end], v_l[:, :, :end]
    if k_scale is not None:
        ks, vs = k_scale[layer_idx], v_scale[layer_idx]
        if end is not None:
            ks, vs = ks[:, :, :end], vs[:, :, :end]
        k_l = _dequantize_kv(k_l, ks, dtype)
        v_l = _dequantize_kv(v_l, vs, dtype)
    return k_l.transpose(1, 2), v_l.transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: TextConfig, device=None, dtype=None):
        super().__init__()
        h, hkv, d, e = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.hidden_size
        self.qkv_proj = nn.Linear(e, hkv * (h // hkv + 2) * d, bias=True, device=device, dtype=dtype)
        self.o_proj = nn.Linear(h * d, e, bias=False, device=device, dtype=dtype)


class MLP(nn.Module):
    def __init__(self, cfg: TextConfig, device=None, dtype=None):
        super().__init__()
        e, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_up_proj = nn.Linear(e, 2 * inter, bias=False, device=device, dtype=dtype)
        self.down_proj = nn.Linear(inter, e, bias=False, device=device, dtype=dtype)
        # w4a8 tree: int4 decode copies (ops.int4_mlp.Int4Weight), else None
        self.gate_up_w4 = None
        self.down_w4 = None

    fused_silu = True  # quantized tree: fuse the junction at prefill-sized m
    w4 = True          # w4a8 tree: use the int4 copies where the shape admits them

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """SwiGLU (the JAX package's ``swiglu_mlp``) over the fused gate_up, in
        its order: on the w4a8 tree the int4 copies first (``w4_swiglu``, None
        where the shape is refused); on the quantized tree prefill-sized m
        (>= 1024 rows, a multiple of 8) through the fused silu->int8 junction
        and the int8 down dot; otherwise silu + ``linear``."""
        gup, down = self.gate_up_proj.weight, self.down_proj.weight
        if self.gate_up_w4 is not None and self.w4:
            out = w4_swiglu(x, self.gate_up_w4, self.down_w4, out_dtype=x.dtype)
            if out is not None:
                return out
        gu = linear(x, gup, contract_axis=1)
        if is_quantized(gup) and self.fused_silu:
            fused = fused_silu_quant_dot(gu, down, out_dtype=x.dtype)
            if fused is not None:
                return fused
        gate, up = gu.chunk(2, dim=-1)
        return linear(F.silu(gate) * up, down, contract_axis=1)


def fused_qkv(attn: Attention, normed: torch.Tensor, h: int, hkv: int, d: int):
    """One wide QKV matmul -> (q (..., H, D), k (..., Hkv, D), v). Group-major
    q ordering equals the HF head order, so no permutation exists."""
    qper = h // hkv
    w, bias = attn.qkv_proj.weight, attn.qkv_proj.bias
    if is_quantized(w):
        fused = linear(normed, w, contract_axis=1) + bias
    else:
        fused = F.linear(normed, w, bias)  # matmul and bias in one launch
    fused = fused.unflatten(-1, (hkv, (qper + 2) * d))
    lead = fused.shape[:-2]
    q = fused[..., : qper * d].reshape(*lead, h, d)
    k = fused[..., qper * d : (qper + 1) * d]
    v = fused[..., (qper + 1) * d :]
    return q, k, v


def attention_inputs(layer: "DecoderLayer", cfg: TextConfig, x: torch.Tensor, cos, sin):
    """Shared head of every decoder layer (prefill, dense-cache decode and the
    paged engine's per-slot decode): rms-norm -> fused QKV -> mRoPE. The
    engines differ only in how they write k/v into their cache."""
    normed = layer.input_layernorm(x)
    q, k, v = fused_qkv(
        layer.self_attn, normed, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    )
    q, k = apply_rotary(q, k, cos, sin)
    return q, k, v


def finish_layer(layer: "DecoderLayer", cfg: TextConfig, x: torch.Tensor, out: torch.Tensor):
    """Shared tail of every decoder layer: o_proj residual + SwiGLU MLP
    residual. ``out`` is the attention output (B, S, H, D)."""
    b, s = out.shape[:2]
    x = x + linear(out.reshape(b, s, -1), layer.self_attn.o_proj.weight, contract_axis=1)
    return x + layer.mlp(layer.post_attention_layernorm(x))


def _write_cache(cache: KVCache, layer_idx: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write this step's k/v (B, s, Hkv, D) at ``cache.length``, in place
    (replaces the JAX carry's dynamic_update_slice), quantizing per token-head
    for the int8 and int4 caches."""
    start = cache.length
    end = start + k.shape[1]
    k_hm, v_hm = k.transpose(1, 2), v.transpose(1, 2)  # (B, Hkv, s, D)
    if cache.k.dtype == torch.uint8:
        kq, ks = _quantize_kv4(k_hm)
        vq, vs = _quantize_kv4(v_hm)
        _update_kv4(cache.k, kq, layer_idx, start)
        _update_kv4(cache.v, vq, layer_idx, start)
    elif cache.k.dtype == torch.int8:
        kq, ks = _quantize_kv(k_hm)
        vq, vs = _quantize_kv(v_hm)
        cache.k[layer_idx, :, :, start:end] = kq
        cache.v[layer_idx, :, :, start:end] = vq
    else:
        cache.k[layer_idx, :, :, start:end] = k_hm
        cache.v[layer_idx, :, :, start:end] = v_hm
        return
    cache.k_scale[layer_idx, :, :, start:end] = ks
    cache.v_scale[layer_idx, :, :, start:end] = vs


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.self_attn = Attention(cfg, device, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.mlp = MLP(cfg, device, dtype)

    def forward(
        self,
        x: torch.Tensor,  # (B, S, E)
        cos: torch.Tensor,
        sin: torch.Tensor,
        segment_ids: Optional[torch.Tensor],
        cache: Optional[KVCache],
        layer_idx: int,
        kv_segment_ids: Optional[torch.Tensor] = None,  # (B, Smax) valid cells incl. cached prefix
        attend_to_cache: bool = False,  # chunked prefill: s > 1 queries see the cached prefix
        int4_i8dot: bool = False,  # int4 cache: both decode dots on int8 operands
    ) -> torch.Tensor:
        """No cache: causal self-attention. With a cache: write this step's
        k/v at ``cache.length``; then prefill (s > 1) attends the prompt's own
        k/v, chunked prefill (``attend_to_cache``) the dequantized live cache
        prefix plus the chunk through the flash kernel with a static
        ``causal_offset``, and decode (s == 1) the cache, in whichever format
        it is, through the decode kernels."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = attention_inputs(self, cfg, x, cos, sin)

        if cache is None:
            out = attention(q, k, v, segment_ids=segment_ids, causal=True)
        else:
            _write_cache(cache, layer_idx, k, v)
            if s > 1 and not attend_to_cache:
                out = attention(q, k, v, segment_ids=segment_ids, causal=True)
            elif s > 1:
                end = cache.length + s
                k_all, v_all = _layer_kv(
                    cache.k, cache.v, layer_idx, x.dtype, cache.k_scale, cache.v_scale, end=end
                )
                if kv_segment_ids is None:
                    kv_seg = torch.ones((b, end), dtype=torch.int32, device=x.device)
                else:
                    kv_seg = kv_segment_ids[:, :end]
                out = attention(
                    q, k_all.to(q.dtype), v_all.to(q.dtype), segment_ids=segment_ids,
                    kv_segment_ids=kv_seg, causal=True, causal_offset=cache.length,
                )
            else:
                # a bf16 cache meets the query in the cache's dtype (as the JAX
                # package's decode path casts it), a quantized one in x's; the
                # output returns to x's
                q1 = q[:, 0] if cache.quantized else q[:, 0].to(cache.k.dtype)
                out = decode_attention(
                    q1.contiguous(), cache.k, cache.v,
                    kv_segment_ids.to(torch.int32).contiguous(), layer_idx,
                    cache.k_scale, cache.v_scale, int4_i8dot=int4_i8dot,
                )[:, None].to(x.dtype)

        return finish_layer(self, cfg, x, out)


class TextModel(nn.Module):
    def __init__(self, cfg: TextConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype) for _ in range(cfg.num_hidden_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=device, dtype=dtype)


def forward_hidden(
    text: TextModel,
    *,
    input_ids: Optional[torch.Tensor] = None,      # (B, S)
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, S, E)
    position_ids: torch.Tensor,                    # (3, B, S)
    segment_ids: Optional[torch.Tensor] = None,    # (B, S); 0 = padding
    cache: Optional[KVCache] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,  # (B, Smax) validity of cache slots
    attend_to_cache: bool = False,
    remat: bool = False,
    int4_i8dot: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack; returns (hidden_states (B, S, E), cache with
    its length advanced by S — the same buffers, written in place).

    ``remat`` (training, no cache) wraps every decoder layer in
    ``torch.utils.checkpoint``: only layer inputs are kept and each layer's
    body is recomputed in the backward (the JAX package's ``remat="full"``;
    its matmul-outputs-saved policy has no counterpart here)."""
    cfg = text.cfg
    if inputs_embeds is None:
        inputs_embeds = embed_rows(text.embed_tokens.weight, input_ids, dtype=text.norm.weight.dtype)
    x = inputs_embeds
    inv_freq = torch.as_tensor(
        make_inv_freq(cfg.head_dim, cfg.rope_theta), dtype=torch.float32, device=x.device
    )
    cos, sin = compute_cos_sin(position_ids, inv_freq, cfg.mrope_section, dtype=x.dtype)
    if remat and cache is not None:
        raise ValueError("remat is for the training forward; a cache is written in place")
    for i, layer in enumerate(text.layers):
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, cos, sin, segment_ids, None, i, use_reentrant=False)
        else:
            x = layer(x, cos, sin, segment_ids, cache, i, kv_segment_ids, attend_to_cache, int4_i8dot)
    if cache is not None:
        cache = KVCache(cache.k, cache.v, cache.length + x.shape[1], cache.k_scale, cache.v_scale)
    return text.norm(x), cache


def logits_from_hidden(text: TextModel, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits (..., V): bf16 operands, fp32 accumulation AND fp32 output
    (the JAX dot's preferred_element_type=float32 — rounding the logits to
    bf16 would shift greedy ties and sampled log-probs)."""
    head = text.embed_tokens.weight if text.cfg.tie_word_embeddings else text.lm_head.weight
    if is_quantized(head):
        # rollout tree: the int8 dot; the per-vocab-row scales are the
        # per-output-column dequant the logits need
        return quantized_dot(hidden, head, 1, out_dtype=torch.float32)
    return matmul_fp32_out(hidden, head)
