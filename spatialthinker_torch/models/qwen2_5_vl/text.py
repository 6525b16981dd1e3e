"""Qwen2.5-VL text decoder in PyTorch, bf16 path (counterpart of
``spatialthinker_tpu/models/qwen2_5_vl/text.py``).

GQA attention with QKV biases, mRoPE, RMSNorm with fp32 accumulation, SwiGLU
MLP, optional tied embeddings. Layers are a ``ModuleList`` run by a Python
loop (the JAX package scans stacked (L, ...) leaves). Weight layouts keep
the JAX package's fusions in PyTorch's (out, in) form:

- ``qkv_proj``: one Linear whose output columns are per kv group
  ``[q heads of the group | k | v]`` (the JAX (Hkv, E, G) weight, flattened);
- ``gate_up_proj``: one Linear whose output is ``[gate | up]`` (the JAX
  (2, E, I) weight).

The KV cache is head-major (L, B, Hkv, Smax, D) — the decode kernel reads one
contiguous (S, D) stripe per (row, kv head) — and is written in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import attention
from ...ops.decode_attention import decode_attention
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
    """Dense bf16 KV cache, head-major (L, B, Hkv, Smax, D). ``length`` is
    the filled prefix, uniform across the batch."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @classmethod
    def init(cls, num_layers, batch, max_len, num_kv_heads, head_dim, *, dtype, device):
        shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """SwiGLU (the JAX package's ``swiglu_mlp``) over the fused gate_up."""
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


def fused_qkv(attn: Attention, normed: torch.Tensor, h: int, hkv: int, d: int):
    """One wide QKV matmul -> (q (..., H, D), k (..., Hkv, D), v). Group-major
    q ordering equals the HF head order, so no permutation exists."""
    qper = h // hkv
    fused = attn.qkv_proj(normed).unflatten(-1, (hkv, (qper + 2) * d))
    lead = fused.shape[:-2]
    q = fused[..., : qper * d].reshape(*lead, h, d)
    k = fused[..., qper * d : (qper + 1) * d]
    v = fused[..., (qper + 1) * d :]
    return q, k, v


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
        kv_segment_ids: Optional[torch.Tensor] = None,  # (B, Smax) valid cells; decode only
    ) -> torch.Tensor:
        """No cache: causal self-attention. With a cache: write this step's
        k/v at ``cache.length``, then prefill (s > 1) attends the prompt's own
        k/v and decode (s == 1) attends the cache through the decode kernel."""
        cfg = self.cfg
        b, s, _ = x.shape
        normed = self.input_layernorm(x)
        q, k, v = fused_qkv(
            self.self_attn, normed, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        )
        q, k = apply_rotary(q, k, cos, sin)

        if cache is None or s > 1:
            out = attention(q, k, v, segment_ids=segment_ids, causal=True)
        if cache is not None:
            # in-place write of this step's k/v: replaces the JAX carry's
            # dynamic_update_slice (spatialthinker_tpu text.py:366-374)
            end = cache.length + s
            cache.k[layer_idx, :, :, cache.length : end] = k.transpose(1, 2)
            cache.v[layer_idx, :, :, cache.length : end] = v.transpose(1, 2)
            if s == 1:
                # the query meets the cache in the cache's dtype (as the JAX
                # package's decode path casts it), the output returns to x's
                out = decode_attention(
                    q[:, 0].to(cache.k.dtype).contiguous(), cache.k, cache.v,
                    kv_segment_ids.to(torch.int32).contiguous(), layer_idx,
                )[:, None].to(x.dtype)

        x = x + self.self_attn.o_proj(out.reshape(b, s, -1))
        return x + self.mlp(self.post_attention_layernorm(x))


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
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack; returns (hidden_states (B, S, E), cache with
    its length advanced by S — the same buffers, written in place)."""
    cfg = text.cfg
    x = inputs_embeds if inputs_embeds is not None else text.embed_tokens(input_ids)
    inv_freq = torch.as_tensor(
        make_inv_freq(cfg.head_dim, cfg.rope_theta), dtype=torch.float32, device=x.device
    )
    cos, sin = compute_cos_sin(position_ids, inv_freq, cfg.mrope_section, dtype=x.dtype)
    for i, layer in enumerate(text.layers):
        x = layer(x, cos, sin, segment_ids, cache, i, kv_segment_ids)
    if cache is not None:
        cache = KVCache(cache.k, cache.v, cache.length + x.shape[1])
    return text.norm(x), cache


def logits_from_hidden(text: TextModel, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits (..., V): bf16 operands, fp32 accumulation AND fp32 output
    (the JAX dot's preferred_element_type=float32 — rounding the logits to
    bf16 would shift greedy ties and sampled log-probs)."""
    head = text.embed_tokens.weight if text.cfg.tie_word_embeddings else text.lm_head.weight
    flat = hidden.reshape(-1, hidden.shape[-1])
    if flat.is_cuda and flat.dtype in (torch.bfloat16, torch.float16):
        out = torch.mm(flat, head.t(), out_dtype=torch.float32)
    else:
        out = flat.float() @ head.float().t()
    return out.reshape(*hidden.shape[:-1], head.shape[0])
