"""Plain PyTorch Qwen2.5-VL: the vision tower of one image and the text decoder
of one sequence, in float32 with TF32 off, following the published model
(Qwen2.5-VL technical report; the published ``modeling_qwen2_5_vl``).

It reads the weights by the names of ``perfbench/weights.py``; the fused text
``qkv_proj`` rows are, per kv head, that group's q heads, its k head and its
v head, and ``gate_up_proj`` is [gate; up]. Departures from a serving
implementation, none of them in the mathematics: one image and one sequence
at a time, the window attention of the vision tower as a mask over the
image's patches in their natural (2 x 2 merge block) order, each decoder layer
and vision block checkpointed so that the backward fits.

``precision="fp8"`` runs every linear layer on operands rounded to float8
e4m3 with one scale per row (activations per token, weights per output
channel), the products summed in float32, the backward on the same rounded
operands: the control, one precision below the bfloat16 the configuration
states.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per row, back in float32."""
    scale = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_rows(x), fp8_rows(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        return dy @ wq, (dy.reshape(-1, dy.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1]))


class Reference:
    """The model over a dict of float32 leaves (``params``); ``model`` is the
    configuration's ``model`` block (the published config.json)."""

    def __init__(self, model: dict, params: Dict[str, torch.Tensor], precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.m, self.vc, self.p, self.precision = model, model["vision_config"], params, precision

    # ------------------------------------------------------------ pieces

    def linear(self, x: torch.Tensor, name: str, bias: bool = False) -> torch.Tensor:
        w = self.p[name + ".weight"]
        y = _Fp8Linear.apply(x, w) if self.precision == "fp8" else x @ w.t()
        return y + self.p[name + ".bias"] if bias else y

    def rms(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * self.p[name]

    @staticmethod
    def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin

    @staticmethod
    def attend(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q, k, v (S, H, D); ``mask`` (S, S) True where a query sees a key."""
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)

    # ------------------------------------------------------------ vision

    def vision(self, patches: torch.Tensor, grid) -> torch.Tensor:
        """Merged embeddings (N / 4, out_hidden) of one image, natural order.
        ``patches`` (N, C*T*P*P) float32, ``grid`` (t, h, w) in patches."""
        vc = self.vc
        t, gh, gw = (int(v) for v in grid)
        merge = vc["spatial_merge_size"]
        heads, e = vc["num_heads"], vc["hidden_size"]
        d = e // heads
        dev = patches.device
        # (h, w) of every patch in merge-block order
        hh = torch.arange(gh, device=dev)[:, None].expand(gh, gw)
        ww = torch.arange(gw, device=dev)[None, :].expand(gh, gw)

        def blocks(a):
            return a.reshape(gh // merge, merge, gw // merge, merge).permute(0, 2, 1, 3).reshape(-1)

        hpos, wpos = blocks(hh).repeat(t), blocks(ww).repeat(t)
        inv = 1.0 / (10000.0 ** (torch.arange(0, d // 2, 2, device=dev, dtype=torch.float32) / (d // 2)))
        half = torch.cat([hpos[:, None].float() * inv, wpos[:, None].float() * inv], -1)
        emb = torch.cat([half, half], -1)[:, None, :]  # (N, 1, D)
        cos, sin = emb.cos(), emb.sin()
        win = vc["window_size"] // merge // vc["patch_size"]
        nw = -(-(gw // merge) // win)
        frame = torch.arange(t, device=dev).repeat_interleave(gh * gw)
        window = frame * 1_000_000 + (hpos // merge // win) * nw + (wpos // merge // win)
        window_mask = window[:, None] == window[None, :]
        frame_mask = frame[:, None] == frame[None, :]

        x = self.linear(patches, "vision.patch_embed")
        for i in range(vc["depth"]):
            mask = frame_mask if i in vc["fullatt_block_indexes"] else window_mask
            x = checkpoint(self._vision_block, x, cos, sin, mask, i, use_reentrant=False)
        x = self.rms(x, "vision.merger.ln_q.weight", 1e-6)
        x = x.reshape(-1, merge * merge * e)
        x = F.gelu(self.linear(x, "vision.merger.fc1", bias=True))
        return self.linear(x, "vision.merger.fc2", bias=True)

    def _vision_block(self, x, cos, sin, mask, i: int):
        vc = self.vc
        p = f"vision.blocks.{i}."
        heads = vc["num_heads"]
        n, e = x.shape
        qkv = self.linear(self.rms(x, p + "norm1.weight", 1e-6), p + "qkv", bias=True)
        q, k, v = qkv.reshape(n, 3, heads, e // heads).unbind(1)
        out = self.attend(self.rotate(q, cos, sin), self.rotate(k, cos, sin), v, mask)
        x = x + self.linear(out.reshape(n, e), p + "proj", bias=True)
        h = self.rms(x, p + "norm2.weight", 1e-6)
        gate = self.linear(h, p + "mlp.gate_proj", bias=True)
        up = self.linear(h, p + "mlp.up_proj", bias=True)
        return x + self.linear(F.silu(gate) * up, p + "mlp.down_proj", bias=True)

    # ------------------------------------------------------------ text

    def response_log_probs(self, ids: torch.Tensor, positions: torch.Tensor, image: Optional[torch.Tensor],
                           n_prompt: int, temperature: float = 1.0) -> torch.Tensor:
        """Log-probs (R,) of the response tokens of one sequence: ``ids`` (L,)
        prompt then response, ``positions`` (3, L), ``image`` the merged
        vision embeddings of the prompt's image tokens, in order."""
        m = self.m
        x = self.p["text.embed_tokens.weight"][ids.long()]
        if image is not None:
            slots = (ids == m["image_token_id"]).nonzero().squeeze(-1)
            x = x.index_put((slots,), image)
        e, h = m["hidden_size"], m["num_attention_heads"]
        d = e // h
        inv = 1.0 / (m["rope_theta"] ** (torch.arange(0, d, 2, device=ids.device, dtype=torch.float64) / d))
        freqs = positions.double()[..., None] * inv  # (3, L, D/2)
        section = m["rope_scaling"]["mrope_section"]
        parts, at = [], 0
        for c, width in enumerate(section):
            parts.append(freqs[c, :, at:at + width])
            at += width
        half = torch.cat(parts, -1).float()
        emb = torch.cat([half, half], -1)[:, None, :]  # (L, 1, D)
        cos, sin = emb.cos(), emb.sin()
        causal = torch.ones(len(ids), len(ids), dtype=torch.bool, device=ids.device).tril()
        for i in range(m["num_hidden_layers"]):
            x = checkpoint(self._text_layer, x, cos, sin, causal, i, use_reentrant=False)
        hidden = self.rms(x[n_prompt - 1:-1], "text.norm.weight", m["rms_norm_eps"])
        head = "text.embed_tokens" if m["tie_word_embeddings"] else "text.lm_head"
        logits = self.linear(hidden, head) / temperature
        targets = ids[n_prompt:].long()
        return logits.gather(-1, targets[:, None]).squeeze(-1) - torch.logsumexp(logits, -1)

    def _text_layer(self, x, cos, sin, causal, i: int):
        m = self.m
        p = f"text.layers.{i}."
        h, hkv = m["num_attention_heads"], m["num_key_value_heads"]
        d = m["hidden_size"] // h
        per = h // hkv
        n = x.shape[0]
        eps = m["rms_norm_eps"]
        qkv = self.linear(self.rms(x, p + "input_layernorm.weight", eps), p + "self_attn.qkv_proj", bias=True)
        qkv = qkv.reshape(n, hkv, per + 2, d)
        q = qkv[:, :, :per].reshape(n, h, d)
        k, v = qkv[:, :, per], qkv[:, :, per + 1]
        q, k = self.rotate(q, cos, sin), self.rotate(k, cos, sin)
        out = self.attend(q, k.repeat_interleave(per, 1), v.repeat_interleave(per, 1), causal)
        x = x + self.linear(out.reshape(n, h * d), p + "self_attn.o_proj")
        g, u = self.linear(self.rms(x, p + "post_attention_layernorm.weight", eps),
                           p + "mlp.gate_up_proj").chunk(2, -1)
        return x + self.linear(F.silu(g) * u, p + "mlp.down_proj")
