"""Token log-probabilities (and entropy) from hidden states without keeping
(B, S, V) fp32 logits (counterpart of ``spatialthinker_tpu/ops/logprobs.py``).

The sequence is cut into chunks of ``chunk_size``; each chunk computes its
(B, C, V) fp32 logits, reduces them to log-prob and entropy and keeps only
those; its backward recomputes the chunk's logits (the JAX package's
checkpointed scan) and builds their cotangent in the same buffer
(``_ChunkLogProb``). Peak memory is O(B * C * V): one fp32 buffer and its
rounded copy, two with the entropy.

The head product keeps the JAX dot's numerics -- operands in the model's
dtype, fp32 accumulation and fp32 output (``preferred_element_type=float32``)
-- in the chunks and in ``matmul_fp32_out``, which carries its own gradient.
``head`` is in PyTorch's (V, E) layout (``embed_tokens.weight`` of a tied
model as it is; the JAX function takes the (E, V) transpose).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _logits_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, E) @ w (V, E)^T -> fresh (M, V) fp32, the head product's numerics."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype:
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return x.float() @ w.float().t()


class _MatmulFp32Out(torch.autograd.Function):
    """x (M, E) @ w (V, E)^T -> (M, V) fp32. Half-precision operands on the
    card go through one matmul with fp32 accumulation and fp32 output (no
    rounding of the logits); anything else is computed in fp32. The backward
    rounds the fp32 cotangent to the operands' dtype, so both gradient
    products run at the operands' precision with fp32 accumulation."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _logits_fp32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g.to(w.dtype) @ w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (g.to(x.dtype).t() @ x).to(w.dtype)
        return gx, gw


def matmul_fp32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., E) x (V, E) -> (..., V) fp32 logits, differentiable."""
    out = _MatmulFp32Out.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[0])


class _ChunkLogProb(torch.autograd.Function):
    """One chunk: hidden (M, E), labels (M,), head (V, E) -> (logp (M,),
    entropy (M,)), fp32. Saves the operands and the two (M,) reductions, never
    the (M, V) logits: the backward recomputes them and turns that one buffer
    in place into their cotangent ``g_logp * (onehot - p) - g_ent * p * (z - E_p[z])``,
    rounds it once to the operands' dtype and takes the two gradient products
    (as ``_MatmulFp32Out`` does). The entropy term needs one more (M, V) buffer."""

    @staticmethod
    def forward(ctx, hidden, labels, head, compute_entropy: bool, inv_temperature: float):
        logits = _logits_fp32(hidden, head)
        if inv_temperature != 1.0:
            logits.mul_(inv_temperature)
        lse = torch.logsumexp(logits, dim=-1)
        logp = torch.gather(logits, -1, labels[:, None])[:, 0] - lse
        if compute_entropy:
            entropy = lse - torch.sum(torch.softmax(logits, dim=-1) * logits, dim=-1)
        else:
            entropy = torch.zeros_like(logp)
            ctx.mark_non_differentiable(entropy)
        ctx.save_for_backward(hidden, labels, head, lse, entropy)
        ctx.compute_entropy, ctx.inv_temperature = compute_entropy, inv_temperature
        return logp, entropy

    @staticmethod
    def backward(ctx, g_logp, g_entropy):
        hidden, labels, head, lse, entropy = ctx.saved_tensors
        z = _logits_fp32(hidden, head)
        if ctx.inv_temperature != 1.0:
            z.mul_(ctx.inv_temperature)
        if ctx.compute_entropy:
            p = torch.exp(z - lse[:, None])
            z.sub_((lse - entropy)[:, None]).mul_(g_entropy[:, None]).add_(g_logp[:, None])
            g = p.mul_(z).neg_()
            del z
        else:
            g = z.sub_(lse[:, None]).exp_().mul_(-g_logp[:, None])
        g.scatter_add_(-1, labels[:, None], g_logp[:, None].to(g.dtype))
        if ctx.inv_temperature != 1.0:
            g.mul_(ctx.inv_temperature)
        g = g.to(hidden.dtype)
        g_hidden = g_head = None
        if ctx.needs_input_grad[0]:
            g_hidden = (g @ head).to(hidden.dtype)
        if ctx.needs_input_grad[2]:
            g_head = (g.t() @ hidden).to(head.dtype)
        return g_hidden, None, g_head, None, None


def _chunk_logprob(hidden_chunk, labels_chunk, head, compute_entropy: bool, inv_temperature: float):
    """hidden (B, C, E) x head (V, E) -> (logp (B, C), entropy (B, C))."""
    b, c, e = hidden_chunk.shape
    logp, entropy = _ChunkLogProb.apply(
        hidden_chunk.reshape(b * c, e), labels_chunk.reshape(b * c).long(), head,
        compute_entropy, inv_temperature)
    return logp.reshape(b, c), entropy.reshape(b, c)


def log_probs_from_hidden(
    hidden: torch.Tensor,   # (B, S, E)
    labels: torch.Tensor,   # (B, S) integer
    head: torch.Tensor,     # (V, E)
    *,
    chunk_size: int = 1024,
    compute_entropy: bool = False,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_probs (B, S) fp32, entropy (B, S) fp32). ``temperature``
    divides the logits before the softmax: the PPO forward must evaluate the
    tempered distribution the rollout sampled from."""
    s = hidden.shape[1]
    if s % chunk_size != 0:
        chunk_size = _best_chunk(s, chunk_size)
    inv_t = 1.0 / temperature if temperature > 0 else 1.0
    logps, ents = [], []
    for start in range(0, s, chunk_size):
        h = hidden[:, start : start + chunk_size]
        y = labels[:, start : start + chunk_size]
        logp, ent = _chunk_logprob(h, y, head, compute_entropy, inv_t)
        logps.append(logp)
        ents.append(ent)
    return torch.cat(logps, dim=1), torch.cat(ents, dim=1)


def _best_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (falls back to s)."""
    best = 1
    for c in range(1, min(target, s) + 1):
        if s % c == 0:
            best = c
    return best


def log_probs_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Direct (small-scale) variant: (B, S, V) -> (B, S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return label_logit - lse
