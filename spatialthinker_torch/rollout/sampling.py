"""Token sampling: temperature / top-k / top-p with an explicit
``torch.Generator`` (counterpart of ``spatialthinker_tpu/rollout/sampling.py``).

Sampling is Gumbel-max in its exponential form (argmax of probs / E,
E ~ Exp(1)), the same distribution as ``jax.random.categorical``; the two
frameworks' generators give different numbers, so sampled runs are compared
by log-probs, not tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    n: int = 1

    def override(self, **kwargs) -> "SamplingParams":
        """A copy with the given fields replaced; ``None`` keeps a field."""
        return replace(self, **{k: v for k, v in kwargs.items() if v is not None})

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k largest logits. k <= 0 disables."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens with cumulative
    probability >= p (always keeps the argmax)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < p  # exclusive prefix mass < p
    kept = torch.where(keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf")))
    threshold = kept.amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, torch.full_like(logits, NEG_INF), logits)


def sample_tokens(
    logits: torch.Tensor,  # (B, V) fp32
    generator: torch.Generator,
    params: SamplingParams,
) -> torch.Tensor:
    """Returns sampled token ids (B,) int64."""
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(params.temperature, 1e-6)
    logits = apply_top_k(logits, params.top_k)
    logits = apply_top_p(logits, params.top_p)
    probs = torch.softmax(logits, dim=-1)
    noise = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / noise, dim=-1)


def sampled_token_logp(
    logits: torch.Tensor,  # (B, V) fp32 raw model logits
    tokens: torch.Tensor,  # (B,) sampled ids
    params: SamplingParams,
) -> torch.Tensor:
    """Log-prob of the sampled tokens under the TEMPERED distribution
    (logits / T), the behaviour policy of the PPO ratio; top-k/top-p
    renormalisation is not folded in. Greedy (T=0) uses T=1 so the reported
    log-prob stays finite."""
    t = params.temperature if params.temperature > 0 else 1.0
    scaled = logits / t
    lse = torch.logsumexp(scaled, dim=-1)
    return torch.gather(scaled, -1, tokens[:, None])[:, 0] - lse


def get_response_mask(responses: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """Mask = 1 up to and including the FIRST eos token, 0 after."""
    is_eos = (responses == eos_token_id).to(torch.int32)
    seen_eos_before = torch.cumsum(is_eos, dim=-1) - is_eos
    return (seen_eos_before == 0).to(torch.int32)
