"""Policy / value losses and KL penalties (counterpart of
``spatialthinker_tpu/algos/losses.py``): dual-clip PPO with an asymmetric
clip range, clipped value loss, six KL penalty variants."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .masked import masked_mean


def compute_policy_loss(
    old_log_probs: torch.Tensor,
    log_probs: torch.Tensor,
    advantages: torch.Tensor,
    response_mask: torch.Tensor,
    clip_ratio_low: float,
    clip_ratio_high: float,
    clip_ratio_dual: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dual-clip PPO loss with asymmetric clipping.

    Returns (pg_loss, pg_clipfrac_higher, pg_clipfrac_lower, ppo_kl), all
    masked scalar means.
    """
    negative_approx_kl = log_probs - old_log_probs
    ratio = torch.exp(negative_approx_kl)
    clipped_ratio = torch.exp(
        torch.clamp(
            negative_approx_kl,
            math.log(1.0 - clip_ratio_low),
            math.log(1.0 + clip_ratio_high),
        )
    )

    pg_loss = -advantages * ratio
    pg_loss2 = -advantages * clipped_ratio
    pg_loss3 = -advantages * clip_ratio_dual

    clipped_pg_loss_higher = torch.maximum(pg_loss, pg_loss2)
    pg_clipfrac_higher = (pg_loss < pg_loss2).float()
    clipped_pg_loss_lower = torch.minimum(clipped_pg_loss_higher, pg_loss3)
    final_pg_loss = torch.where(advantages < 0, clipped_pg_loss_lower, clipped_pg_loss_higher)
    pg_clipfrac_lower = (clipped_pg_loss_higher > pg_loss3).float() * (advantages < 0).float()

    return (
        masked_mean(final_pg_loss, response_mask),
        masked_mean(pg_clipfrac_higher, response_mask),
        masked_mean(pg_clipfrac_lower, response_mask),
        masked_mean(-negative_approx_kl, response_mask),
    )


def compute_value_loss(
    vpreds: torch.Tensor,
    returns: torch.Tensor,
    values: torch.Tensor,
    action_mask: torch.Tensor,
    cliprange_value: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clipped value loss."""
    vpredclipped = torch.maximum(torch.minimum(vpreds, values + cliprange_value),
                                 values - cliprange_value)
    vf_loss1 = torch.square(vpreds - returns)
    vf_loss2 = torch.square(vpredclipped - returns)
    vf_loss = 0.5 * masked_mean(torch.maximum(vf_loss1, vf_loss2), action_mask)
    vf_clipfrac = masked_mean((vf_loss1 < vf_loss2).float(), action_mask)
    return vf_loss, vf_clipfrac


def compute_kl(log_probs: torch.Tensor, ref_log_probs: torch.Tensor, kl_penalty: str) -> torch.Tensor:
    """Per-token KL penalty, six variants."""
    log_probs = log_probs.float()
    ref_log_probs = ref_log_probs.float()
    if kl_penalty == "kl":
        return log_probs - ref_log_probs
    if kl_penalty == "abs":
        return torch.abs(log_probs - ref_log_probs)
    if kl_penalty == "mse":
        return 0.5 * torch.square(log_probs - ref_log_probs)
    if kl_penalty == "low_var_kl":
        # J. Schulman, approximating KL: exp(d) - d - 1, d = ref - cur.
        kl = ref_log_probs - log_probs
        kld = torch.exp(kl) - kl - 1.0
        return torch.clamp(kld, -10.0, 10.0)
    if kl_penalty == "full":
        # sum over the last dim of exp(cur) * (cur - ref)
        return torch.sum(torch.exp(log_probs) * (log_probs - ref_log_probs), dim=-1)
    if kl_penalty == "chi2":
        r = torch.exp(ref_log_probs - log_probs)
        return torch.clamp(torch.square(r - 1.0), 0.0, 20.0)
    raise NotImplementedError(f"Unknown KL penalty: {kl_penalty}.")


def compute_rewards(
    token_level_scores: torch.Tensor,
    log_probs: torch.Tensor,
    ref_log_probs: torch.Tensor,
    kl_ratio: float,
) -> torch.Tensor:
    """Apply the in-reward KL penalty."""
    kl = log_probs - ref_log_probs
    return token_level_scores - kl * kl_ratio


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-token entropy from logits in fp32: logsumexp(z) - sum(p*z)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return lse - torch.sum(probs * logits, dim=-1)
