"""Advantage estimators: GRPO / GAE / RLOO / REINFORCE++ / ReMax (counterpart
of ``spatialthinker_tpu/algos/advantages.py``).

All functions take and return (bs, response_length) float32 tensors.
``group_ids`` is an integer tensor mapping each row to its prompt group
(dense ints factorized from the uid strings on the host, which survives any
batch reordering exactly like uid keying). Group statistics are ``index_add_``
reductions (the JAX package's ``segment_sum``); the recurrences are reverse
Python loops over the response length (its ``lax.scan``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .masked import masked_whiten


def _segment_sum(values: torch.Tensor, group_ids: torch.Tensor, num_groups: int) -> torch.Tensor:
    out = torch.zeros(num_groups, dtype=values.dtype, device=values.device)
    return out.index_add_(0, group_ids.long(), values)


def _group_mean_std(
    scores: torch.Tensor, group_ids: torch.Tensor, num_groups: int, eps: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group mean and Bessel-corrected std (ddof=1), broadcast back to
    each row."""
    gid = group_ids.long()
    counts = _segment_sum(torch.ones_like(scores), gid, num_groups)
    sums = _segment_sum(scores, gid, num_groups)
    means = sums / torch.clamp(counts, min=1.0)
    sq = _segment_sum(scores * scores, gid, num_groups)
    # unbiased variance: (E[x^2]*n - n*mean^2) / (n-1)
    var = (sq - counts * means * means) / torch.clamp(counts - 1.0, min=1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return means[gid], std[gid]


def compute_grpo_outcome_advantage(
    token_level_rewards: torch.Tensor,
    response_mask: torch.Tensor,
    group_ids: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRPO: whiten summed outcome rewards within each prompt group and
    broadcast over the response mask."""
    scores = torch.sum(token_level_rewards, dim=-1)
    mean, std = _group_mean_std(scores, group_ids, num_groups, eps)
    scores = (scores - mean) / (std + eps)
    returns = scores[:, None] * response_mask
    return returns, returns


def compute_rloo_outcome_advantage(
    token_level_rewards: torch.Tensor,
    response_mask: torch.Tensor,
    group_ids: torch.Tensor,
    num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RLOO leave-one-out baseline."""
    gid = group_ids.long()
    scores = torch.sum(token_level_rewards, dim=-1)
    counts = _segment_sum(torch.ones_like(scores), gid, num_groups)[gid]
    sums = _segment_sum(scores, gid, num_groups)[gid]
    baseline = (sums - scores) / torch.clamp(counts - 1.0, min=1.0)
    scores = scores - baseline
    returns = scores[:, None] * response_mask
    return returns, returns


def compute_gae_advantage_return(
    token_level_rewards: torch.Tensor,
    values: torch.Tensor,
    response_mask: torch.Tensor,
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE, accumulated from the last response position back."""
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=-1)
    deltas = token_level_rewards + gamma * next_values - values
    lastgaelam = torch.zeros_like(deltas[:, 0])
    rev = []
    for t in range(deltas.shape[1] - 1, -1, -1):
        lastgaelam = deltas[:, t] + gamma * lam * lastgaelam
        rev.append(lastgaelam)
    advantages = torch.stack(rev[::-1], dim=1)
    returns = advantages + values
    advantages = masked_whiten(advantages, response_mask)
    return advantages, returns


def compute_reinforce_plus_plus_outcome_advantage(
    token_level_rewards: torch.Tensor,
    response_mask: torch.Tensor,
    gamma: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """REINFORCE++ discounted returns with post-EOS reset."""
    running = torch.zeros_like(token_level_rewards[:, 0])
    rev = []
    for t in range(token_level_rewards.shape[1] - 1, -1, -1):
        running = token_level_rewards[:, t] + gamma * running
        rev.append(running)
        running = running * response_mask[:, t]
    returns = torch.stack(rev[::-1], dim=1)
    advantages = masked_whiten(returns, response_mask)
    return advantages, returns


def compute_remax_outcome_advantage(
    token_level_rewards: torch.Tensor,
    reward_baselines: torch.Tensor,
    response_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ReMax greedy-baseline advantage."""
    scores = torch.sum(token_level_rewards, dim=-1) - reward_baselines
    returns = scores[:, None] * response_mask
    return returns, returns
