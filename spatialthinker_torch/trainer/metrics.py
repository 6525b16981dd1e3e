"""Training metrics (the port's own copy of
``spatialthinker_tpu/trainer/metrics.py``; parity: verl/trainer/metrics.py:23-120,
same metric names so dashboards transfer). Host code on numpy arrays. The
section timer (the JAX package's ``Timer``) is the port's span recorder,
``utils/spans.py``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def reduce_metrics(metrics: Dict[str, List[float]]) -> Dict[str, float]:
    return {k: float(np.mean(v)) for k, v in metrics.items()}


def compute_data_metrics(
    *,
    token_level_scores: np.ndarray,  # (B, R)
    token_level_rewards: np.ndarray,  # (B, R) after KL penalty
    advantages: np.ndarray,
    returns: np.ndarray,
    response_mask: np.ndarray,
    prompt_mask: np.ndarray,
    values: np.ndarray = None,
    max_response_length: int = 0,
    max_prompt_length: int = 0,
    old_log_probs: np.ndarray = None,      # (B, R) the training forward's
    rollout_log_probs: np.ndarray = None,  # (B, R) engine (possibly quantized)
) -> Dict[str, float]:
    score = token_level_scores.sum(-1)
    reward = token_level_rewards.sum(-1)
    mask = response_mask.astype(bool)

    def masked_stats(prefix, x):
        sel = x[mask] if x.shape == mask.shape else x
        return {
            f"{prefix}/mean": float(np.mean(sel)),
            f"{prefix}/max": float(np.max(sel)),
            f"{prefix}/min": float(np.min(sel)),
        }

    response_length = response_mask.sum(-1).astype(np.float64)
    prompt_length = prompt_mask.sum(-1).astype(np.float64)
    metrics = {
        "critic/score/mean": float(score.mean()),
        "critic/score/max": float(score.max()),
        "critic/score/min": float(score.min()),
        "critic/rewards/mean": float(reward.mean()),
        "critic/rewards/max": float(reward.max()),
        "critic/rewards/min": float(reward.min()),
        **masked_stats("critic/advantages", advantages),
        **masked_stats("critic/returns", returns),
        "response_length/mean": float(response_length.mean()),
        "response_length/max": float(response_length.max()),
        "response_length/min": float(response_length.min()),
        "response_length/clip_ratio": float(
            (response_length >= max_response_length).mean() if max_response_length else 0.0
        ),
        "prompt_length/mean": float(prompt_length.mean()),
        "prompt_length/max": float(prompt_length.max()),
        "prompt_length/min": float(prompt_length.min()),
        "prompt_length/clip_ratio": float(
            (prompt_length >= max_prompt_length).mean() if max_prompt_length else 0.0
        ),
    }
    if values is not None:
        metrics.update(masked_stats("critic/values", values))
    if old_log_probs is not None and rollout_log_probs is not None and mask.any():
        # behavior-policy drift: |engine log-prob - training-forward
        # log-prob| on response tokens. This is the number that tells you
        # whether a rollout quantization level (int8 weights / int8 or int4 KV)
        # is safe — the importance ratio absorbs small drift; large drift means
        # the behavior policy has wandered off the trained one.
        d = np.abs(old_log_probs - rollout_log_probs)[mask]
        metrics["rollout/probs_diff_mean"] = float(d.mean())
        metrics["rollout/probs_diff_max"] = float(d.max())
    return metrics


def compute_timing_metrics(timing: Dict[str, float], num_tokens: int) -> Dict[str, float]:
    metrics = {f"timing_s/{k}": v for k, v in timing.items()}
    if num_tokens > 0:
        metrics.update(
            {f"timing_per_token_ms/{k}": v * 1e3 / num_tokens for k, v in timing.items()}
        )
    return metrics


def compute_throughput_metrics(
    total_tokens: int, step_time: float, n_chips: int
) -> Dict[str, float]:
    return {
        "perf/total_num_tokens": float(total_tokens),
        "perf/time_per_step": step_time,
        "perf/throughput": total_tokens / max(step_time * n_chips, 1e-9),
    }
