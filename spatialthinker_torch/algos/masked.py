"""Masked statistics helpers (counterpart of
``spatialthinker_tpu/algos/masked.py``)."""

from __future__ import annotations

import torch


def masked_mean(values: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    mask = mask.to(values.dtype)
    if dim is None:
        return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1e-8)
    return torch.sum(values * mask, dim=dim) / torch.clamp(torch.sum(mask, dim=dim), min=1e-8)


def masked_var(values: torch.Tensor, mask: torch.Tensor, unbiased: bool = True) -> torch.Tensor:
    mask = mask.to(values.dtype)
    mean = masked_mean(values, mask)
    centered = (values - mean) * mask
    n = torch.sum(mask)
    var = torch.sum(centered * centered) / torch.clamp(n, min=1e-8)
    if unbiased:
        # Bessel correction
        var = var * n / torch.clamp(n - 1.0, min=1.0)
    return var


def masked_whiten(values: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mean = masked_mean(values, mask)
    var = masked_var(values, mask)
    return (values - mean) / torch.sqrt(var + eps)
