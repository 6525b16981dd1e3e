"""The actor's log-prob forward and GRPO/PPO update step (counterpart of
``spatialthinker_tpu/trainer/train_step.py``).

The JAX package builds jitted pure functions over a parameter tree; here the
model is an ``nn.Module`` updated in place and the optimizer an object that
holds its own state, so ``make_update_fn`` returns ``update(micro_batches,
vision) -> metrics``. Gradient accumulation over micro-batches is a Python
loop (the JAX package's ``lax.scan``): one backward per micro-batch, each
parameter's gradient added into an accumulator of ``grad_accum_dtype`` the
moment it is complete and dropped, so no second full set of gradients is ever
alive.

Sequence layout: [prompt (left-padded to P) | response (right-padded to R)].
hidden[:, P-1+i] predicts response token i, so the log-prob slice is
hidden[:, P-1 : P+R-1].

Single device only: the JAX package's ``sp=`` argument (Ulysses sequence
parallelism) waits for the multi-GPU port, and the host-streamed optimizer is
not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..algos.losses import compute_kl, compute_policy_loss
from ..algos.masked import masked_mean
from ..models.qwen2_5_vl.host import VisionInputs
from ..models.qwen2_5_vl.model import Qwen25VL, forward
from ..ops.logprobs import log_probs_from_hidden
from .optim import AdamW, make_schedule


class TrainBatch(NamedTuple):
    """Device-side micro/mini-batch for the actor. All (B, ...) tensors."""

    input_ids: torch.Tensor       # (B, S) prompt+response, S = P + R
    segment_ids: torch.Tensor     # (B, S) 1 where valid, 0 padding
    position_ids: torch.Tensor    # (3, B, S) mRoPE
    responses: torch.Tensor       # (B, R)
    response_mask: torch.Tensor   # (B, R) float/int
    old_log_probs: torch.Tensor   # (B, R)
    ref_log_probs: torch.Tensor   # (B, R)
    advantages: torch.Tensor      # (B, R)


class PackedTrainBatch(NamedTuple):
    """Packed (padding-free) rows -- see ``data/text_packing.py``."""

    input_ids: torch.Tensor      # (rows, L)
    segment_ids: torch.Tensor    # (rows, L)
    position_ids: torch.Tensor   # (3, rows, L)
    labels: torch.Tensor         # (rows, L)
    loss_mask: torch.Tensor      # (rows, L)
    old_log_probs: torch.Tensor  # (rows, L)
    ref_log_probs: torch.Tensor  # (rows, L)
    advantages: torch.Tensor     # (rows, L)


def _lm_head(model: Qwen25VL) -> torch.Tensor:
    """The (V, E) head: the embedding table of a tied model."""
    text = model.text
    return text.embed_tokens.weight if model.cfg.text.tie_word_embeddings else text.lm_head.weight


def _response_hidden(model, batch: TrainBatch, vision, remat: bool) -> torch.Tensor:
    hidden, _ = forward(
        model, batch.input_ids, batch.position_ids,
        segment_ids=batch.segment_ids, vision=vision, remat=remat,
    )
    r = batch.responses.shape[1]
    p = batch.input_ids.shape[1] - r
    return hidden[:, p - 1 : p - 1 + r]  # (B, R, E)


def compute_log_probs(
    model: Qwen25VL, batch: TrainBatch, vision: Optional[VisionInputs] = None,
    *, remat: bool = False, chunk_size: int = 1024, compute_entropy: bool = False,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, R) log-probs of the sampled responses under ``model`` (+ entropy),
    evaluated at the rollout temperature (behavior-policy distribution)."""
    hidden = _response_hidden(model, batch, vision, remat)
    return log_probs_from_hidden(
        hidden, batch.responses, _lm_head(model), chunk_size=chunk_size,
        compute_entropy=compute_entropy, temperature=temperature,
    )


def compute_packed_log_probs(
    model: Qwen25VL, batch: PackedTrainBatch, vision: Optional[VisionInputs] = None,
    *, remat: bool = False, chunk_size: int = 1024, compute_entropy: bool = False,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, L) label log-probs on packed rows (masked positions -> 0).
    ``vision`` must be packed in the rows' image-token order (row-major)."""
    hidden, _ = forward(
        model, batch.input_ids, batch.position_ids,
        segment_ids=batch.segment_ids, vision=vision, remat=remat,
    )
    logp, entropy = log_probs_from_hidden(
        hidden, batch.labels, _lm_head(model), chunk_size=chunk_size,
        compute_entropy=compute_entropy, temperature=temperature,
    )
    return logp * batch.loss_mask, entropy * batch.loss_mask


def _policy_loss(logp, entropy, mask, old_log_probs, ref_log_probs, advantages, *,
                 clip_ratio_low, clip_ratio_high, clip_ratio_dual, use_kl_loss, kl_loss_coef,
                 kl_penalty, entropy_coeff):
    pg_loss, clip_hi, clip_lo, ppo_kl = compute_policy_loss(
        old_log_probs, logp, advantages, mask, clip_ratio_low, clip_ratio_high, clip_ratio_dual,
    )
    loss = pg_loss
    metrics = {
        "actor/pg_loss": pg_loss,
        "actor/pg_clipfrac_higher": clip_hi,
        "actor/pg_clipfrac_lower": clip_lo,
        "actor/ppo_kl": ppo_kl,
    }
    if use_kl_loss:
        kl_loss = masked_mean(compute_kl(logp, ref_log_probs, kl_penalty), mask)
        loss = loss + kl_loss * kl_loss_coef
        metrics["actor/kl_loss"] = kl_loss
    if entropy_coeff != 0.0:
        entropy_loss = masked_mean(entropy, mask)
        loss = loss - entropy_coeff * entropy_loss
        metrics["actor/entropy_loss"] = entropy_loss
    return loss, metrics


def actor_loss_fn(
    model: Qwen25VL, batch: TrainBatch, vision: Optional[VisionInputs],
    *, clip_ratio_low: float, clip_ratio_high: float, clip_ratio_dual: float,
    use_kl_loss: bool, kl_loss_coef: float, kl_penalty: str, entropy_coeff: float = 0.0,
    remat: bool = True, chunk_size: int = 1024, temperature: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logp, entropy = compute_log_probs(
        model, batch, vision, remat=remat, chunk_size=chunk_size,
        compute_entropy=entropy_coeff != 0.0, temperature=temperature,
    )
    return _policy_loss(
        logp, entropy, batch.response_mask.float(), batch.old_log_probs, batch.ref_log_probs,
        batch.advantages, clip_ratio_low=clip_ratio_low, clip_ratio_high=clip_ratio_high,
        clip_ratio_dual=clip_ratio_dual, use_kl_loss=use_kl_loss, kl_loss_coef=kl_loss_coef,
        kl_penalty=kl_penalty, entropy_coeff=entropy_coeff,
    )


def packed_actor_loss_fn(
    model: Qwen25VL, batch: PackedTrainBatch, vision: Optional[VisionInputs] = None,
    *, clip_ratio_low: float, clip_ratio_high: float, clip_ratio_dual: float,
    use_kl_loss: bool, kl_loss_coef: float, kl_penalty: str, entropy_coeff: float = 0.0,
    remat: bool = True, chunk_size: int = 1024, temperature: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Identical math to ``actor_loss_fn`` on packed rows: token-weighted
    masked means make the two layouts numerically equivalent."""
    logp, entropy = compute_packed_log_probs(
        model, batch, vision, remat=remat, chunk_size=chunk_size,
        compute_entropy=entropy_coeff != 0.0, temperature=temperature,
    )
    return _policy_loss(
        logp, entropy, batch.loss_mask, batch.old_log_probs, batch.ref_log_probs,
        batch.advantages, clip_ratio_low=clip_ratio_low, clip_ratio_high=clip_ratio_high,
        clip_ratio_dual=clip_ratio_dual, use_kl_loss=use_kl_loss, kl_loss_coef=kl_loss_coef,
        kl_penalty=kl_penalty, entropy_coeff=entropy_coeff,
    )


def trainable_parameters(model: Qwen25VL, freeze_vision_tower: bool = False):
    """(name, parameter) pairs the update moves: all, or all but the vision tower."""
    return [(n, p) for n, p in model.named_parameters()
            if not (freeze_vision_tower and n.startswith("vision."))]


def _global_norm_f32(grads) -> torch.Tensor:
    """Global L2 norm with fp32 accumulation and no fp32 copy of a leaf."""
    sq = sum(torch.linalg.vector_norm(g, dtype=torch.float32).square() for g in grads.values())
    return torch.sqrt(sq)


def _micro(batch, vision, i: int):
    mb = type(batch)(*(x[i] for x in batch))
    vis = None if vision is None else VisionInputs(*(x[i] for x in vision))
    return mb, vis


def _make_grad_fn(model: Qwen25VL, loss_fn: Callable, *, max_grad_norm: float = 1.0,
                  grad_accum_dtype=torch.float32, freeze_vision_tower: bool = False,
                  **loss_kwargs):
    def grad_step(micro_batches, vision=None):
        """micro_batches: a batch tuple with a leading (n_micro,) dim on every
        tensor; ``vision``, when present, a ``VisionInputs`` stacked the same
        way. Returns (grads by parameter name, metrics, finite, factor)."""
        named = trainable_parameters(model, freeze_vision_tower)
        frozen = [p for n, p in model.named_parameters()
                  if freeze_vision_tower and n.startswith("vision.") and p.requires_grad]
        acc = {n: torch.zeros_like(p, dtype=grad_accum_dtype) for n, p in named}

        def accumulate_into(a):
            def hook(p):
                a.add_(p.grad.to(a.dtype))
                p.grad = None
            return hook

        handles = [p.register_post_accumulate_grad_hook(accumulate_into(acc[n])) for n, p in named]
        for p in frozen:
            p.requires_grad_(False)
        n_micro = micro_batches.input_ids.shape[0]
        sums: Dict[str, torch.Tensor] = {}
        try:
            for i in range(n_micro):
                mb, vis = _micro(micro_batches, vision, i)
                loss, metrics = loss_fn(model, mb, vis, **loss_kwargs)
                loss.backward()
                metrics["actor/loss"] = loss
                for key, value in metrics.items():
                    sums[key] = sums.get(key, 0.0) + value.detach().float()
        finally:
            for h in handles:
                h.remove()
            for p in frozen:
                p.requires_grad_(True)
        metrics = {k: v / n_micro for k, v in sums.items()}

        grad_norm = _global_norm_f32(acc) / n_micro
        metrics["actor/grad_norm"] = grad_norm
        norm = float(grad_norm)
        finite = math.isfinite(norm)
        factor = min(1.0, max_grad_norm / (norm + 1e-6)) / n_micro if finite else 0.0
        return acc, metrics, finite, factor

    return grad_step


def make_grad_fn(model: Qwen25VL, *, max_grad_norm: float = 1.0, grad_accum_dtype=torch.float32,
                 freeze_vision_tower: bool = False, **loss_knobs):
    """The accumulation half of the update step: loop over micro-batches, sum
    gradients, fold the clip/accumulation rescale and the NaN-skip decision
    into two scalars: ``grad_norm = global_norm / n_micro``,
    ``factor = min(1, max_grad_norm / (grad_norm + 1e-6)) / n_micro``, or 0
    when the norm is not finite. A frozen vision tower takes no gradient and
    does not enter the norm. ``loss_knobs`` are ``actor_loss_fn``'s keyword
    arguments (clip ratios, KL loss, entropy, ``remat``, ``chunk_size``,
    ``temperature``)."""
    return _make_grad_fn(model, actor_loss_fn, max_grad_norm=max_grad_norm,
                         grad_accum_dtype=grad_accum_dtype,
                         freeze_vision_tower=freeze_vision_tower, **loss_knobs)


def make_packed_grad_fn(model: Qwen25VL, *, max_grad_norm: float = 1.0,
                        grad_accum_dtype=torch.float32, freeze_vision_tower: bool = False,
                        **loss_knobs):
    """Packed-row variant of ``make_grad_fn`` (``packed_actor_loss_fn``)."""
    return _make_grad_fn(model, packed_actor_loss_fn, max_grad_norm=max_grad_norm,
                         grad_accum_dtype=grad_accum_dtype,
                         freeze_vision_tower=freeze_vision_tower, **loss_knobs)


def apply_optimizer_step(optimizer: AdamW, grads, model: Qwen25VL, *, finite: bool,
                         grad_scale: Optional[float] = None,
                         freeze_vision_tower: bool = False) -> None:
    """Optimizer apply with the NaN-grad skip and the optional vision freeze,
    in place. A non-finite norm leaves parameters, moments and count
    untouched. A frozen vision tower never enters the apply, so weight decay
    cannot move it: it stays exactly as it was."""
    optimizer.step(trainable_parameters(model, freeze_vision_tower), grads,
                   finite=finite, grad_scale=grad_scale)


def make_update_fn(model: Qwen25VL, optimizer: AdamW, *, freeze_vision_tower: bool = False,
                   **knobs):
    """The mini-batch update: accumulate gradients over the micro-batches, one
    optimizer step, NaN-grad skip. ``knobs`` are ``make_grad_fn``'s. Returns
    ``update(micro_batches, vision=None) -> metrics`` (tensors); model and
    optimizer state change in place."""
    grad_step = make_grad_fn(model, freeze_vision_tower=freeze_vision_tower, **knobs)

    def update(micro_batches: TrainBatch, vision: Optional[VisionInputs] = None):
        grads, metrics, finite, factor = grad_step(micro_batches, vision)
        apply_optimizer_step(optimizer, grads, model, finite=finite, grad_scale=factor,
                             freeze_vision_tower=freeze_vision_tower)
        return metrics

    return update


def make_packed_update_fn(model: Qwen25VL, optimizer: AdamW, *,
                          freeze_vision_tower: bool = False, **knobs):
    """Packed-row variant of ``make_update_fn``: micro dim on every tensor.
    ``freeze_vision_tower`` holds here as on the unpacked path (the JAX
    package's packed update ignores it)."""
    grad_step = make_packed_grad_fn(model, freeze_vision_tower=freeze_vision_tower, **knobs)

    def update(micro_batches: PackedTrainBatch, vision: Optional[VisionInputs] = None):
        grads, metrics, finite, factor = grad_step(micro_batches, vision)
        apply_optimizer_step(optimizer, grads, model, finite=finite, grad_scale=factor,
                             freeze_vision_tower=freeze_vision_tower)
        return metrics

    return update


def make_optimizer(
    lr: float, *, weight_decay: float = 1e-2, betas: Tuple[float, float] = (0.9, 0.999),
    warmup_steps: int = 0, strategy: str = "adamw", use_kahan_summation: bool = True,
) -> AdamW:
    """AdamW with a constant-after-linear-warmup learning rate. Strategy
    ``adamw`` equals ``optax.adamw``; ``adamw_bf16`` is AnyPrecision AdamW
    (bf16 moments + Kahan-compensated parameter updates, see ``optim.py``);
    ``use_kahan_summation=False`` drops its compensation buffer."""
    return AdamW(
        make_schedule(lr, warmup_steps), b1=betas[0], b2=betas[1], weight_decay=weight_decay,
        strategy=strategy, use_kahan_summation=use_kahan_summation,
    )
