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

``optimizer`` is either ``optim.AdamW`` (state on the card) or
``streamed_opt.StreamedAdamW`` (state on the host, streamed through the card):
both update by ``step(named_params, grads, finite=, grad_scale=)``, so the
JAX package's separate grad-then-apply program under ``optim.stream`` is the
same ``make_update_fn`` here. ``remat`` is False, "full" or "dots" (True:
"dots"), the JAX package's policies (``models.qwen2_5_vl.text.checkpointed``).

Several GPUs (one process each, the model sharded by ``parallel/sharding.py``):
``groups`` (``DistGroups``) makes the update equal the single-process update
on the union of the ranks' rows. Each micro-batch's loss and metrics on a
rank are its own tokens' sum over the GLOBAL token count of that micro-batch
(the JAX package's token mean over the global micro-batch), FSDP sums the
ranks' gradients, the norm sums the squares of every rank's shards, so the
clip and the NaN skip are one decision for all ranks, and the metrics are
summed over the ranks. Every rank must run the same number of micro-batches
(the trainer negotiates it). ``sp`` (``ops.ulysses.UlyssesSpec``) is
sequence parallelism over the mesh's ``model`` axis: each rank of an sp group
holds a chunk of the same rows' sequence; the losses work on position-aligned
chunks (the per-sample layout's responses placed at their prediction slots),
the log-prob functions gather the chunks of their result.

Tensor parallelism (``groups.tp``, the mesh's ``model`` axis without sp):
the ranks of a TP group hold the same rows and their shards of every
weight; the log-probs are vocab-parallel (``ops.logprobs``), the metrics
are summed over the batch group only (a token lives on every rank of its TP
group), and the gradient norm sums the squares of the split leaves over the
TP group and counts the replicated ones once (their gradients are equal on
every rank of the group).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

import torch.distributed as dist

from ..algos.losses import compute_kl, compute_policy_loss
from ..algos.masked import masked_mean
from ..models.qwen2_5_vl.host import VisionInputs
from ..models.qwen2_5_vl.model import Qwen25VL, forward
from ..ops.logprobs import log_probs_from_hidden
from ..ops.ulysses import all_gather_seq, seq_chunk
from ..parallel.sharding import is_sharded, local
from ..parallel.tensor import split_of
from ..utils.spans import span
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


class DistGroups(NamedTuple):
    """Where a multi-GPU update reduces (``parallel/mesh.py``): ``batch`` the
    ranks holding other rows (a micro-batch's global token count), ``norm``
    the ranks whose shards make one copy of the parameters (the gradient
    norm; under TP, one copy of this rank's TP shards); the metrics sum over
    every rank (each token lives on one), or over ``batch`` under TP.
    ``tp``: the TP group, None without tensor parallelism."""

    batch: dist.ProcessGroup
    norm: dist.ProcessGroup
    tp: Optional[dist.ProcessGroup] = None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in fp64 (on the card for NCCL, on the host
    for gloo)."""
    dev = t.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    x = t.detach().to(dev, torch.float64)
    dist.all_reduce(x, group=group)
    return x


def _aligned(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, R) response values -> (B, S) at their prediction slots P-1 ..
    P+R-2 (zeros elsewhere): the per-sample layout as position-aligned rows,
    which a sequence chunk can slice."""
    b, r = x.shape
    out = x.new_zeros((b, s))
    out[:, s - r - 1 : s - 1] = x
    return out


def _lm_head(model: Qwen25VL) -> torch.Tensor:
    """The (V, E) head: the embedding table of a tied model."""
    text = model.text
    return text.embed_tokens.weight if model.cfg.text.tie_word_embeddings else text.lm_head.weight


def _vocab_tp(model: Qwen25VL) -> dict:
    """``log_probs_from_hidden``'s vocab-parallel arguments of a model whose
    head is split over its TP group (none otherwise)."""
    text = model.text
    return dict(tp=text.tp, vocab_start=text.vocab_start) if text.vocab_split else {}


def _response_hidden(model, batch: TrainBatch, vision, remat: Union[bool, str]) -> torch.Tensor:
    hidden, _ = forward(
        model, batch.input_ids, batch.position_ids,
        segment_ids=batch.segment_ids, vision=vision, remat=remat,
    )
    r = batch.responses.shape[1]
    p = batch.input_ids.shape[1] - r
    return hidden[:, p - 1 : p - 1 + r]  # (B, R, E)


def _hidden_chunk(model, batch, vision, remat, sp) -> torch.Tensor:
    """This sp rank's chunk of the hidden states (B, S / sp, E)."""
    hidden, _ = forward(model, batch.input_ids, batch.position_ids, segment_ids=batch.segment_ids,
                        vision=vision, remat=remat, sp=sp)
    return hidden


def _response_log_probs_chunk(model, batch: TrainBatch, vision, *, remat, chunk_size,
                              compute_entropy, temperature, sp):
    """Log-probs (+ entropy) of this sp rank's chunk of the position-aligned
    responses, (B, S / sp) each, 0 off the responses."""
    s = batch.input_ids.shape[1]
    labels = seq_chunk(_aligned(batch.responses, s), sp)
    mask = seq_chunk(_aligned(batch.response_mask.float(), s), sp)
    logp, entropy = log_probs_from_hidden(
        _hidden_chunk(model, batch, vision, remat, sp), labels, _lm_head(model), **_vocab_tp(model),
        chunk_size=chunk_size, compute_entropy=compute_entropy, temperature=temperature,
    )
    return logp * mask, entropy * mask


def compute_log_probs(
    model: Qwen25VL, batch: TrainBatch, vision: Optional[VisionInputs] = None,
    *, remat: Union[bool, str] = False, chunk_size: int = 1024, compute_entropy: bool = False,
    temperature: float = 1.0, sp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, R) log-probs of the sampled responses under ``model`` (+ entropy),
    evaluated at the rollout temperature (behavior-policy distribution).
    Under ``sp`` every rank of the sp group returns the whole (B, R),
    gathered from the chunks without a gradient (the loss works on chunks)."""
    if sp is not None:
        s, r = batch.input_ids.shape[1], batch.responses.shape[1]
        chunks = _response_log_probs_chunk(
            model, batch, vision, remat=remat, chunk_size=chunk_size,
            compute_entropy=compute_entropy, temperature=temperature, sp=sp)
        return tuple(all_gather_seq(t, sp.group)[:, s - r - 1 : s - 1] for t in chunks)
    hidden = _response_hidden(model, batch, vision, remat)
    return log_probs_from_hidden(
        hidden, batch.responses, _lm_head(model), **_vocab_tp(model), chunk_size=chunk_size,
        compute_entropy=compute_entropy, temperature=temperature,
    )


def _packed_log_probs_chunk(model, batch: PackedTrainBatch, vision, *, remat, chunk_size,
                            compute_entropy, temperature, sp):
    labels, mask = batch.labels, batch.loss_mask
    if sp is not None:
        labels, mask = seq_chunk(labels, sp), seq_chunk(mask, sp)
    hidden, _ = forward(
        model, batch.input_ids, batch.position_ids,
        segment_ids=batch.segment_ids, vision=vision, remat=remat, sp=sp,
    )
    logp, entropy = log_probs_from_hidden(
        hidden, labels, _lm_head(model), **_vocab_tp(model), chunk_size=chunk_size,
        compute_entropy=compute_entropy, temperature=temperature,
    )
    return logp * mask, entropy * mask


def compute_packed_log_probs(
    model: Qwen25VL, batch: PackedTrainBatch, vision: Optional[VisionInputs] = None,
    *, remat: Union[bool, str] = False, chunk_size: int = 1024, compute_entropy: bool = False,
    temperature: float = 1.0, sp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, L) label log-probs on packed rows (masked positions -> 0).
    ``vision`` must be packed in the rows' image-token order (row-major).
    Under ``sp`` the sp group's chunks are gathered, as in
    ``compute_log_probs``."""
    out = _packed_log_probs_chunk(model, batch, vision, remat=remat, chunk_size=chunk_size,
                                  compute_entropy=compute_entropy, temperature=temperature, sp=sp)
    if sp is not None:
        out = tuple(all_gather_seq(t, sp.group) for t in out)
    return out


def token_share(values: Dict[str, torch.Tensor], mask: torch.Tensor, n_tokens) -> Dict[str, torch.Tensor]:
    """Masked means over this rank's tokens -> this rank's share of the
    means over ``n_tokens`` tokens (None: unchanged)."""
    if n_tokens is None:
        return values
    share = mask.sum() / n_tokens
    return {k: v * share for k, v in values.items()}


def _policy_loss(logp, entropy, mask, old_log_probs, ref_log_probs, advantages, *,
                 clip_ratio_low, clip_ratio_high, clip_ratio_dual, use_kl_loss, kl_loss_coef,
                 kl_penalty, entropy_coeff, n_tokens=None):
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
    out = token_share({"loss": loss, **metrics}, mask, n_tokens)
    return out.pop("loss"), out


def actor_loss_fn(
    model: Qwen25VL, batch: TrainBatch, vision: Optional[VisionInputs],
    *, clip_ratio_low: float, clip_ratio_high: float, clip_ratio_dual: float,
    use_kl_loss: bool, kl_loss_coef: float, kl_penalty: str, entropy_coeff: float = 0.0,
    remat: Union[bool, str] = True, chunk_size: int = 1024, temperature: float = 1.0,
    sp=None, n_tokens=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The policy loss of a micro-batch; ``n_tokens`` (the micro-batch's
    global token count, several GPUs) turns its means into this rank's share."""
    knobs = dict(remat=remat, chunk_size=chunk_size, compute_entropy=entropy_coeff != 0.0,
                 temperature=temperature)
    if sp is None:
        logp, entropy = compute_log_probs(model, batch, vision, **knobs)
        per_token = (batch.response_mask.float(), batch.old_log_probs, batch.ref_log_probs,
                     batch.advantages)
    else:
        logp, entropy = _response_log_probs_chunk(model, batch, vision, sp=sp, **knobs)
        s = batch.input_ids.shape[1]
        per_token = tuple(seq_chunk(_aligned(x.float(), s), sp) for x in (
            batch.response_mask, batch.old_log_probs, batch.ref_log_probs, batch.advantages))
    return _policy_loss(
        logp, entropy, *per_token, clip_ratio_low=clip_ratio_low, clip_ratio_high=clip_ratio_high,
        clip_ratio_dual=clip_ratio_dual, use_kl_loss=use_kl_loss, kl_loss_coef=kl_loss_coef,
        kl_penalty=kl_penalty, entropy_coeff=entropy_coeff, n_tokens=n_tokens,
    )


def packed_actor_loss_fn(
    model: Qwen25VL, batch: PackedTrainBatch, vision: Optional[VisionInputs] = None,
    *, clip_ratio_low: float, clip_ratio_high: float, clip_ratio_dual: float,
    use_kl_loss: bool, kl_loss_coef: float, kl_penalty: str, entropy_coeff: float = 0.0,
    remat: Union[bool, str] = True, chunk_size: int = 1024, temperature: float = 1.0,
    sp=None, n_tokens=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Identical math to ``actor_loss_fn`` on packed rows: token-weighted
    masked means make the two layouts numerically equivalent."""
    logp, entropy = _packed_log_probs_chunk(
        model, batch, vision, remat=remat, chunk_size=chunk_size,
        compute_entropy=entropy_coeff != 0.0, temperature=temperature, sp=sp,
    )
    per_token = (batch.loss_mask, batch.old_log_probs, batch.ref_log_probs, batch.advantages)
    if sp is not None:
        per_token = tuple(seq_chunk(x, sp) for x in per_token)
    return _policy_loss(
        logp, entropy, *per_token, clip_ratio_low=clip_ratio_low, clip_ratio_high=clip_ratio_high,
        clip_ratio_dual=clip_ratio_dual, use_kl_loss=use_kl_loss, kl_loss_coef=kl_loss_coef,
        kl_penalty=kl_penalty, entropy_coeff=entropy_coeff, n_tokens=n_tokens,
    )


def trainable_parameters(model: Qwen25VL, freeze_vision_tower: bool = False):
    """(name, parameter) pairs the update moves: all, or all but the vision tower."""
    return [(n, p) for n, p in model.named_parameters()
            if not (freeze_vision_tower and n.startswith("vision."))]


def _global_norm_f32(grads, group=None, tp_group=None) -> torch.Tensor:
    """Global L2 norm with fp32 accumulation and no fp32 copy of a leaf;
    ``grads`` are this rank's shards, their squares summed over ``group``.
    ``tp_group``: the leaves split over it (``parallel.tensor.SPLITS``) add
    their squares over it too; the replicated ones count once."""
    def squares(names):
        return sum((torch.linalg.vector_norm(grads[n], dtype=torch.float32).square() for n in names),
                   torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device))

    if tp_group is None:
        sq = sum(torch.linalg.vector_norm(g, dtype=torch.float32).square() for g in grads.values())
        if group is not None:
            sq = sum_over(sq, group).to(sq.device, torch.float32)
        return torch.sqrt(sq)
    split = [n for n in grads if split_of(n) is not None]
    replicated = [n for n in grads if split_of(n) is None]
    sq_split = sum_over(sum_over(squares(split), group), tp_group)
    sq = sq_split + sum_over(squares(replicated), group)
    return torch.sqrt(sq.to(next(iter(grads.values())).device, torch.float32))


def _token_mask(batch) -> torch.Tensor:
    """The mask a micro-batch's losses average over."""
    if isinstance(batch, PackedTrainBatch):
        return batch.loss_mask
    return getattr(batch, "train", batch).response_mask


def _index(batch, i: int):
    """Micro-batch ``i`` of a batch tuple (tuples nested in it included)."""
    return type(batch)(*(_index(x, i) if isinstance(x, tuple) else x[i] for x in batch))


def _n_micro(batch) -> int:
    first = batch[0]
    return _n_micro(first) if isinstance(first, tuple) else first.shape[0]


def _micro(batch, vision, i: int):
    return _index(batch, i), None if vision is None else _index(vision, i)


def _make_grad_fn(model: Qwen25VL, loss_fn: Callable, *, max_grad_norm: float = 1.0,
                  grad_accum_dtype=torch.float32, freeze_vision_tower: bool = False,
                  loss_key: Optional[str] = "actor/loss", norm_key: str = "actor/grad_norm",
                  groups: Optional[DistGroups] = None, **loss_kwargs):
    """The accumulation loop shared by the actor's and the critic's updates:
    ``loss_fn(model, micro_batch, vision, **loss_kwargs) -> (loss, metrics)``,
    run inside the model's forward (``model(loss_fn, ...)``); ``loss_key``
    names the loss among the metrics (None: not logged), ``norm_key`` the
    gradient norm. ``groups``: several GPUs (the module docstring); the
    accumulators then hold this rank's gradient shards."""
    sharded = is_sharded(model)

    def grad_step(micro_batches, vision=None):
        """micro_batches: a batch tuple with a leading (n_micro,) dim on every
        tensor; ``vision``, when present, a ``VisionInputs`` stacked the same
        way. Returns (grads by parameter name, metrics, finite, factor). The
        ``grad`` span ends at the norm's host read, which waits for the loop."""
        with span("grad"):
            return accumulate(micro_batches, vision)

    def accumulate(micro_batches, vision):
        named = trainable_parameters(model, freeze_vision_tower)
        frozen = [p for n, p in model.named_parameters()
                  if freeze_vision_tower and n.startswith("vision.") and p.requires_grad]
        acc = {n: torch.zeros_like(local(p), dtype=grad_accum_dtype) for n, p in named}

        def accumulate_into(a):
            def hook(p):
                a.add_(p.grad.to(a.dtype))
                p.grad = None
            return hook

        # FSDP writes each micro-batch's reduced shard into .grad itself (no
        # accumulate hook fires on a sharded parameter): taken after backward
        handles = [] if sharded else [
            p.register_post_accumulate_grad_hook(accumulate_into(acc[n])) for n, p in named]
        for p in frozen:
            p.requires_grad_(False)
        n_micro = _n_micro(micro_batches)
        sums: Dict[str, torch.Tensor] = {}
        try:
            for i in range(n_micro):
                mb, vis = _micro(micro_batches, vision, i)
                kwargs = dict(loss_kwargs)
                if groups is not None:  # clamped as masked_mean clamps its count
                    kwargs["n_tokens"] = max(sum_over(_token_mask(mb).float().sum(), groups.batch).item(), 1e-8)
                loss, metrics = model(loss_fn, mb, vis, **kwargs)
                loss.backward()
                if sharded:
                    for n, p in named:
                        if p.grad is not None:
                            acc[n].add_(local(p.grad).to(acc[n].dtype))
                            p.grad = None
                    for p in frozen:  # FSDP may reduce them anyway; they never step
                        p.grad = None
                if loss_key is not None:
                    metrics[loss_key] = loss
                for key, value in metrics.items():
                    sums[key] = sums.get(key, 0.0) + value.detach().float()
        finally:
            for h in handles:
                h.remove()
            for p in frozen:
                p.requires_grad_(True)
        metrics = {k: v / n_micro for k, v in sums.items()}
        if groups is not None:  # each rank holds its share of every mean (once a TP group)
            over = dist.group.WORLD if groups.tp is None else groups.batch
            metrics = {k: sum_over(v, over).float().to(v.device) for k, v in metrics.items()}

        grad_norm = _global_norm_f32(acc, None if groups is None else groups.norm,
                                     None if groups is None else groups.tp) / n_micro
        metrics[norm_key] = grad_norm
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
    with span("apply"):
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
