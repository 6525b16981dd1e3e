"""The per-step glue of a GRPO step as plain functions (counterpart of the
``GRPOTrainer`` methods of ``spatialthinker_tpu/trainer/grpo_trainer.py``
between "a rollout batch exists" and "the parameters have moved"):

    rollout_batch_from_result   engine result -> RolloutBatch with full sequences
    train_batch_views           RolloutBatch -> TrainBatch (host arrays)
    pack_rows                   first-fit-decreasing packing, the trainer's row length rule
    vision_for_packed           vision pack in the packed rows' image order
    compute_log_probs_batched   old / ref log-probs in experience-sized pieces
    compute_advantages          the five estimators, groups from uid strings
    iter_minibatches            the seeded shuffle shared by the update loops
    packed_micro_batches        a mini-batch as packed rows + vision packs, per micro-batch
    update_actor_packed         padding-free policy update
    update_actor                per-sample-layout policy update

Every function takes what the trainer class reads from ``self`` (model,
update function, knobs, device) as explicit arguments. Single process only:
the JAX trainer's cross-process negotiation of row lengths, row counts and
vision widths and its globalized vision packs are not here; they come with
the multi-GPU port.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..algos.advantages import (
    compute_gae_advantage_return, compute_grpo_outcome_advantage,
    compute_reinforce_plus_plus_outcome_advantage, compute_remax_outcome_advantage,
    compute_rloo_outcome_advantage,
)
from ..core.batch import RolloutBatch
from ..data.packing import pack_vision_batch, stack_vision_packs
from ..data.text_packing import (
    PackedRows, SlotMap, gather_response_values, pack_train_rows, pad_rows_to_count,
)
from ..models.qwen2_5_vl.config import VisionConfig
from ..models.qwen2_5_vl.host import VisionInputs
from ..models.qwen2_5_vl.model import Qwen25VL, vision_to_device
from ..models.qwen2_5_vl.params import default_device
from .metrics import reduce_metrics
from .train_step import PackedTrainBatch, TrainBatch, compute_log_probs, compute_packed_log_probs


def rollout_batch_from_result(repeated: RolloutBatch, responses, response_mask,
                              rollout_log_probs) -> RolloutBatch:
    """The rollout batch a train step works on: the prompts (already repeated
    ``n`` times, one row per sample) joined with an engine's result."""
    responses = np.asarray(responses)
    response_mask = np.asarray(response_mask)
    return RolloutBatch(
        tensors={
            **repeated.tensors,
            "responses": responses,
            "response_mask": response_mask,
            "rollout_log_probs": np.asarray(rollout_log_probs),
            "full_input_ids": np.concatenate([repeated.tensors["input_ids"], responses], axis=1),
            "full_segment_ids": np.concatenate(
                [repeated.tensors["segment_ids"], response_mask], axis=1),
        },
        non_tensors=repeated.non_tensors,
        meta=repeated.meta,
    )


def train_batch_views(batch: RolloutBatch) -> TrainBatch:
    """The host-side TrainBatch (full positions incl. generated ones)."""
    b, _ = batch.tensors["input_ids"].shape
    r = batch.tensors["responses"].shape[1]
    pos_prompt = np.transpose(batch.tensors["position_ids"], (1, 0, 2))  # (3, B, P)
    steps = np.arange(r, dtype=np.int64)[None, :]
    gen_pos = batch.tensors["gen_pos_start"][:, None] + steps  # (B, R)
    pos_resp = np.broadcast_to(gen_pos[None], (3, b, r))
    full_pos = np.concatenate([pos_prompt, pos_resp], axis=2)

    zeros = np.zeros_like(batch.tensors["responses"], dtype=np.float32)
    return TrainBatch(
        input_ids=batch.tensors["full_input_ids"],
        segment_ids=batch.tensors["full_segment_ids"],
        position_ids=full_pos,
        responses=batch.tensors["responses"],
        response_mask=batch.tensors["response_mask"].astype(np.float32),
        old_log_probs=batch.tensors.get("old_log_probs", zeros),
        ref_log_probs=batch.tensors.get("ref_log_probs", zeros),
        advantages=batch.tensors.get("advantages", zeros),
    )


def to_device(batch, device):
    """A (Packed)TrainBatch of host arrays -> tensors on ``device``."""
    return type(batch)(*(torch.as_tensor(np.ascontiguousarray(x), device=device) for x in batch))


def vision_for_packed(batch: RolloutBatch, slot_map: SlotMap, vision_cfg: VisionConfig,
                      row_lo: Optional[int] = None, row_hi: Optional[int] = None,
                      pad_to: Optional[int] = None) -> Optional[VisionInputs]:
    """Vision pack whose image order matches the packed rows' row-major
    image-token order (sample order sorted by (row, offset))."""
    order = sorted(
        range(len(batch)),
        key=lambda i: (int(slot_map.row[i]), int(slot_map.dst_start[i])),
    )
    if row_lo is not None:
        order = [i for i in order if row_lo <= int(slot_map.row[i]) < row_hi]
    patches = [batch.non_tensors["patches"][i] for i in order]
    grids = [batch.non_tensors["image_grid_thw"][i] for i in order]
    return pack_vision_batch(patches, grids, vision_cfg, pad_to=pad_to)


def pack_rows(batch: RolloutBatch, per_token=None) -> Tuple[PackedRows, SlotMap]:
    seg = batch.tensors["segment_ids"]
    mask = batch.tensors["response_mask"]
    totals = seg.sum(-1) + mask.sum(-1)
    max_total = int(totals.max())
    mean_total = float(totals.mean())
    # rows must fit the longest sample; make them big enough to hold ~2
    # average samples so FFD can actually pack (row == max gives 1/row)
    target = max(max_total, int(2 * mean_total))
    row_len = max(256, ((target + 255) // 256) * 256)
    return pack_train_rows(
        batch.tensors["input_ids"], seg, batch.tensors["position_ids"],
        batch.tensors["responses"], mask, batch.tensors["gen_pos_start"],
        per_token=per_token, row_len=row_len,
    )


def _pack_vision(batch: RolloutBatch, vision_cfg: VisionConfig) -> Optional[VisionInputs]:
    return pack_vision_batch(
        list(batch.non_tensors["patches"]), list(batch.non_tensors["image_grid_thw"]), vision_cfg,
    )


@torch.no_grad()
def compute_log_probs_batched(
    model: Qwen25VL, batch: RolloutBatch, *, micro_batch_size: int, padding_free: bool = True,
    temperature: float = 1.0, chunk_size: int = 1024, device=None,
) -> np.ndarray:
    """Micro-batched old/ref log-prob recompute (no grad), (B, R) on the
    host. Both layouts split the rollout batch into experience-sized pieces
    of ``micro_batch_size`` samples first: the per-chunk fp32 logits inside
    the log-prob loop (rows x chunk x vocab) are what bound memory, so one
    forward over the whole rollout would not fit at full vocabulary."""
    device = default_device() if device is None else device
    vision_cfg = model.cfg.vision
    chunk = max(micro_batch_size, 1)
    kw = dict(remat=False, temperature=temperature, chunk_size=chunk_size)
    outs = []
    if padding_free:
        r = batch.tensors["responses"].shape[1]
        for piece in batch.split(chunk):
            packed, slot_map = pack_rows(piece)
            vision = vision_to_device(vision_for_packed(piece, slot_map, vision_cfg), device)
            ptb = to_device(PackedTrainBatch(*packed), device)
            logp_rows = compute_packed_log_probs(model, ptb, vision, **kw)[0]
            outs.append(gather_response_values(logp_rows.float().cpu().numpy(), slot_map, r))
        return np.concatenate(outs, axis=0)
    for piece in batch.split(chunk):
        tb = to_device(train_batch_views(piece), device)
        vision = vision_to_device(_pack_vision(piece, vision_cfg), device)
        outs.append(compute_log_probs(model, tb, vision, **kw)[0].float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def compute_advantages(batch: RolloutBatch, adv_estimator: str, *, gamma: float = 1.0,
                       lam: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(advantages, returns), each (B, R), from ``token_level_rewards``. GRPO
    and RLOO group rows by their ``uid`` strings; the result does not depend
    on the order ``np.unique`` gives the groups."""
    rewards = torch.as_tensor(batch.tensors["token_level_rewards"], dtype=torch.float32)
    mask = torch.as_tensor(batch.tensors["response_mask"].astype(np.float32))
    if adv_estimator in ("grpo", "rloo"):
        _, gid = np.unique(batch.non_tensors["uid"], return_inverse=True)
        fn = compute_grpo_outcome_advantage if adv_estimator == "grpo" else compute_rloo_outcome_advantage
        adv, ret = fn(rewards, mask, torch.as_tensor(gid.astype(np.int64)), int(gid.max()) + 1)
    elif adv_estimator == "reinforce_plus_plus":
        adv, ret = compute_reinforce_plus_plus_outcome_advantage(rewards, mask, gamma)
    elif adv_estimator == "remax":
        baselines = torch.as_tensor(batch.tensors["reward_baselines"], dtype=torch.float32)
        adv, ret = compute_remax_outcome_advantage(rewards, baselines, mask)
    elif adv_estimator == "gae":
        values = torch.as_tensor(batch.tensors["values"], dtype=torch.float32)
        adv, ret = compute_gae_advantage_return(rewards, values, mask, gamma, lam)
    else:
        raise NotImplementedError(f"unknown adv estimator {adv_estimator}")
    return adv.numpy(), ret.numpy()


def iter_minibatches(batch: RolloutBatch, mini_bs: int, ppo_epochs: int, seed_mult: int,
                     global_step: int) -> Iterator[RolloutBatch]:
    """Shuffled full mini-batches for ``ppo_epochs`` passes (shared by the
    actor, packed and critic update loops; the permutation is seeded by the
    step and the epoch)."""
    bs = len(batch)
    for epoch in range(ppo_epochs):
        order = np.random.default_rng(global_step * seed_mult + epoch).permutation(bs)
        for start in range(0, bs - mini_bs + 1, mini_bs):
            yield batch.select(order[start : start + mini_bs])


def packed_micro_batches(mini: RolloutBatch, vision_cfg: VisionConfig,
                         micro_rows: int) -> Tuple[PackedTrainBatch, Optional[VisionInputs]]:
    """One mini-batch as the packed update takes it (host arrays): its samples
    bin-packed into rows, the rows padded to whole micro-batches of at most
    ``micro_rows`` and given a leading micro dim ((n_micro, rows, L); position
    ids (n_micro, 3, rows, L)), and one vision pack per micro-batch in its
    rows' image order, stacked at a common width."""
    micro_rows = max(micro_rows, 1)
    zeros = np.zeros_like(mini.tensors["old_log_probs"])
    packed, slot_map = pack_rows(
        mini,
        per_token={
            "old_log_probs": mini.tensors["old_log_probs"],
            "ref_log_probs": mini.tensors.get("ref_log_probs", zeros),
            "advantages": mini.tensors["advantages"],
        },
    )
    rows_target = packed.input_ids.shape[0]
    n_micro = max((rows_target + micro_rows - 1) // micro_rows, 1)
    per = -(-rows_target // n_micro)   # rows per micro step (ceil)
    packed = pad_rows_to_count(packed, per * n_micro)

    def micro_shape(x):
        x = np.asarray(x)
        if x.ndim == 3:  # (3, rows, L)
            return x.reshape(3, n_micro, per, x.shape[-1]).transpose(1, 0, 2, 3)
        return x.reshape(n_micro, per, *x.shape[1:])

    packs = [
        vision_for_packed(mini, slot_map, vision_cfg, row_lo=g * per, row_hi=(g + 1) * per)
        for g in range(n_micro)
    ]
    return (PackedTrainBatch(*(micro_shape(x) for x in packed)),
            stack_vision_packs(packs, vision_cfg))


def update_actor_packed(
    batch: RolloutBatch, packed_update_fn: Callable, vision_cfg: VisionConfig, *,
    global_batch_size: int, micro_rows: int, ppo_epochs: int = 1, global_step: int = 0,
    device=None,
) -> Dict[str, float]:
    """Padding-free policy update: every mini-batch is bin-packed into rows,
    the rows cut into micro-batches of ``micro_rows``, and handed to
    ``packed_update_fn`` (``make_packed_update_fn``'s result). Returns the
    metrics averaged over the mini-batches."""
    device = default_device() if device is None else device
    metrics_acc: Dict[str, List[float]] = defaultdict(list)
    mini_bs = min(global_batch_size, len(batch))
    for mini in iter_minibatches(batch, mini_bs, ppo_epochs, 131, global_step):
        ptb, vision = packed_micro_batches(mini, vision_cfg, micro_rows)
        metrics = packed_update_fn(to_device(ptb, device), vision_to_device(vision, device))
        for k, v in metrics.items():
            metrics_acc[k].append(float(v))
    return reduce_metrics(metrics_acc)


def _fit_n_micro(mini_bs: int, micro: int) -> int:
    n_micro = max(mini_bs // micro, 1)
    while mini_bs % n_micro:  # micro dim must divide the mini-batch
        n_micro -= 1
    return n_micro


def _reshape_micro(x, n_micro: int) -> np.ndarray:
    """Add the leading micro dim ((3, B, S) position ids keep 3 second)."""
    x = np.asarray(x)
    if x.ndim >= 2 and x.shape[0] == 3:
        return (
            x.reshape(3, n_micro, x.shape[1] // n_micro, *x.shape[2:])
            .transpose(1, 0, 2, 3)
        )
    return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])


def update_actor(
    batch: RolloutBatch, update_fn: Callable, vision_cfg: VisionConfig, *,
    global_batch_size: int, micro_batch_size: int, ppo_epochs: int = 1, global_step: int = 0,
    device=None,
) -> Dict[str, float]:
    """Policy update on the per-sample layout: mini-batches cut into
    micro-batches of ``micro_batch_size`` samples, one vision pack per
    micro-batch at a common width, handed to ``update_fn``
    (``make_update_fn``'s result)."""
    device = default_device() if device is None else device
    metrics_acc: Dict[str, List[float]] = defaultdict(list)
    mini_bs = min(max(global_batch_size, 1), len(batch))
    n_micro = _fit_n_micro(mini_bs, max(micro_batch_size, 1))
    for mini in iter_minibatches(batch, mini_bs, ppo_epochs, 131, global_step):
        tb = train_batch_views(mini)
        micro_batches = to_device(TrainBatch(*(_reshape_micro(x, n_micro) for x in tb)), device)
        packs = [_pack_vision(piece, vision_cfg) for piece in mini.split(len(mini) // n_micro)]
        vision = vision_to_device(stack_vision_packs(packs, vision_cfg), device)
        for k, v in update_fn(micro_batches, vision).items():
            metrics_acc[k].append(float(v))
    return reduce_metrics(metrics_acc)
