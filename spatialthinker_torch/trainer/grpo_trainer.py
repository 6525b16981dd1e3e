"""The GRPO/PPO training loop: one process runs rollout -> reward -> log-probs ->
advantages -> policy update on one set of weights on one GPU (counterpart of
``spatialthinker_tpu/trainer/grpo_trainer.py``).

``GRPOTrainer`` is the class a user starts (through ``trainer/main.py``); it
reads everything from the config tree and keeps the state of a run. The
per-step glue between "a rollout batch exists" and "the parameters have
moved" is plain functions that the class calls with what it holds:

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
    compute_values_batched      the critic's values in experience-sized pieces (GAE)
    update_critic               the critic's clipped-value update (GAE)

Every function takes what the trainer class reads from ``self`` (model,
update function, knobs, device) as explicit arguments.

Several GPUs (one process each, launched by ``torchrun``; ``parallel/``): the
trainer takes its distributed branch whenever a process group exists. The
policy (and the reference copy, and the critic) is FSDP-sharded over the
mesh's ``(data, fsdp x model)`` dims; each rank rolls out and scores its own
prompts with its own engine on a gathered copy of the weights, the ranks of
an sp group (the ``model`` axis) then share their rows, and the log-prob and
update forwards run over each rank's rows, the sequence split over the sp
group (``sp``). Every sharded forward and backward is a collective, so every
rank must run the same number of them: ``Lockstep`` negotiates what depends
on the data (packed row counts, whether a forward carries images), and
padding rows carry segment id 0. Advantages, the KL controller and the
logged metrics are computed on the union of the ranks' rows (the JAX
trainer's global arrays), so every rank sees the same numbers.

Tensor parallelism (``sharding.model_size`` > 1 without sp; ``parallel/
tensor.py``): the trainer keeps this rank's Megatron shard of the policy
it is given (cut by ``tp_local`` from a whole one; ``trainer.main`` loads an
HF checkpoint as the shard itself, on the mesh from ``run_mesh``) and
FSDP-shards that over ``(data, fsdp)``; the reference and the critic are
TP-local alike (the critic's HF backbone loads as a shard too). The ranks
of a TP group take the same prompts (the loader's shard is the batch index)
and run ONE engine on them in lockstep: each rank's copy holds its
heads' weights and kv pools, ``embed_tokens`` and the head whole
(``tp_rollout_copy``), its page pool the group's smallest, its sampler the
group's stream, so the group draws the same tokens. Any engine (dense,
continuous, paged) and any quantization (W8A8, w4a8: each rank's int4
copies are its shards, ``ops.quant.quantize_model``) runs so. Beside
sequence parallelism (``tensor_parallel_size`` = sp = ``model_size``) the
training layout stays sp's; the rollout copy is TP-local all the same
(``tp_rollout_copy`` cuts each whole parameter to this rank's slice as it
is gathered), and the ``model`` group gathers its ranks' prompts, decodes
their union on one engine and keeps each rank's own rows.
"""

from __future__ import annotations

import copy
import os
import logging
import time
import uuid
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..algos.advantages import (
    compute_gae_advantage_return, compute_grpo_outcome_advantage,
    compute_reinforce_plus_plus_outcome_advantage, compute_remax_outcome_advantage,
    compute_rloo_outcome_advantage,
)
from ..algos.kl_controller import get_kl_controller
from ..algos.losses import compute_kl
from ..core.batch import RolloutBatch, trim_prompt_padding, trim_response_padding
from ..core.config import PPOConfig
from ..data.packing import empty_vision_pack, pack_vision_batch, patch_dim, stack_vision_packs
from ..data.text_packing import (
    PackedRows, SlotMap, gather_response_values, pack_train_rows, pad_rows_to_count,
)
from ..models.qwen2_5_vl.config import Qwen25VLConfig, VisionConfig, get_config
from ..models.qwen2_5_vl.host import VisionInputs, window_patch_len
from ..models.qwen2_5_vl.model import Qwen25VL, vision_to_device
from ..models.qwen2_5_vl.params import (
    build_model, config_from_hf_json, default_device, init_params, is_hf_checkpoint_dir, load_params,
)
from ..ops.quant import quantize_model
from ..ops.ulysses import UlyssesSpec
from ..parallel.mesh import batch_group, batch_rank, create_mesh, norm_group, sp_group, tp_group
from ..parallel.multihost import allgather_pyobj, negotiate_row_count
from ..parallel.offload import HostLeaf, host_bytes, host_view, offload_to_host, restore_from_host
from ..parallel.sharding import (
    full_state, full_tensor, local, local_piece, rollout_bytes, shard_model, tp_rollout_copy,
    unsharded_copy,
)
from ..parallel.tensor import TPSpec, gather_leaf, split_of, tp_size
from ..rewards.manager import RewardManager
from ..rollout.engine import generate
from ..rollout.continuous import effective_prefill_chunk, generate_continuous
from ..rollout.paged import generate_paged, prefill_transient_bytes
from ..rollout.sampling import SamplingParams
from ..utils.flops_counter import FlopsCounter, compute_mfu
from ..utils.profiling import device_memory_metrics, maybe_trace
from ..utils.seqlen_balancing import balance_order
from .checkpoint import CheckpointManager
from .critic import Critic, CriticBatch, compute_values, make_critic_update_fn
from .streamed_opt import make_streamed_optimizer
from .metrics import (
    Timer, compute_data_metrics, compute_throughput_metrics, compute_timing_metrics,
    reduce_metrics,
)
from .tracker import Tracker
from .train_step import (
    DistGroups, PackedTrainBatch, TrainBatch, compute_log_probs, compute_packed_log_probs,
    make_optimizer, make_packed_update_fn, make_update_fn, trainable_parameters,
)

logger = logging.getLogger(__name__)
KV_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8, "int4": torch.uint8}


class Lockstep:
    """Agreement between ranks on what depends on the data, so every rank runs
    the same number of sharded forwards and backwards (``group`` None: one
    process, every value is its own)."""

    def __init__(self, group=None):
        self.group = group

    def max(self, n: int) -> int:
        return n if self.group is None else negotiate_row_count(n, self.group)

    def any(self, flag: bool) -> bool:
        return flag if self.group is None else self.max(int(flag)) > 0

    def vision(self, vision: Optional[VisionInputs], cfg: VisionConfig, n_micro: int = 0):
        """``vision``, or an all-padding pack (one window; ``n_micro`` > 0: one
        per micro-batch, stacked) where another rank's forward runs the
        vision tower and this one has no image: the tower is sharded too."""
        if not self.any(vision is not None) or vision is not None:
            return vision
        empty = empty_vision_pack(cfg, window_patch_len(cfg), patch_dim(cfg))
        return stack_vision_packs([empty] * n_micro, cfg) if n_micro else empty


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
    temperature: float = 1.0, chunk_size: int = 1024, device=None, sp=None,
    lockstep: Optional[Lockstep] = None,
) -> np.ndarray:
    """Micro-batched old/ref log-prob recompute (no grad), (B, R) on the
    host. Both layouts split the rollout batch into experience-sized pieces
    of ``micro_batch_size`` samples first: the per-chunk fp32 logits inside
    the log-prob loop (rows x chunk x vocab) are what bound memory, so one
    forward over the whole rollout would not fit at full vocabulary.
    ``lockstep`` (several GPUs) pads each piece's packed rows to the ranks'
    common count and runs the vision tower wherever any rank's piece has an
    image; ``sp`` splits the sequence over the sp group."""
    device = default_device() if device is None else device
    lockstep = lockstep or Lockstep()
    vision_cfg = model.cfg.vision
    chunk = max(micro_batch_size, 1)
    kw = dict(remat=False, temperature=temperature, chunk_size=chunk_size, sp=sp)
    outs = []
    if padding_free:
        r = batch.tensors["responses"].shape[1]
        for piece in batch.split(chunk):
            packed, slot_map = pack_rows(piece)
            packed = pad_rows_to_count(packed, lockstep.max(packed.input_ids.shape[0]))
            vision = lockstep.vision(vision_for_packed(piece, slot_map, vision_cfg), vision_cfg)
            ptb = to_device(PackedTrainBatch(*packed), device)
            logp_rows = model(compute_packed_log_probs, ptb, vision_to_device(vision, device), **kw)[0]
            outs.append(gather_response_values(logp_rows.float().cpu().numpy(), slot_map, r))
        return np.concatenate(outs, axis=0)
    for piece in batch.split(chunk):
        tb = to_device(train_batch_views(piece), device)
        vision = vision_to_device(lockstep.vision(_pack_vision(piece, vision_cfg), vision_cfg), device)
        outs.append(model(compute_log_probs, tb, vision, **kw)[0].float().cpu().numpy())
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


def packed_micro_batches(mini: RolloutBatch, vision_cfg: VisionConfig, micro_rows: int,
                         lockstep: Optional[Lockstep] = None
                         ) -> Tuple[PackedTrainBatch, Optional[VisionInputs]]:
    """One mini-batch as the packed update takes it (host arrays): its samples
    bin-packed into rows, the rows padded to whole micro-batches of at most
    ``micro_rows`` and given a leading micro dim ((n_micro, rows, L); position
    ids (n_micro, 3, rows, L)), and one vision pack per micro-batch in its
    rows' image order, stacked at a common width. ``lockstep``: the row count
    (and so the micro-batch count) is the ranks' common one."""
    lockstep = lockstep or Lockstep()
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
    rows_target = lockstep.max(packed.input_ids.shape[0])
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
            lockstep.vision(stack_vision_packs(packs, vision_cfg), vision_cfg, n_micro))


def update_actor_packed(
    batch: RolloutBatch, packed_update_fn: Callable, vision_cfg: VisionConfig, *,
    global_batch_size: int, micro_rows: int, ppo_epochs: int = 1, global_step: int = 0,
    device=None, lockstep: Optional[Lockstep] = None,
) -> Dict[str, float]:
    """Padding-free policy update: every mini-batch is bin-packed into rows,
    the rows cut into micro-batches of ``micro_rows``, and handed to
    ``packed_update_fn`` (``make_packed_update_fn``'s result). Returns the
    metrics averaged over the mini-batches. ``global_batch_size`` counts
    this process's rows (the trainer divides the global one by the ranks)."""
    device = default_device() if device is None else device
    metrics_acc: Dict[str, List[float]] = defaultdict(list)
    mini_bs = min(global_batch_size, len(batch))
    for mini in iter_minibatches(batch, mini_bs, ppo_epochs, 131, global_step):
        ptb, vision = packed_micro_batches(mini, vision_cfg, micro_rows, lockstep)
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
    device=None, lockstep: Optional[Lockstep] = None,
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
        vision = (lockstep or Lockstep()).vision(stack_vision_packs(packs, vision_cfg), vision_cfg, n_micro)
        for k, v in update_fn(micro_batches, vision_to_device(vision, device)).items():
            metrics_acc[k].append(float(v))
    return reduce_metrics(metrics_acc)


@torch.no_grad()
def compute_values_batched(critic: Critic, batch: RolloutBatch, *, micro_batch_size: int,
                           device=None, sp=None, lockstep: Optional[Lockstep] = None) -> np.ndarray:
    """The critic's (B, R) values on the host, in experience-sized pieces of
    ``micro_batch_size`` samples on the per-sample layout."""
    device = default_device() if device is None else device
    lockstep = lockstep or Lockstep()
    outs = []
    for piece in batch.split(max(micro_batch_size, 1)):
        tb = to_device(train_batch_views(piece), device)
        vision = lockstep.vision(_pack_vision(piece, critic.cfg.vision), critic.cfg.vision)
        outs.append(critic(compute_values, tb, vision_to_device(vision, device), sp=sp).cpu().numpy())
    return np.concatenate(outs, axis=0)


def update_critic(
    batch: RolloutBatch, critic_update_fn: Callable, vision_cfg: VisionConfig, *,
    global_batch_size: int, micro_batch_size: int, ppo_epochs: int = 1, global_step: int = 0,
    device=None, lockstep: Optional[Lockstep] = None,
) -> Dict[str, float]:
    """The critic's update on the per-sample layout: mini-batches (their own
    shuffle, ``seed_mult`` 173) cut into micro-batches of
    ``micro_batch_size`` samples with the old values and the returns beside
    them, one vision pack per micro-batch, handed to ``critic_update_fn``
    (``make_critic_update_fn``'s result)."""
    device = default_device() if device is None else device
    metrics_acc: Dict[str, List[float]] = defaultdict(list)
    mini_bs = min(max(global_batch_size, 1), len(batch))
    n_micro = _fit_n_micro(mini_bs, max(micro_batch_size, 1))
    for mini in iter_minibatches(batch, mini_bs, ppo_epochs, 173, global_step):
        tb = train_batch_views(mini)
        micro = {k: torch.as_tensor(_reshape_micro(mini.tensors[k], n_micro).astype(np.float32),
                                    device=device) for k in ("values", "returns")}
        cb = CriticBatch(train=to_device(TrainBatch(*(_reshape_micro(x, n_micro) for x in tb)), device),
                         **micro)
        packs = [_pack_vision(piece, vision_cfg) for piece in mini.split(len(mini) // n_micro)]
        vision = (lockstep or Lockstep()).vision(stack_vision_packs(packs, vision_cfg), vision_cfg, n_micro)
        for k, v in critic_update_fn(cb, vision_to_device(vision, device)).items():
            metrics_acc[k].append(float(v))
    return reduce_metrics(metrics_acc)


def _obj(values) -> np.ndarray:
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


def tensor_parallel_size(config: PPOConfig) -> int:
    """The TP degree of a run: ``model_size`` when the model axis is not
    carrying sequence shards, else 1."""
    sh, actor = config.worker.actor.sharding, config.worker.actor
    return sh.model_size if actor.ulysses_sequence_parallel_size == 1 else 1


def tp_local(model: Qwen25VL, tp: TPSpec) -> Qwen25VL:
    """This rank's Megatron shard of a whole ``model`` (``build_model`` with
    ``tp``: new tensors, the whole model can be dropped)."""
    weight = model.text.norm.weight
    out = build_model(model.cfg, model.state_dict(), device=weight.device, dtype=weight.dtype, tp=tp)
    return out.train(model.training)


def run_mesh(config: PPOConfig, kv_heads: int, device_type: str):
    """The mesh of a run over the default process group, after
    ``mesh_checks``: what ``GRPOTrainer`` builds unless it is handed one (a
    caller that loads each rank's TP shard needs the ``model`` group first)."""
    world = dist.get_world_size()
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world // max(config.trainer.nnodes, 1)))
    mesh_checks(config, kv_heads, world, local_ranks)
    sh = config.worker.actor.sharding
    return create_mesh(sh.data_size, sh.fsdp_size, sh.model_size, device_type=device_type)


def mesh_checks(config: PPOConfig, kv_heads: int, world: int, local_ranks: int) -> None:
    """What a run on ``world`` ranks (``local_ranks`` of them on this node)
    checks of its config before it builds the mesh: ``n_chips`` against the
    node's ranks, the rollout batch against the ranks that hold other rows,
    the JAX trainer's kv-head cap of tensor parallelism and its
    sequence-parallel rules (its grpo_trainer.py sp block)."""
    n_chips = config.trainer.n_chips
    if n_chips != local_ranks:
        raise ValueError(f"trainer.n_chips={n_chips} must equal the ranks on this node ({local_ranks})")
    sh, actor = config.worker.actor.sharding, config.worker.actor
    sp_size = actor.ulysses_sequence_parallel_size
    tp = tensor_parallel_size(config)
    if tp > 1 and kv_heads % tp:
        raise ValueError(
            f"sharding.model_size={sh.model_size} must divide the model's "
            f"num_key_value_heads={kv_heads}: the fused qkv_proj is tensor-parallel "
            "over KV-head groups (use fsdp_size for further sharding, or "
            "sequence_parallel_backend=ring to ride the model axis with "
            "sequence shards instead)"
        )
    if sp_size > 1:
        if sp_size != sh.model_size:
            raise ValueError(
                f"ulysses_sequence_parallel_size={sp_size} must equal "
                f"sharding.model_size={sh.model_size} (sp rides the model axis)")
        if actor.sequence_parallel_backend == "ulysses" and kv_heads % sp_size:
            raise ValueError(
                f"kv heads ({kv_heads}) must be divisible by sp={sp_size} for the ulysses backend "
                "-- sequence_parallel_backend=ring rotates KV instead and has no head cap")
        seq = config.data.max_prompt_length + config.data.max_response_length
        if seq % sp_size:
            raise ValueError(f"sequence length {seq} must be divisible by sp={sp_size}")
        if config.worker.rollout.tensor_parallel_size > 1 and kv_heads % sp_size:
            raise ValueError(
                f"rollout.tensor_parallel_size={sp_size} beside sp must divide the model's "
                f"num_key_value_heads={kv_heads}: the rollout copy is tensor-parallel over KV-head groups")
    if config.data.rollout_batch_size % (world // tp):
        raise ValueError(
            f"data.rollout_batch_size={config.data.rollout_batch_size} must be divisible "
            f"by the {world // tp} processes that hold other rows")


class GRPOTrainer:
    """One GRPO/PPO training run on one GPU, or one rank of a run on several
    (a process group exists: the module docstring). ``model`` is the policy (a
    ``Qwen25VL`` on the device the run uses, whole: the trainer shards it
    when it runs on several GPUs); the trainer updates it in place,
    keeps a frozen copy as the reference policy when the KL term is on (on the
    host under ``ref.offload``), and owns the optimizer (its state on the host
    under ``optim.stream``, or between updates under
    ``host_offload_optimizer``), the tracker and the checkpoint manager.
    ``device`` is where the model lives (read from its parameters).
    ``prefill_dequant_min_m`` > 0 turns on the rollout copy's prefill-dequant
    mode (``ops.quant.quantize_model``)."""

    def __init__(
        self,
        config: PPOConfig,
        tokenizer,
        model: Qwen25VL,
        train_dataloader,
        val_dataloader=None,
        reward_fn: Optional[RewardManager] = None,
        val_reward_fn: Optional[RewardManager] = None,
        prefill_dequant_min_m: int = 0,
        mesh=None,
    ):
        self.config = config
        self.tokenizer = tokenizer
        self.model = model
        self.model_cfg = model.cfg
        self.device = model.text.norm.weight.device
        self.train_dataloader = train_dataloader
        self.val_dataloader = val_dataloader
        self.reward_fn = reward_fn
        self.val_reward_fn = val_reward_fn or reward_fn
        self.prefill_dequant_min_m = prefill_dequant_min_m

        algo = config.algorithm
        self.adv_estimator = algo.adv_estimator
        self.use_critic = self.adv_estimator == "gae"
        self._setup_mesh(mesh)
        model = self.model  # under TP this rank's shard of the policy
        if self.adv_estimator in ("grpo", "rloo") and config.worker.rollout.n < 2:
            # group-relative baselines degenerate to zero advantage at n=1:
            # training would silently produce zero gradients
            raise ValueError(
                f"{self.adv_estimator} needs worker.rollout.n > 1 "
                f"(got {config.worker.rollout.n}); group whitening over a "
                "single sample yields identically zero advantages"
            )
        rollout_bs = config.data.rollout_batch_size * config.worker.rollout.n
        for role, gbs in (("actor", config.worker.actor.global_batch_size),
                          ("critic", config.worker.critic.global_batch_size)):
            if role == "critic" and not self.use_critic:
                continue
            if rollout_bs % min(gbs, rollout_bs) != 0:
                # iter_minibatches yields full mini-batches only; a non-dividing
                # global_batch_size would silently drop the tail samples every step
                raise ValueError(
                    f"rollout_batch_size * n = {rollout_bs} must be divisible by "
                    f"worker.{role}.global_batch_size = {gbs}"
                )
        # the critic's architecture is settled (and refused) before any weight
        # of it is allocated
        if self.use_critic:
            self.critic_model_cfg, self._critic_weights_dir = self._critic_source()
        roll = config.worker.rollout
        self.use_kl_in_reward = not algo.disable_kl and not algo.use_kl_loss
        self.use_kl_loss = not algo.disable_kl and algo.use_kl_loss
        self.use_ref = not algo.disable_kl
        self.kl_ctrl = get_kl_controller(algo.kl_type, algo.kl_coef, algo.kl_target, algo.kl_horizon)

        # reference policy = a frozen copy of the initial weights (a real
        # copy: the update moves the policy in place). ref.offload keeps it
        # on the host, copied leaf by leaf (no second copy on the card ever
        # exists), and puts it on the card for the ref stage only.
        self.ref_offload = config.worker.ref.offload
        self.ref_model: Optional[Qwen25VL] = None
        self.ref_host = None
        if self.use_ref:
            if self.ref_offload:  # several GPUs: each rank's own shards
                self.ref_host = offload_to_host({n: local(t) for n, t in model.state_dict().items()})
            elif self.mesh is not None:
                self.ref_model = self._sharded_policy({n: local(p) for n, p in model.named_parameters()})
            else:
                self.ref_model = copy.deepcopy(model).requires_grad_(False)
        # seconds and bytes of the last ref restore and streamed apply
        self.host_state_stats: Dict[str, float] = {}

        actor = config.worker.actor
        opt_cfg = actor.optim
        sharding = actor.sharding
        self.stream_opt = opt_cfg.stream
        update_kwargs = dict(
            clip_ratio_low=actor.clip_ratio_low,
            clip_ratio_high=actor.clip_ratio_high,
            clip_ratio_dual=actor.clip_ratio_dual,
            use_kl_loss=self.use_kl_loss,
            kl_loss_coef=actor.kl_loss_coef,
            kl_penalty=actor.kl_penalty,
            entropy_coeff=actor.entropy_coeff,
            max_grad_norm=actor.max_grad_norm,
            remat=sharding.remat_policy if sharding.remat else False,
            temperature=roll.temperature,
            # "" = auto: bf16 under optim.stream (an fp32 accumulator would
            # double what the card holds beside the parameters), fp32 otherwise
            grad_accum_dtype=getattr(
                torch, opt_cfg.grad_accum_dtype or ("bfloat16" if self.stream_opt else "float32")),
            groups=self.groups, sp=self.sp,
        )
        opt_kwargs = dict(
            weight_decay=opt_cfg.weight_decay,
            betas=tuple(opt_cfg.betas),
            warmup_steps=int(opt_cfg.lr_warmup_ratio * max(opt_cfg.training_steps, 0)),
            use_kahan_summation=opt_cfg.use_kahan_summation,
        )
        if self.stream_opt:
            # AnyPrecision AdamW with host-resident bf16 moments, streamed
            # through the card (trainer/streamed_opt.py)
            if opt_cfg.strategy == "adamw":
                logger.warning(
                    "optim.stream=true always uses bf16-moment AnyPrecisionAdamW; "
                    "optim.strategy='adamw' (fp32 moments) is ignored -- set "
                    "strategy='adamw_bf16' to silence this"
                )
            self.optimizer = make_streamed_optimizer(opt_cfg.lr, **opt_kwargs)
        else:
            self.optimizer = make_optimizer(opt_cfg.lr, strategy=opt_cfg.strategy, **opt_kwargs)
        # moments allocated now (on the card, or on the host under stream): the
        # paged engine's pool is sized from what is free on the card once
        # everything a run keeps there is there
        self.optimizer.init(trainable_parameters(model, actor.model.freeze_vision_tower))
        # host_offload_optimizer: the fused optimizer's state lives on the
        # host except inside the update (the streamed one's always does)
        self.offload_opt = sharding.host_offload_optimizer and not self.stream_opt
        if self.offload_opt:
            self.optimizer.state = offload_to_host(self.optimizer.state)
        self.update_fn = make_update_fn(
            model, self.optimizer, freeze_vision_tower=actor.model.freeze_vision_tower,
            **update_kwargs,
        )
        self.padding_free = actor.padding_free
        if self.padding_free:
            self.packed_update_fn = make_packed_update_fn(
                model, self.optimizer, freeze_vision_tower=actor.model.freeze_vision_tower,
                **update_kwargs,
            )

        self.critic: Optional[Critic] = None
        if self.use_critic:
            self._build_critic()

        self.sampling = SamplingParams(
            temperature=roll.temperature, top_p=roll.top_p, top_k=roll.top_k, n=roll.n,
        )
        vo = roll.val_override_config
        self.val_sampling = self.sampling.override(
            temperature=vo.temperature, top_p=vo.top_p, top_k=vo.top_k, n=vo.n
        )

        self.tracker = Tracker(  # several GPUs: rank 0 logs
            config.trainer.logger if self.rank == 0 else [], config.trainer.project_name,
            config.trainer.experiment_name,
            base_dir=config.trainer.save_checkpoint_path or ".",
        )
        self.ckpt = CheckpointManager(
            config.trainer.save_checkpoint_path, save_limit=config.trainer.save_limit
        )
        self.global_step = 0
        self.generator = torch.Generator().manual_seed(config.trainer.seed)
        self.flops_counter = FlopsCounter(self.model_cfg, self.device)
        self._last_rollout_stats: Dict[str, float] = {}
        self._paged_pool_cache: Optional[int] = None

    # ----------------------------------------------------------------- critic

    def _critic_source(self) -> Tuple[Qwen25VLConfig, Optional[str]]:
        """The critic's own architecture and the directory its weights load
        from (None: random weights). The actor's architecture when
        ``critic.model.model_path`` is the actor's; else the ``config.json`` of
        that HF directory, or that preset. Its vision tower must be the
        actor's: the vision packs are prepared once per batch."""
        cm = self.config.worker.critic.model
        if not cm.model_path or cm.model_path == self.config.worker.actor.model.model_path:
            return self.model_cfg, None
        weights_dir = cm.model_path if is_hf_checkpoint_dir(cm.model_path) else None
        cfg = config_from_hf_json(weights_dir) if weights_dir else get_config(cm.model_path)
        if cfg.vision != self.model_cfg.vision:
            raise ValueError(
                f"critic.model.model_path={cm.model_path!r} has a different vision tower than "
                "the actor: vision packs are prepared once per batch with the actor's layout -- "
                "pick a critic from the same vision family"
            )
        return cfg, weights_dir

    def _build_critic(self) -> None:
        """The critic's weights (``critic.model.param_dtype``; a random backbone
        from ``trainer.seed + 1`` unless ``critic.model.model_path`` is an HF
        directory other than the actor's), its own AdamW from ``critic.optim``
        with the moments allocated now, and its update function."""
        critic_cfg = self.config.worker.critic
        dtype = getattr(torch, critic_cfg.model.param_dtype)
        generator = torch.Generator(device=self.device).manual_seed(self.config.trainer.seed + 1)
        # the critic's backbone is TP-local as the actor is: this rank's shard of the HF
        # checkpoint, or of the random backbone (drawn whole: every layout holds one model)
        if self._critic_weights_dir:
            backbone = load_params(self._critic_weights_dir, device=self.device, dtype=dtype, tp=self.tp)
        else:
            backbone = init_params(self.critic_model_cfg, generator, device=self.device, dtype=dtype)
            if self.tp is not None:
                backbone = tp_local(backbone, self.tp)
        self.critic = Critic(backbone, generator)
        del backbone
        if self.mesh is not None:
            shard_model(self.critic, self.mesh)
        opt = critic_cfg.optim
        self.critic_optimizer = make_optimizer(
            opt.lr, weight_decay=opt.weight_decay, betas=tuple(opt.betas),
            warmup_steps=int(opt.lr_warmup_ratio * max(opt.training_steps, 0)),
            strategy=opt.strategy, use_kahan_summation=opt.use_kahan_summation,
        )
        self.critic_optimizer.init(trainable_parameters(self.critic))
        sharding = critic_cfg.sharding
        self.critic_update_fn = make_critic_update_fn(
            self.critic, self.critic_optimizer, cliprange_value=critic_cfg.cliprange_value,
            max_grad_norm=critic_cfg.max_grad_norm,
            remat=sharding.remat_policy if sharding.remat else False,
            grad_accum_dtype=getattr(torch, opt.grad_accum_dtype or "float32"),
            groups=self.groups, sp=self.sp,
        )

    def compute_values_batched(self, batch: RolloutBatch) -> np.ndarray:
        return compute_values_batched(
            self.critic, batch,
            micro_batch_size=self.config.worker.critic.micro_batch_size_per_device_for_experience,
            device=self.device, sp=self.sp, lockstep=self.lockstep,
        )

    def update_critic(self, batch: RolloutBatch) -> Dict[str, float]:
        critic = self.config.worker.critic
        return update_critic(
            batch, self.critic_update_fn, self.critic.cfg.vision,
            global_batch_size=self._local_rows(critic.global_batch_size),
            micro_batch_size=critic.micro_batch_size_per_device_for_update,
            ppo_epochs=critic.ppo_epochs, global_step=self.global_step, device=self.device,
            lockstep=self.lockstep,
        )

    # ------------------------------------------------------------------- mesh

    def _setup_mesh(self, mesh=None) -> None:
        """The distributed branch's state, set whenever a process group
        exists (``mesh`` None otherwise): the mesh (``parallel/mesh.py``; the
        one given, from ``run_mesh``, or a new one), the sharded policy, the
        sp spec and the groups the update reduces over, with the JAX
        trainer's checks. Under TP the policy given is cut to this rank's
        shard, unless it is one already (``main.build_model`` loads an HF
        checkpoint so, on the given mesh's ``model`` group)."""
        config, model = self.config, self.model
        self.mesh = self.sp = self.groups = self.tp = self.rollout_tp = None
        self.lockstep = Lockstep()
        self.world, self.rank, self.batch_ranks, self.batch_index = 1, 0, 1, 0
        n_chips = config.trainer.n_chips
        if not dist.is_initialized():
            if config.worker.actor.sharding.model_size > 1:
                raise ValueError(
                    f"sharding.model_size={config.worker.actor.sharding.model_size} needs that many "
                    "ranks (tensor or sequence parallelism over a process group): launch them with "
                    "torchrun, or set model_size=1")
            if n_chips > 1:
                raise ValueError(
                    f"trainer.n_chips={n_chips} but this process has no process group: launch "
                    f"one rank per GPU (torchrun --nproc_per_node={n_chips} -m "
                    "spatialthinker_torch.trainer.main ...), or set trainer.n_chips=1")
            return
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        actor = config.worker.actor
        sp_size = actor.ulysses_sequence_parallel_size
        kv_heads = self.model_cfg.text.num_key_value_heads
        self.mesh = mesh if mesh is not None else run_mesh(config, kv_heads, self.device.type)
        if tensor_parallel_size(config) > 1:
            if model.tp is None:
                self.tp = TPSpec(tp_group(self.mesh))
                self.model = model = tp_local(model, self.tp)
            elif model.tp.group is tp_group(self.mesh):
                self.tp = model.tp
            else:
                raise ValueError("the policy is a TP shard on another group than this mesh's model group: "
                                 "build it on the mesh the trainer is given (trainer.main.run)")
        self.groups = DistGroups(batch=batch_group(self.mesh), norm=norm_group(self.mesh, self.tp is not None),
                                 tp=None if self.tp is None else self.tp.group)
        self.batch_ranks = dist.get_world_size(self.groups.batch)
        self.batch_index = batch_rank(self.mesh)
        if sp_size > 1:
            self.sp = UlyssesSpec(sp_group(self.mesh), self.groups.batch, actor.sequence_parallel_backend)
            if config.worker.rollout.tensor_parallel_size > 1:  # the model group decodes its rows together
                self.rollout_tp = TPSpec(sp_group(self.mesh))
        self.lockstep = Lockstep(dist.group.WORLD)
        shard_model(model, self.mesh)

    def _local_rows(self, global_rows: int) -> int:
        """A global row count (``global_batch_size``) as this rank's share."""
        return max(global_rows // self.batch_ranks, 1)

    def _sharded_policy(self, shards: Dict[str, torch.Tensor]) -> Qwen25VL:
        """A second sharded policy (the reference) holding ``shards`` (this
        rank's pieces, on the card or the host), frozen."""
        ref = Qwen25VL(self.model_cfg, device="meta", dtype=self.model.text.norm.weight.dtype, tp=self.tp)
        shard_model(ref, self.mesh)
        ref.to_empty(device=self.device)
        with torch.no_grad():
            for name, p in ref.named_parameters():
                local(p).copy_(shards[name])
        return ref.requires_grad_(False)

    # ------------------------------------------------------------------ utils

    def _paged_pool_size(self, page_size: int, kv_dtype) -> int:
        """KV page-pool size from the card's free memory x
        ``gpu_memory_utilization`` (vLLM sizes its cache the same way). On the
        CPU (tests) it returns 0 and the engine sizes for the worst case.

        Computed once, at the first rollout, and cached: by then everything a
        run keeps resident (policy, reference copy, moments, the int8 rollout
        copy) is resident, and a pool that changed from step to step would
        make steps differ in what they can admit. What lives on the host (an
        offloaded reference copy, streamed or offloaded moments) is not on
        the card then, so the pool gets that room, as the JAX trainer's
        estimate leaves host-resident trees out."""
        override = self.config.worker.rollout.kv_pages_override
        if override > 0:  # vLLM num_gpu_blocks_override parity
            return override
        if self._paged_pool_cache is None:
            pages = self._paged_pool_size_uncached(page_size, kv_dtype)
            tp = self.tp or self.rollout_tp
            if tp is not None:  # one engine a TP group: every rank admits alike
                pages = -Lockstep(tp.group).max(-pages)
            self._paged_pool_cache = pages
        return self._paged_pool_cache

    def _paged_pool_size_uncached(self, page_size: int, kv_dtype) -> int:
        if self.device.type != "cuda":
            return 0
        # the caching allocator holds freed blocks, which ``mem_get_info`` counts as
        # used: hand them back before asking what is free
        torch.cuda.empty_cache()
        free_now, total = torch.cuda.mem_get_info(self.device)
        t = self.model_cfg.text
        heads = t.num_key_value_heads // tp_size(self.tp or self.rollout_tp)  # this rank's pools
        elem = {torch.int8: 1.0, torch.uint8: 0.5}.get(kv_dtype, 2.0)  # uint8 = packed int4
        cell = int(2 * t.num_hidden_layers * heads * t.head_dim * elem)
        if elem < 2:  # bf16 scales per (k, v) token-head in both quantized formats
            cell += 2 * t.num_hidden_layers * heads * 2
        roll = self.config.worker.rollout
        slots = roll.decode_batch_size if roll.decode_batch_size > 0 else 32
        u = max(slots // max(roll.n, 1), 1)
        if roll.refill_batch > 0:
            u = min(u, roll.refill_batch)
        # room for a refill prefill's transients (scratch prompt KV and the
        # activations of the rows in flight)
        transient = prefill_transient_bytes(
            self.model_cfg, self.config.data.max_prompt_length, u, roll.prefill_rows, cell,
        )
        in_use = total - free_now
        free = int(total * roll.gpu_memory_utilization) - in_use - transient
        return max(free // (cell * page_size), 0)

    def _rollout_generator(self, tag: int, index: int = 0) -> torch.Generator:
        """Deterministic rollout sampling stream, keyed by (rollout.seed,
        global_step, stage tag, batch index) and stateless, so a resumed run
        samples as the first one did. Tags: 0 train rollout, 1 remax
        baseline, 2 validation."""
        seed = self.config.worker.rollout.seed
        for part in (self.global_step, tag, index):
            seed = (seed * 1_000_003 + part) % (2**63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- generation

    def generate_sequences(self, batch: RolloutBatch, sampling: SamplingParams,
                           generator: Optional[torch.Generator] = None) -> RolloutBatch:
        """Decode n samples per prompt, attach responses + masks + full seqs.
        ``rollout.name`` picks the engine: ``jax`` the dense one,
        ``continuous`` the continuous one (``page_size`` 0) or the paged one
        (``page_size`` > 0), with ``decode_batch_size`` slots (``min(rows,
        32)`` when it is 0 or less). Every engine prefills each unique prompt
        once; the host-side tensors are repeated to match the [prompt0 x n,
        ...] row order. (The JAX trainer's per-sample prefill exists for
        meshes whose batch axis does not divide the unique prompts; one device
        always groups.) On several GPUs each rank runs its own engine on its
        own prompts over a gathered copy of the weights (``unsharded_copy``;
        the JAX trainer's lockstep engines over one global queue and a page
        pool sharded over pages exist because XLA runs one program over every
        device); greedy rows are the same either way. Under tensor parallelism
        the ranks of a TP group run one engine on the same prompts over their
        shards (``tp_rollout_copy``; the module docstring)."""
        n = sampling.n
        generator = generator if generator is not None else self._rollout_generator(0)
        self._last_rollout_stats = {}  # per-rollout telemetry, never stale
        if self.device.type == "cuda":
            # the update's cached blocks do not fit the rollout's (one pool is
            # gigabytes in one piece): hand them back instead of growing
            torch.cuda.empty_cache()
        roll = self.config.worker.rollout
        # the rollout copy follows the knobs as they stand at this rollout
        # (W8A8, or W8A8 + int4 MLP decode copies), quantized anew each time:
        # the optimizer just rewrote the weights
        if self.tp is not None or self.rollout_tp is not None:
            gen_model = tp_rollout_copy(self.model, self.rollout_tp)
        else:
            gen_model = self.model if self.mesh is None else unsharded_copy(self.model)
        own = None
        if self.rollout_tp is not None:  # beside sp: the model group decodes the union of its prompts
            parts = allgather_pyobj(batch, self.rollout_tp.group)
            start = sum(len(p) for p in parts[:self.rollout_tp.rank])
            own = slice(start * n, (start + len(batch)) * n)
            batch = self._concat(parts)
        if roll.quantization != "none":
            gen_model = quantize_model(gen_model, mode=roll.quantization,
                                       prefill_dequant_min_m=self.prefill_dequant_min_m)
        self.rollout_copy_bytes = rollout_bytes(gen_model)
        # one prompt width on every rank: the sp group shares its rows later
        base = trim_prompt_padding(
            batch, negotiated_max=self.lockstep.max(int(batch.tensors["segment_ids"].sum(-1).max())))
        repeated = base.repeat(n, interleave=True) if n > 1 else base

        kv_dtype = KV_CACHE_DTYPES[roll.kv_cache_dtype]
        base_pos = np.transpose(base.tensors["position_ids"], (1, 0, 2))  # (3, B, P)
        if roll.name == "continuous":
            slots = roll.decode_batch_size
            common = dict(
                max_new_tokens=roll.response_length,
                sampling=sampling.override(n=1),
                generator=generator,
                slots=slots if slots > 0 else min(len(repeated), 32),
                patches_list=list(base.non_tensors["patches"]),
                grids_list=list(base.non_tensors["image_grid_thw"]),
                kv_cache_dtype=kv_dtype,
                prefill_chunk_size=roll.prefill_chunk_size,
                max_num_batched_tokens=roll.max_num_batched_tokens,
                prefill_rows=roll.prefill_rows,
                refill_batch=roll.refill_batch,
                group_n=n,
                int4_i8dot=roll.int4_i8dot,
            )
            args = (gen_model, base.tensors["input_ids"], base.tensors["segment_ids"], base_pos,
                    base.tensors["gen_pos_start"])
            if roll.page_size > 0:
                result = generate_paged(
                    *args, **common, page_size=roll.page_size,
                    total_pages=self._paged_pool_size(roll.page_size, kv_dtype),
                )
                self._last_rollout_stats = {
                    f"rollout/kv_{k}": float(v) for k, v in result.stats.items()
                }
            else:  # the continuous engine (its stats stay out of the logged metrics, as in JAX)
                result = generate_continuous(*args, **common)
        else:
            rows = roll.prefill_rows
            if not (0 < rows < len(base)):
                rows = 0  # inert (rows >= batch): keep the sequence-chunk bound
            vision = vision_to_device(_pack_vision(base, self.model_cfg.vision), self.device)
            dev = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=self.device)  # noqa: E731
            result = generate(
                gen_model,
                dev(base.tensors["input_ids"]).long(),
                dev(base.tensors["segment_ids"]),
                dev(base_pos).long(),
                dev(base.tensors["gen_pos_start"]),
                max_new_tokens=roll.response_length,
                sampling=sampling.override(n=1),
                generator=generator,
                vision=vision,
                kv_cache_dtype=kv_dtype,
                # rows mode composes with sequence chunking (the token budget
                # binds within a row group), so the chunk is computed against
                # the rows actually in flight
                prefill_chunk=effective_prefill_chunk(
                    base.tensors["input_ids"].shape[1], rows if rows else len(base),
                    roll.prefill_chunk_size, roll.max_num_batched_tokens,
                ),
                prefill_rows=rows,
                n=n,
                int4_i8dot=roll.int4_i8dot,
            )
        out = rollout_batch_from_result(
            repeated, _to_numpy(result.responses), _to_numpy(result.response_mask),
            _to_numpy(result.rollout_log_probs),
        )
        if own is not None:  # this rank's rows back ([prompt0 x n, ...]: its prompts' rows are contiguous)
            out = out.select(own)
        # the quantized copy (int4 copies included), the cache or the pools
        # go before the log-prob and update forwards need the room
        del gen_model, result
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    # -------------------------------------------------------------- log probs

    def compute_log_probs_batched(self, batch: RolloutBatch, model: Qwen25VL) -> np.ndarray:
        return compute_log_probs_batched(
            model, batch,
            micro_batch_size=self.config.worker.actor.micro_batch_size_per_device_for_experience,
            padding_free=self.padding_free, temperature=self.config.worker.rollout.temperature,
            device=self.device, sp=self.sp, lockstep=self.lockstep,
        )

    def compute_advantages(self, batch: RolloutBatch) -> Tuple[np.ndarray, np.ndarray]:
        algo = self.config.algorithm
        return compute_advantages(batch, self.adv_estimator, gamma=algo.gamma, lam=algo.lam)

    def update_actor(self, batch: RolloutBatch) -> Dict[str, float]:
        if not self.offload_opt:
            return self._update_actor_inner(batch)
        host = self.optimizer.state
        self.optimizer.state = restore_from_host(host)
        try:
            return self._update_actor_inner(batch)
        finally:
            self.optimizer.state = offload_to_host(self.optimizer.state, into=host)

    def _update_actor_inner(self, batch: RolloutBatch) -> Dict[str, float]:
        actor = self.config.worker.actor
        common = dict(global_batch_size=self._local_rows(actor.global_batch_size),
                      ppo_epochs=actor.ppo_epochs, global_step=self.global_step, device=self.device,
                      lockstep=self.lockstep)
        if self.padding_free:
            metrics = update_actor_packed(
                batch, self.packed_update_fn, self.model_cfg.vision,
                micro_rows=actor.micro_batch_size_per_device_for_update, **common)
        else:
            metrics = update_actor(
                batch, self.update_fn, self.model_cfg.vision,
                micro_batch_size=actor.micro_batch_size_per_device_for_update, **common)
        if self.stream_opt:
            self.host_state_stats.update(
                apply_s=self.optimizer.last_apply_s,
                apply_bytes_each_way=self.optimizer.last_apply_stats.get("measured_bytes", 0))
        return metrics

    def ref_policy(self) -> Qwen25VL:
        """The reference policy on the card. An offloaded one is restored
        into a new module for this call; the caller drops it afterwards."""
        if self.ref_host is None:
            return self.ref_model
        t0 = time.perf_counter()
        if self.mesh is not None:
            ref = self._sharded_policy(host_view(self.ref_host))
        else:
            ref = Qwen25VL(self.model_cfg, device="meta", dtype=self.model.text.norm.weight.dtype)
            ref.load_state_dict(restore_from_host(self.ref_host), assign=True)
        self.host_state_stats.update(ref_restore_s=time.perf_counter() - t0,
                                     ref_restore_bytes=host_bytes(self.ref_host))
        return ref.requires_grad_(False)

    # ------------------------------------------------------------------- fit

    def fit(self):
        cfg = self.config
        total_steps = cfg.trainer.max_steps if cfg.trainer.max_steps > 0 else (
            len(self.train_dataloader) * cfg.trainer.total_episodes
        )
        self.load_checkpoint()

        if cfg.trainer.val_before_train and self.val_dataloader is not None:
            val_metrics = self._validate()
            self.tracker.log(val_metrics, self.global_step)
            if cfg.trainer.val_only:
                return

        for _ in range(cfg.trainer.total_episodes):
            for batch in self.train_dataloader:
                if self.global_step >= total_steps:
                    break
                self.global_step += 1
                with maybe_trace(cfg.trainer.profile_dir, self.global_step,
                                 tuple(cfg.trainer.profile_steps)):
                    metrics = self.train_step(batch)
                self.tracker.log(metrics, self.global_step)

                if cfg.trainer.val_freq > 0 and self.global_step % cfg.trainer.val_freq == 0 \
                        and self.val_dataloader is not None:
                    self.tracker.log(self._validate(), self.global_step)
                if cfg.trainer.save_freq > 0 and self.global_step % cfg.trainer.save_freq == 0:
                    self.save_checkpoint()
            if self.global_step >= total_steps:
                break

        # final validation + save (parity with the reference's end-of-training block)
        if cfg.trainer.val_freq > 0 and self.val_dataloader is not None:
            self.tracker.log(self._validate(), self.global_step)
        if cfg.trainer.save_freq > 0:
            self.save_checkpoint()
        self.tracker.finish()

    # ------------------------------------------------------------- train step

    def train_step(self, batch: RolloutBatch) -> Dict[str, float]:
        timer = Timer()
        roll = self.config.worker.rollout
        with timer("step"):
            # uid per prompt BEFORE repeat: grouping survives any reordering
            batch.non_tensors["uid"] = _obj([str(uuid.uuid4()) for _ in range(len(batch))])

            with timer("gen"):
                rolled = self.generate_sequences(batch, self.sampling)

            if self.adv_estimator == "remax":
                with timer("gen_baseline"):
                    greedy = self.generate_sequences(
                        batch, self.sampling.override(temperature=0.0, n=1),
                        generator=self._rollout_generator(1),
                    )
                    base_rewards, _ = self.reward_fn(greedy)
                    baselines = base_rewards.sum(-1)
                    rolled.tensors["reward_baselines"] = np.repeat(baselines, self.sampling.n, axis=0)

            with timer("reward"):
                reward_tensor, reward_metrics = self.reward_fn(rolled)
                rolled.tensors["token_level_scores"] = reward_tensor
                reward_metrics = self._gather_lists(reward_metrics)

            # trim the response buffer to the batch's longest response
            # (bucketed): most rollouts hit EOS early, so the log-prob and
            # update forwards see far fewer padded positions
            rolled = trim_response_padding(
                rolled, negotiated_max=self.lockstep.max(int(rolled.tensors["response_mask"].sum(-1).max())))
            rolled = self._share_sp(rolled)

            with timer("balance"):
                # Karmarkar-Karp token-load balance across micro-batch slots
                # (grouping correctness survives the reorder via uid keys)
                seqlens = rolled.tensors["full_segment_ids"].sum(-1).astype(np.int64).tolist()
                micro = self.config.worker.actor.micro_batch_size_per_device_for_update
                n_slots = max(len(rolled) // max(micro, 1), 1)
                if n_slots > 1 and len(rolled) % n_slots == 0:
                    rolled.reorder(np.asarray(balance_order(seqlens, n_slots)))

            with timer("old"):
                if roll.use_rollout_log_probs:
                    rolled.tensors["old_log_probs"] = rolled.tensors["rollout_log_probs"]
                else:
                    rolled.tensors["old_log_probs"] = self.compute_log_probs_batched(rolled, self.model)

            if self.use_ref:
                with timer("ref"):
                    ref_model = self.ref_policy()
                    rolled.tensors["ref_log_probs"] = self.compute_log_probs_batched(
                        rolled, ref_model)
                    del ref_model  # an offloaded reference leaves the card until the next step

            if self.use_critic:
                with timer("values"):
                    rolled.tensors["values"] = self.compute_values_batched(rolled)

            with timer("adv"):
                # on the union of the ranks' rows (whitening and the KL
                # controller read batch statistics); this rank keeps its rows
                kld = None
                if self.use_kl_in_reward and self.use_ref:
                    kld = compute_kl(
                        torch.as_tensor(rolled.tensors["old_log_probs"]),
                        torch.as_tensor(rolled.tensors["ref_log_probs"]),
                        self.config.algorithm.kl_penalty,
                    ).numpy() * rolled.tensors["response_mask"]
                    rolled.tensors["token_level_rewards"] = (
                        rolled.tensors["token_level_scores"] - self.kl_ctrl.kl_coef * kld
                    )
                else:
                    rolled.tensors["token_level_rewards"] = rolled.tensors["token_level_scores"]
                glob = self._global_rows(rolled, **({} if kld is None else {"kld": kld}))
                if kld is not None:
                    kld, mask = glob.tensors["kld"], glob.tensors["response_mask"]
                    self.kl_ctrl.update(float((kld.sum(-1) / np.maximum(mask.sum(-1), 1)).mean()), len(glob))
                adv, ret = self.compute_advantages(glob)
                rows = self._own_rows(len(rolled))
                rolled.tensors["advantages"] = adv[rows]
                rolled.tensors["returns"] = ret[rows]

            critic_metrics: Dict[str, float] = {}
            if self.use_critic:
                with timer("update_critic"):
                    # the critic's gradient accumulator lives inside this call
                    # only: it is freed before the actor's is allocated
                    critic_metrics = self.update_critic(rolled)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)

            warmup = self.config.trainer.critic_warmup
            if self.use_critic and warmup > 0 and self.global_step <= warmup:
                actor_metrics = {}  # critic warmup: the policy does not move
                timer.timing["update_actor"] = 1e-9
            else:
                with timer("update_actor"):
                    actor_metrics = self.update_actor(rolled)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)

        # the logged numbers are the union of the ranks' rows, as JAX's global arrays
        patches = [0 if p is None else len(p) for p in rolled.non_tensors.get("patches", [])]
        rolled = self._global_rows(rolled, patch_count=np.asarray(patches or [0] * len(rolled)))
        num_tokens = int(rolled.tensors["response_mask"].sum() + rolled.tensors["segment_ids"].sum())
        seqlens_all = rolled.tensors["full_segment_ids"].sum(-1).astype(np.int64).tolist()
        vision_patches = float(rolled.tensors["patch_count"].sum())
        mfu = compute_mfu(
            self.flops_counter, seqlens_all, timer.timing["update_actor"], self.world,
            self.config.worker.actor.ppo_epochs, vision_patches=vision_patches,
        )
        drift = not roll.use_rollout_log_probs and "rollout_log_probs" in rolled.tensors
        return {
            "perf/mfu_actor": mfu,
            **self._last_rollout_stats,  # paged-KV telemetry (peak pages, preemptions)
            **device_memory_metrics(self.device),
            **{f"reward/{k}": float(np.mean(v)) for k, v in reward_metrics.items()},
            **compute_data_metrics(
                token_level_scores=rolled.tensors["token_level_scores"],
                token_level_rewards=rolled.tensors["token_level_rewards"],
                advantages=rolled.tensors["advantages"],
                returns=rolled.tensors["returns"],
                response_mask=rolled.tensors["response_mask"],
                prompt_mask=rolled.tensors["segment_ids"],
                max_response_length=self.config.data.max_response_length,
                max_prompt_length=self.config.data.max_prompt_length,
                values=rolled.tensors.get("values"),
                old_log_probs=rolled.tensors["old_log_probs"] if drift else None,
                rollout_log_probs=rolled.tensors["rollout_log_probs"] if drift else None,
            ),
            **actor_metrics,
            **critic_metrics,
            **compute_timing_metrics(timer.timing, num_tokens),
            **compute_throughput_metrics(num_tokens, timer.timing["step"], self.world),
        }

    # ------------------------------------------------------- rows across ranks

    def _rows_group(self):
        """The ranks holding other rows: every rank, or the batch group under
        TP (a TP group holds the same rows)."""
        return None if self.tp is None else self.groups.batch

    def _gather_lists(self, metrics: Dict[str, list]) -> Dict[str, list]:
        """Per-row metric lists of every rank, concatenated (one process: as
        they are)."""
        if self.mesh is None:
            return metrics
        parts = allgather_pyobj(metrics, self._rows_group())
        return {k: [x for part in parts for x in np.asarray(part[k]).tolist()] for k in metrics}

    @staticmethod
    def _concat(parts: List[RolloutBatch]) -> RolloutBatch:
        return RolloutBatch(
            tensors={k: np.concatenate([p.tensors[k] for p in parts]) for k in parts[0].tensors},
            non_tensors={k: _obj([x for p in parts for x in p.non_tensors[k]]) for k in parts[0].non_tensors},
            meta=parts[0].meta,
        )

    def _share_sp(self, rolled: RolloutBatch) -> RolloutBatch:
        """The rows of the whole sp group (each rank rolled out its own
        prompts), in sp-rank order: the ranks of an sp group hold the same
        rows from here on and split their sequence."""
        if self.sp is None:
            return rolled
        return self._concat(allgather_pyobj(rolled, self.sp.group))

    def _global_rows(self, rolled: RolloutBatch, **extra) -> RolloutBatch:
        """The union of the batch group's rows (tensors, ``extra`` per-row
        arrays and the uids) in batch-rank order; one process: its own."""
        tensors = {**rolled.tensors, **extra}
        uid = {"uid": rolled.non_tensors["uid"]} if "uid" in rolled.non_tensors else {}
        mine = RolloutBatch(tensors=tensors, non_tensors=uid, meta=rolled.meta)
        if self.mesh is None:
            return mine
        return self._concat(allgather_pyobj(mine, self.groups.batch))

    def _own_rows(self, n: int) -> slice:
        """This rank's rows of ``_global_rows``' result."""
        return slice(self.batch_index * n, (self.batch_index + 1) * n)

    # ------------------------------------------------------------- validation

    def _validate(self) -> Dict[str, float]:
        all_scores: Dict[str, List[float]] = defaultdict(list)
        candidates = []
        for batch_idx, batch in enumerate(self.val_dataloader):
            rolled = self.generate_sequences(
                batch, self.val_sampling, generator=self._rollout_generator(2, batch_idx)
            )
            reward_tensor, metrics = self.val_reward_fn(rolled)
            for k, v in metrics.items():
                all_scores[k].extend(np.asarray(v, dtype=np.float64).tolist())
            lengths = rolled.tensors["response_mask"].sum(-1)
            for i in range(len(rolled)):
                candidates.append(
                    (str(rolled.non_tensors["problem"][i]),
                     rolled.tensors["responses"][i, : lengths[i]],
                     str(rolled.non_tensors["ground_truth"][i]),
                     float(reward_tensor[i].sum()))
                )
        # every rank scored its own rows: the whole validation set's
        all_scores = self._gather_lists(all_scores)
        if self.mesh is not None:
            candidates = [c for part in allgather_pyobj(candidates, self._rows_group()) for c in part]
        # deterministic subsample of the whole validation set (sort by input,
        # fixed-seed shuffle, take N); only the selected rows are decoded
        cap = self.config.trainer.val_generations_to_log
        candidates.sort(key=lambda s: s[0])
        order = np.random.RandomState(42).permutation(len(candidates))[:cap]
        texts = self.tokenizer.batch_decode(
            [candidates[j][1] for j in order], skip_special_tokens=True
        )
        samples = [
            (candidates[j][0], text, candidates[j][2], candidates[j][3])
            for j, text in zip(order, texts)
        ]
        self.tracker.log_generations(samples, self.global_step)
        return {f"val/{k}_reward" if k != "overall" else "val/reward_score": float(np.mean(v))
                for k, v in all_scores.items()}

    # ------------------------------------------------------------ checkpoints

    def save_checkpoint(self):
        """A GAE run nests parameters and optimizer state under ``"actor"``
        and ``"critic"``, as the JAX trainer's checkpoints do. Optimizer state
        on the host (streamed, or offloaded between updates) is written from
        its host copies, in the same layout. On several GPUs every tensor is
        gathered whole and rank 0 writes the same files, so a checkpoint
        resumes on any number of GPUs (``tools/model_merger.py`` reads it
        unchanged)."""
        params = self._full_params(self.model)
        opt_state = self._full_opt_state(self.optimizer.state, self.model)
        if self.use_critic:
            params = {"actor": params, "critic": self._full_params(self.critic)}
            opt_state = {"actor": opt_state,
                         "critic": self._full_opt_state(self.critic_optimizer.state, self.critic)}
        if self.rank == 0:
            self.ckpt.save(
                self.global_step,
                params=params,
                opt_state=opt_state,
                dataloader_state=getattr(self.train_dataloader, "state_dict", lambda: {})(),
                rng_state=self.generator.get_state(),
            )
        if self.mesh is not None:
            dist.barrier()

    def _full_params(self, model) -> Dict[str, torch.Tensor]:
        """The state dict to write: whole tensors (on rank 0, on the host,
        several GPUs)."""
        if self.mesh is None:
            return model.state_dict()
        if self.tp is not None:  # gathered over the TP group too: the HF layout
            return {k: v.cpu() for k, v in full_state(model).items()}
        from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

        return get_model_state_dict(model, options=StateDictOptions(full_state_dict=True, cpu_offload=True))

    def _full_opt_state(self, state, model):
        """An optimizer state to write: each moment of a sharded parameter
        gathered whole, one at a time (rank 0 keeps it on the host)."""
        state = host_view(state)
        if self.mesh is None:
            return state
        params = dict(model.named_parameters())
        out = {"count": state["count"]}
        for kind in ("mu", "nu", "compensation"):
            out[kind] = {}
            for name, shard in state[kind].items():
                whole = gather_leaf(name, full_tensor(shard.to(self.device), params[name]), self.tp)
                if self.rank == 0:
                    out[kind][name] = whole.cpu()
        return out

    def load_checkpoint(self):
        path = self.config.trainer.load_checkpoint_path
        if not path:
            return
        if self.mesh is not None:
            return self._load_checkpoint_sharded(path)
        state = self.ckpt.load(path)
        if state is None:
            return
        params, opt_state = state["params"], state["opt_state"]
        nested = set(params) == {"actor", "critic"}
        if nested != self.use_critic:
            raise ValueError(
                "checkpoint layout does not match this run: a GAE run (algorithm.adv_estimator="
                "gae) saves and loads {'actor', 'critic'}, every other estimator the policy alone"
            )
        if self.use_critic:
            self.critic.load_state_dict(params["critic"], strict=True)
            _load_optimizer_state(self.critic_optimizer.state, opt_state["critic"])
            params, opt_state = params["actor"], opt_state["actor"]
        self.model.load_state_dict(params, strict=True)
        _load_optimizer_state(self.optimizer.state, opt_state)
        self.global_step = state["step"]
        if state.get("dataloader_state") and hasattr(self.train_dataloader, "load_state_dict"):
            self.train_dataloader.load_state_dict(state["dataloader_state"])
        if state.get("rng_state") is not None:
            self.generator.set_state(state["rng_state"])


    def _load_checkpoint_sharded(self, path: str) -> None:
        """``load_checkpoint`` on several GPUs: rank 0 reads the files and
        broadcasts; each rank keeps its pieces."""
        from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict

        state = self.ckpt.load(path) if self.rank == 0 else None
        box = [None if state is None else {k: v for k, v in state.items()
                                            if k not in ("params", "opt_state")}]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return
        params = state["params"] if state is not None else {}
        opt_state = state["opt_state"] if state is not None else {}
        nested = [set(params) == {"actor", "critic"}]
        dist.broadcast_object_list(nested, src=0)
        if nested[0] != self.use_critic:
            raise ValueError(
                "checkpoint layout does not match this run: a GAE run (algorithm.adv_estimator="
                "gae) saves and loads {'actor', 'critic'}, every other estimator the policy alone"
            )
        pairs = [(self.model, self.optimizer, "actor")]
        if self.use_critic:
            pairs.append((self.critic, self.critic_optimizer, "critic"))
        options = StateDictOptions(full_state_dict=True, broadcast_from_rank0=True)
        for model, optimizer, role in pairs:
            p = params.get(role, {}) if self.use_critic else params
            o = opt_state.get(role, {}) if self.use_critic else opt_state
            if self.tp is not None:
                _load_tp_params(model, p, self.device, self.tp)
            else:
                # the broadcast sends a tensor's storage as it lies: make it row-major
                set_model_state_dict(model, {k: v.contiguous() for k, v in p.items()}, options=options)
            _load_sharded_optimizer_state(optimizer.state, o, model, self.device, self.tp)
        self.global_step = box[0]["step"]
        if box[0].get("dataloader_state") and hasattr(self.train_dataloader, "load_state_dict"):
            self.train_dataloader.load_state_dict(box[0]["dataloader_state"])
        if box[0].get("rng_state") is not None:
            self.generator.set_state(box[0]["rng_state"])


@torch.no_grad()
def _load_tp_params(model, saved, device, tp) -> None:
    """A checkpoint's whole parameters (rank 0's ``saved``) into a TP-local
    model: each broadcast and cut to this rank's TP shard and FSDP piece."""
    for name, p in model.named_parameters():
        whole = (saved[name].to(device, p.dtype).contiguous() if saved else
                 torch.empty(_whole_shape(name, p, tp), dtype=p.dtype, device=device))
        dist.broadcast(whole, src=0)
        local(p).copy_(local_piece(whole, p, name, tp))


def _whole_shape(name: str, p, tp) -> Tuple[int, ...]:
    """The whole (HF-layout) shape of a TP-local parameter ``p``."""
    shape = list(p.shape)
    split = split_of(name)
    if split is not None:
        shape[split[0]] *= tp.size
    return tuple(shape)


@torch.no_grad()
def _load_sharded_optimizer_state(mine, saved, model, device, tp=None) -> None:
    """``_load_optimizer_state`` on several GPUs: ``saved`` (whole tensors)
    is rank 0's, each moment broadcast and cut to this rank's piece (its TP
    shard first under ``tp``)."""
    params = dict(model.named_parameters())
    box = [{"count": int(saved["count"]),
            "names": {k: sorted(saved[k]) for k in ("mu", "nu", "compensation")},
            "dtypes": {k: {n: v.dtype for n, v in saved[k].items()}
                       for k in ("mu", "nu", "compensation")}} if saved else None]
    dist.broadcast_object_list(box, src=0)
    meta = box[0]
    mine["count"] = meta["count"]
    for kind in ("mu", "nu", "compensation"):
        if set(meta["names"][kind]) != set(mine[kind]):
            raise ValueError(
                f"checkpoint optimizer state {kind!r} does not match this run's "
                "(another strategy, or a frozen vision tower on one side)"
            )
        for name in meta["names"][kind]:
            target = mine[kind][name]
            target = target.buffer if isinstance(target, HostLeaf) else target
            if meta["dtypes"][kind][name] != target.dtype:
                raise ValueError(
                    f"checkpoint optimizer state {kind!r} is {meta['dtypes'][kind][name]}, this "
                    f"run's is {target.dtype}: saved under another optim.strategy "
                    "(optim.stream keeps bf16 moments)"
                )
            like = params[name]
            shape = like.shape if tp is None else _whole_shape(name, like, tp)
            whole = (saved[kind][name].to(device).contiguous() if saved else
                     torch.empty(shape, dtype=target.dtype, device=device))
            dist.broadcast(whole, src=0)
            target.copy_(local_piece(whole, like, name, tp))


@torch.no_grad()
def _load_optimizer_state(mine, saved) -> None:
    """Copy a checkpoint's AdamW state into an optimizer's own state dict
    ``mine`` (its buffers on the card, or their host copies), the moments
    checked name by name and dtype by dtype."""
    mine["count"] = int(saved["count"])
    for kind in ("mu", "nu", "compensation"):
        if set(saved[kind]) != set(mine[kind]):
            raise ValueError(
                f"checkpoint optimizer state {kind!r} does not match this run's "
                "(another strategy, or a frozen vision tower on one side)"
            )
        for name, value in saved[kind].items():
            target = mine[kind][name]
            target = target.buffer if isinstance(target, HostLeaf) else target
            if value.dtype != target.dtype:
                raise ValueError(
                    f"checkpoint optimizer state {kind!r} is {value.dtype}, this run's is "
                    f"{target.dtype}: saved under another optim.strategy "
                    "(optim.stream keeps bf16 moments)"
                )
            target.copy_(value)


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
