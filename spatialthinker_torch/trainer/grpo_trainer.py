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

Every function takes what the trainer class reads from ``self`` (model,
update function, knobs, device) as explicit arguments. Single process only:
the JAX trainer's cross-process negotiation of row lengths, row counts and
vision widths and its globalized vision packs collapse to the identity here;
they come with the multi-GPU port.
"""

from __future__ import annotations

import copy
import logging
import uuid
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..algos.advantages import (
    compute_gae_advantage_return, compute_grpo_outcome_advantage,
    compute_reinforce_plus_plus_outcome_advantage, compute_remax_outcome_advantage,
    compute_rloo_outcome_advantage,
)
from ..algos.kl_controller import get_kl_controller
from ..algos.losses import compute_kl
from ..core.batch import RolloutBatch, trim_prompt_padding, trim_response_padding
from ..core.config import PPOConfig
from ..data.packing import pack_vision_batch, stack_vision_packs
from ..data.text_packing import (
    PackedRows, SlotMap, gather_response_values, pack_train_rows, pad_rows_to_count,
)
from ..models.qwen2_5_vl.config import VisionConfig
from ..models.qwen2_5_vl.host import VisionInputs
from ..models.qwen2_5_vl.model import Qwen25VL, vision_to_device
from ..models.qwen2_5_vl.params import default_device
from ..ops.quant import quantize_model
from ..rewards.manager import RewardManager
from ..rollout.engine import generate
from ..rollout.continuous import effective_prefill_chunk, generate_continuous
from ..rollout.paged import generate_paged, prefill_transient_bytes
from ..rollout.sampling import SamplingParams
from ..utils.flops_counter import FlopsCounter, compute_mfu
from ..utils.profiling import device_memory_metrics, maybe_trace
from ..utils.seqlen_balancing import balance_order
from .checkpoint import CheckpointManager
from .metrics import (
    Timer, compute_data_metrics, compute_throughput_metrics, compute_timing_metrics,
    reduce_metrics,
)
from .tracker import Tracker
from .train_step import (
    PackedTrainBatch, TrainBatch, compute_log_probs, compute_packed_log_probs, make_optimizer,
    make_packed_update_fn, make_update_fn, trainable_parameters,
)

logger = logging.getLogger(__name__)
KV_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8, "int4": torch.uint8}


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


def _obj(values) -> np.ndarray:
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


class GRPOTrainer:
    """One GRPO/PPO training run on one GPU. ``model`` is the policy (a
    ``Qwen25VL`` on the device the run uses); the trainer updates it in place,
    keeps a frozen copy as the reference policy when the KL term is on, and
    owns the optimizer, the tracker and the checkpoint manager. ``device`` is
    where the model lives (read from its parameters)."""

    def __init__(
        self,
        config: PPOConfig,
        tokenizer,
        model: Qwen25VL,
        train_dataloader,
        val_dataloader=None,
        reward_fn: Optional[RewardManager] = None,
        val_reward_fn: Optional[RewardManager] = None,
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

        algo = config.algorithm
        self.adv_estimator = algo.adv_estimator
        if self.adv_estimator == "gae":
            raise ValueError(
                "algorithm.adv_estimator='gae' needs the critic, which is not ported "
                "(ROADMAP A10); use grpo, rloo, reinforce_plus_plus or remax"
            )
        if config.trainer.n_chips > 1:
            raise ValueError(
                f"trainer.n_chips={config.trainer.n_chips}: the port runs one process on one "
                "GPU; several come with ROADMAP A13 (multi-GPU). Set trainer.n_chips=1"
            )
        if self.adv_estimator in ("grpo", "rloo") and config.worker.rollout.n < 2:
            # group-relative baselines degenerate to zero advantage at n=1:
            # training would silently produce zero gradients
            raise ValueError(
                f"{self.adv_estimator} needs worker.rollout.n > 1 "
                f"(got {config.worker.rollout.n}); group whitening over a "
                "single sample yields identically zero advantages"
            )
        rollout_bs = config.data.rollout_batch_size * config.worker.rollout.n
        gbs = config.worker.actor.global_batch_size
        if rollout_bs % min(gbs, rollout_bs) != 0:
            # iter_minibatches yields full mini-batches only; a non-dividing
            # global_batch_size would silently drop the tail samples every step
            raise ValueError(
                f"rollout_batch_size * n = {rollout_bs} must be divisible by "
                f"worker.actor.global_batch_size = {gbs}"
            )
        roll = config.worker.rollout
        self.use_kl_in_reward = not algo.disable_kl and not algo.use_kl_loss
        self.use_kl_loss = not algo.disable_kl and algo.use_kl_loss
        self.use_ref = not algo.disable_kl
        self.kl_ctrl = get_kl_controller(algo.kl_type, algo.kl_coef, algo.kl_target, algo.kl_horizon)

        # reference policy = a frozen copy of the initial weights (a real
        # copy: the update moves the policy in place)
        self.ref_model = copy.deepcopy(model).requires_grad_(False) if self.use_ref else None

        actor = config.worker.actor
        opt_cfg = actor.optim
        sharding = actor.sharding
        if sharding.remat and sharding.remat_policy == "dots":
            logger.warning(
                "sharding.remat_policy='dots' (save matmul outputs) has no counterpart here: "
                "every decoder layer and vision block keeps its input only and recomputes the "
                "rest in the backward, as remat_policy='full' does"
            )
        update_kwargs = dict(
            clip_ratio_low=actor.clip_ratio_low,
            clip_ratio_high=actor.clip_ratio_high,
            clip_ratio_dual=actor.clip_ratio_dual,
            use_kl_loss=self.use_kl_loss,
            kl_loss_coef=actor.kl_loss_coef,
            kl_penalty=actor.kl_penalty,
            entropy_coeff=actor.entropy_coeff,
            max_grad_norm=actor.max_grad_norm,
            remat=bool(sharding.remat),
            temperature=roll.temperature,
            grad_accum_dtype=getattr(torch, opt_cfg.grad_accum_dtype or "float32"),
        )
        self.optimizer = make_optimizer(
            opt_cfg.lr,
            weight_decay=opt_cfg.weight_decay,
            betas=tuple(opt_cfg.betas),
            warmup_steps=int(opt_cfg.lr_warmup_ratio * max(opt_cfg.training_steps, 0)),
            strategy=opt_cfg.strategy,
            use_kahan_summation=opt_cfg.use_kahan_summation,
        )
        # moments allocated now: the paged engine's pool is sized from what is
        # free once everything a run keeps resident is resident
        self.optimizer.init(trainable_parameters(model, actor.model.freeze_vision_tower))
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

        self.sampling = SamplingParams(
            temperature=roll.temperature, top_p=roll.top_p, top_k=roll.top_k, n=roll.n,
        )
        vo = roll.val_override_config
        self.val_sampling = self.sampling.override(
            temperature=vo.temperature, top_p=vo.top_p, top_k=vo.top_k, n=vo.n
        )

        self.tracker = Tracker(
            config.trainer.logger, config.trainer.project_name, config.trainer.experiment_name,
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

    # ------------------------------------------------------------------ utils

    def _paged_pool_size(self, page_size: int, kv_dtype) -> int:
        """KV page-pool size from the card's free memory x
        ``gpu_memory_utilization`` (vLLM sizes its cache the same way). On the
        CPU (tests) it returns 0 and the engine sizes for the worst case.

        Computed once, at the first rollout, and cached: by then everything a
        run keeps resident (policy, reference copy, moments, the int8 rollout
        copy) is resident, and a pool that changed from step to step would
        make steps differ in what they can admit."""
        override = self.config.worker.rollout.kv_pages_override
        if override > 0:  # vLLM num_gpu_blocks_override parity
            return override
        if self._paged_pool_cache is None:
            self._paged_pool_cache = self._paged_pool_size_uncached(page_size, kv_dtype)
        return self._paged_pool_cache

    def _paged_pool_size_uncached(self, page_size: int, kv_dtype) -> int:
        if self.device.type != "cuda":
            return 0
        # the caching allocator holds freed blocks, which ``mem_get_info`` counts as
        # used: hand them back before asking what is free
        torch.cuda.empty_cache()
        free_now, total = torch.cuda.mem_get_info(self.device)
        t = self.model_cfg.text
        elem = {torch.int8: 1.0, torch.uint8: 0.5}.get(kv_dtype, 2.0)  # uint8 = packed int4
        cell = int(2 * t.num_hidden_layers * t.num_key_value_heads * t.head_dim * elem)
        if elem < 2:  # bf16 scales per (k, v) token-head in both quantized formats
            cell += 2 * t.num_hidden_layers * t.num_key_value_heads * 2
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
        always groups.)"""
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
        gen_model = self.model
        if roll.quantization != "none":
            gen_model = quantize_model(self.model, mode=roll.quantization)
        base = trim_prompt_padding(batch)
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
            device=self.device,
        )

    def compute_advantages(self, batch: RolloutBatch) -> Tuple[np.ndarray, np.ndarray]:
        algo = self.config.algorithm
        return compute_advantages(batch, self.adv_estimator, gamma=algo.gamma, lam=algo.lam)

    def update_actor(self, batch: RolloutBatch) -> Dict[str, float]:
        actor = self.config.worker.actor
        common = dict(global_batch_size=actor.global_batch_size, ppo_epochs=actor.ppo_epochs,
                      global_step=self.global_step, device=self.device)
        if self.padding_free:
            return update_actor_packed(
                batch, self.packed_update_fn, self.model_cfg.vision,
                micro_rows=actor.micro_batch_size_per_device_for_update, **common)
        return update_actor(
            batch, self.update_fn, self.model_cfg.vision,
            micro_batch_size=actor.micro_batch_size_per_device_for_update, **common)

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

            # trim the response buffer to the batch's longest response
            # (bucketed): most rollouts hit EOS early, so the log-prob and
            # update forwards see far fewer padded positions
            rolled = trim_response_padding(rolled)

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
                    rolled.tensors["ref_log_probs"] = self.compute_log_probs_batched(
                        rolled, self.ref_model)

            with timer("adv"):
                if self.use_kl_in_reward and self.use_ref:
                    kld = compute_kl(
                        torch.as_tensor(rolled.tensors["old_log_probs"]),
                        torch.as_tensor(rolled.tensors["ref_log_probs"]),
                        self.config.algorithm.kl_penalty,
                    ).numpy() * rolled.tensors["response_mask"]
                    rolled.tensors["token_level_rewards"] = (
                        rolled.tensors["token_level_scores"] - self.kl_ctrl.kl_coef * kld
                    )
                    mean_kl = float(
                        (kld.sum(-1) / np.maximum(rolled.tensors["response_mask"].sum(-1), 1)).mean()
                    )
                    self.kl_ctrl.update(mean_kl, len(rolled))
                else:
                    rolled.tensors["token_level_rewards"] = rolled.tensors["token_level_scores"]
                adv, ret = self.compute_advantages(rolled)
                rolled.tensors["advantages"] = adv
                rolled.tensors["returns"] = ret

            with timer("update_actor"):
                actor_metrics = self.update_actor(rolled)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

        num_tokens = int(rolled.tensors["response_mask"].sum() + rolled.tensors["segment_ids"].sum())
        seqlens_all = rolled.tensors["full_segment_ids"].sum(-1).astype(np.int64).tolist()
        vision_patches = float(sum(
            0 if p is None else len(p) for p in rolled.non_tensors.get("patches", [])
        ))
        mfu = compute_mfu(
            self.flops_counter, seqlens_all, timer.timing["update_actor"], 1,
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
                old_log_probs=rolled.tensors["old_log_probs"] if drift else None,
                rollout_log_probs=rolled.tensors["rollout_log_probs"] if drift else None,
            ),
            **actor_metrics,
            **compute_timing_metrics(timer.timing, num_tokens),
            **compute_throughput_metrics(num_tokens, timer.timing["step"], 1),
        }

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
        self.ckpt.save(
            self.global_step,
            params=self.model.state_dict(),
            opt_state=self.optimizer.state,
            dataloader_state=getattr(self.train_dataloader, "state_dict", lambda: {})(),
            rng_state=self.generator.get_state(),
        )

    def load_checkpoint(self):
        path = self.config.trainer.load_checkpoint_path
        if not path:
            return
        state = self.ckpt.load(path)
        if state is None:
            return
        self.model.load_state_dict(state["params"], strict=True)
        saved = state["opt_state"]
        mine = self.optimizer.state
        mine["count"] = int(saved["count"])
        with torch.no_grad():
            for kind in ("mu", "nu", "compensation"):
                if set(saved[kind]) != set(mine[kind]):
                    raise ValueError(
                        f"checkpoint optimizer state {kind!r} does not match this run's "
                        "(another strategy, or a frozen vision tower on one side)"
                    )
                for name, value in saved[kind].items():
                    mine[kind][name].copy_(value)
        self.global_step = state["step"]
        if state.get("dataloader_state") and hasattr(self.train_dataloader, "load_state_dict"):
            self.train_dataloader.load_state_dict(state["dataloader_state"])
        if state.get("rng_state") is not None:
            self.generator.set_state(state["rng_state"])


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
