#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``spatialthinker_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc (every kernel is CUDA C++ from
``spatialthinker_torch/csrc``; no Triton is imported on any path); exits
non-zero without a device. In order:

1. prints the card's ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``spatialthinker_torch/csrc`` (prints seconds);
3. holds every kernel against its plain PyTorch version on the card at the
   shapes the paths below give it (max abs error against a stated limit,
   median CUDA-event times of both), computes each kernel's bound (the least
   time the card could take: bytes over the memory rate or operations over
   the peak rate, whichever is larger) and, for the flash and dense-decode
   kernels, times ``F.scaled_dot_product_attention`` with the equivalent
   mask as a yardstick (used nowhere in the port; for the quantized dense
   caches on the dequantized cache); the dense decode kernel's lines (bf16,
   int8, int4, int4 with int8 dots; the quantized ones also the kernel's
   µs a call queued back to back), every paged kernel's (bf16, int8, int4,
   int4 with int8 dots, each also at the shipped scale of ``paged_cases.py``,
   and the staged block) and the silu junction's print the call's plan and fail unless two
   more calls agree bit for bit (the silu lines also print whether the kernel
   equals its plain version bit for bit); the flash forward (its range launch
   and the kernel, one call: both counted, the range tables held against
   ``tile_ranges``) and the
   flash backward (pre-pass, dQ, dK/dV) are held against ``flash_fwd_plain``,
   ``flash_bwd_prep_plain`` and ``flash_bwd_plain`` on hand-made segment ids
   of the training path's three attention forms here and, after path d, on
   the segment ids its first micro-batch gave them (packed text rows, the
   vision pack of that micro-batch's images as one sequence and as windows)
   and on the inputs of its first log-prob vision call (``record_call``: the
   16 images of a piece as one sequence),
   timed beside SDPA and its backward, with the share of tile pairs each
   direction runs and two backward calls that must agree bit for bit; the int4 MLP kernels (gate_up + silu, down) at m = 136,
   128 and 8 rows of the 3B widths, timed beside ``torch._int_mm`` on the
   int8 copy of the same weights (a yardstick: no PyTorch call computes the
   int4 function), and one 3B MLP at m = 256, where the eligibility rule
   refuses the down kernel, taking the int8 path with neither kernel launched;
   the fused W8A8 kernel at the five 3B linears (qkv, o, gate_up, down, the
   tied head with fp32 logits) and m = 65, 129, 136, 1,024 and 4,096 rows,
   which must equal the plain chain bit for bit, timed beside
   ``torch._int_mm`` alone on the pre-quantized x (the library call for the
   dot), each case's plan (``w8a8_plan``: regime, tile, splits of K, ring
   depth, CTAs) printed beside it;
4. drives eleven paths at full Qwen2.5-VL-3B width (path k at 7B) with seeded random weights
   made on the device, each with the kernels' launch counts set to 0 just
   before and read just after, and with the plain versions forbidden:
   a. the dense engine (bf16): 4 image requests through
      ``TorchProvider.generate`` (greedy), then a sampled n=5 call;
   b. the shipped paged engine: ``quantize_model`` (W8A8), then
      ``generate_paged`` on 16 image requests x ``group_n`` 8 with int4 pools,
      ``int4_i8dot``, rows-mode + sequence-chunked prefill, shared prompt
      pages, a finite page pool and fewer slots than lanes (sampled, T=1);
   c. the paged engine with bf16 weights and bf16 pools (greedy);
   h. path b's configuration with ``fuse_staged=True``: the staging ring
      attended inside the paged kernel (its staged block), beside path b's
      decode rate; then greedy fused runs with bf16 (path c's configuration),
      int8 and int4 (no int8 dots) pools;
   then d. the training path: one GRPO step through the functions of
      ``spatialthinker_torch/trainer/grpo_trainer.py``, at 3B widths with
      ``TRAIN_LAYERS`` of the 36 text layers and ``TRAIN_VISION_DEPTH`` of
      the 32 vision blocks (``cut_depth``) -- the paged rollout of
      path b's requests, old log-probs (policy) and ref log-probs (a frozen copy) on
      packed multimodal rows, GRPO advantages, the packed actor update
      (dual-clip loss + ``low_var_kl``, per-layer checkpointing, the flash
      backward kernels, AdamW);
   e. the trainer: ``build_config`` on the dotlist of the shipped
      ``scripts/spatialthinker_3b_grpo.sh`` with the deploy-scale knobs cut
      (16 prompts x n 8, prompt 512, response 64, 64 slots, page 256, one
      card, the synthetic tokenizer, 1 step, validation before training on 8
      held-out rows; and ``remat_policy=full``, since the shipped ``dots``
      does not fit one card beside fp32 moments at 3B), ``build_model`` (the
      3B preset, seeded random weights), seeded rows with 640 x 480 images
      through ``RLHFDataset.from_rows``, the ``spatial_sgg`` reward,
      ``build_trainer(...).fit()``;
   f. the rollout knobs that reach the other decode kernels, through the same
      trainer's ``generate_sequences`` on ``KNOB_PROMPTS`` of its prompts x n 8
      (64 rows): the dense engine (``rollout.name=jax``)
      over an int8 cache, an int4 cache and an int4 cache with ``int4_i8dot``,
      the paged engine with int4 pools without ``int4_i8dot``, the continuous
      engine (``page_size=0``) over an int8 cache (all 16 prompts: 128 rows
      through 72 lanes, two waves with refills), and the dense engine with
      the w4a8 copy (64 rows through the int4 MLP kernels);
   g. the same trainer with path e's dotlist and four knobs changed
      (``rollout.name=continuous``, ``page_size=0``, ``quantization=w4a8``,
      ``decode_batch_size=128``): ONE ``train_step`` — 16 prompts x n 8
      through 136 lanes of the continuous engine, the int4 MLP kernels at
      every decode step, the real reward, old / ref log-probs, the update;
   and a checkpoint round trip at 3B widths and 4 layers: a trainer takes a
   step and saves, a fresh trainer (built from the same initial weights, as a
   resumed run is) loads, both take the next step;
   i. the critic: path e's dotlist with ``algorithm.adv_estimator=gae`` and
      both optimizers on bf16 moments without a Kahan buffer, the critic's
      checkpoints at ``remat_policy=full`` as the actor's
      (``GAE_OVERRIDES``), a fresh trainer at full 3B width and
      ``cut_depth`` (the critic shares the actor's preset: bf16
      backbone, fp32 value head), ONE
      ``train_step``: the paged rollout, old / ref log-probs, the critic's
      values, GAE, the critic's update, the actor's update; the flash calls
      of its first critic micro-batch recorded (``record_call``) and #1 / #2
      / #3 held against their plain versions on those segment ids;
   j. the eval harness: ``run_evaluation`` with a ``TorchProvider`` over path
      i's policy on 8 in-memory rows in cv-bench's layout (640 x 480 images,
      2-4 choices, batch 4, 64 new tokens), then the same call resumed from
      its output file;
   k. the shipped 7B script: ``build_config`` on the dotlist of
      ``scripts/spatialthinker_7b_grpo.sh`` with ``SEVENB_OVERRIDES`` (the two
      host-state knobs ``optim.stream`` and ``ref.offload``, and path e's
      deploy-scale cuts: 16 prompts x n 8, prompt 512, response 64, one card,
      one step), ``build_model`` (the 7B preset at full width and depth:
      28 x 3584 text, 28 query heads over 4 kv heads, G = 7), the seeded scene
      rows and the ``spatial_sgg`` reward, ``build_trainer(...).fit()``: the
      paged rollout at 128 slots and page 1,024, old log-probs, the ref
      log-probs from the host copy, GRPO, the packed update under
      ``remat_policy=dots`` with the moments (bf16, Kahan buffer) streamed
      from the host; the host memory it pins and what ``/proc/meminfo`` had;
      the update's first text flash call, a mid-decode paged call (cut to
      its pages), the first silu junction call and a decode call of kernel A
      recorded, and each kernel held against its plain version on them
      after the step, beside kernel A at the five 7B linears;
   l. several GPUs on one card, in processes of their own: (l1) the
      distributed branch at world 1 over NCCL (path e's dotlist at
      ``cut_depth``, one step), a probe of two NCCL ranks on one
      device, (l2) ring / Ulysses at sp = 2 as two gloo processes on
      ``cuda:0`` (``--only-path-l`` runs the build and path l alone);
   m. Megatron tensor parallelism at tp = 2 as two gloo processes on
      ``cuda:0``: (m1) the 4-layer 3B model's packed log-probs against the
      unsharded model's, in fp32 through the plain attention and in bf16
      through the kernels, beside planted faults as negative controls;
      (m2) the trainer at ``model_size=2`` / ``tensor_parallel_size=2`` on
      path e's dotlist at ``TP_M2_LAYERS`` text layers and
      ``TRAIN_VISION_DEPTH`` vision blocks (full widths), 3 prompts x n 8,
      ONE step: one paged engine a TP group (W8A8, int4 pools,
      ``int4_i8dot``), old / ref log-probs, the packed update -- a check of
      correctness, not a timing; (m3) that trainer's ``generate_sequences``
      on 2 prompts x n 4 with the dense engine on the w4a8 copy (int4 KV,
      int8 dots: #13, #14's split entry, #6) and the continuous engine over
      an int8 cache at 4 slots (#4', refills in lockstep), both ranks the
      same tokens, then layer 0's TP w4a8 MLP against the unsharded copy's
      with a planted local amax as its negative control (a TP rollout beside
      sp needs the policy FSDP-sharded over both ranks: gloo carries no CUDA
      all-gather and NCCL refuses two ranks on one card, so it is held on
      the CPU and waits for several cards);
      before them, in the main process, every kernel a TP rank runs at its
      TP-local shapes against its plain version (``tp_kernel_cases``: also
      #4, #4', #5 and #6 at one kv head, #13 at the local I and #14's split
      entry on the padded shards; ``--only-path-m`` runs the build, these
      and path m alone);
5. checks what came out: finite log-probs <= 0 of the expected shapes; the
   kernel-path prefill logits as close to an fp32 reference as the plain
   path's; the int4 path's rollout log-probs against the bf16 model's
   teacher-forced log-probs of the same tokens (the reference's
   ``rollout/probs_diff``) and its greedy first tokens against the dense
   engine's; the bf16-pool paged path against the dense engine (equal first
   tokens, and no further from the teacher-forced bf16 model than the dense
   engine is, see ``ENGINE_DRIFT_RATIO``); the int4 MLP kernels within
   ``INT4_REL_TOL`` of their plain versions; for the training path: finite
   metrics, a positive gradient norm, parameters that moved and a reference
   copy that did not, a first mini-batch whose forward recomputes the old
   log-probs (``actor/ppo_kl`` ~ 0, nothing clipped), old log-probs as close
   to the engine's as ``PROBS_DIFF_LIMIT``, packed = per-sample log-probs, the
   gradient of one packed row with the backward kernels against the plain
   backward behind the same kernel forward, and a non-finite
   gradient that leaves parameters and optimizer state untouched; for the
   trainer: two ``step N`` records with finite ``actor/*``, ``critic/score/*``,
   ``reward/*``, ``timing_s/*``, ``perf/*``, ``rollout/kv_*`` and a
   ``rollout/probs_diff_mean`` within ``PROBS_DIFF_LIMIT``, a
   ``val/reward_score``, parameters that moved and a reference copy that did
   not; per knob case its kernels launched, the other decode kernels not, and
   the engine's log-probs near the trainer's own; two controls (the
   dense_w4a8 case with the int4 copies' gate and up halves swapped, and with
   each layer on the next layer's copies) land above
   ``W4_PROBS_DIFF_LIMIT``; for path g 136 lanes, both
   int4 kernels and the int4 int8-dot decode kernel launched 36 times per
   decode step, the silu junction at prefill, no paged kernel, a token in
   every row, finite log-probs <= 0 and ``rollout/probs_diff_mean`` within
   ``W4_PROBS_DIFF_LIMIT``; on the inputs one decode call of path g and of
   the continuous_int8 case really had (``record_call``: the last layer at
   the middle decode step, the slot cache with the prompt, the gap and the
   ring cells) the decode kernel against its plain version, and on path g's
   refill prefill the silu junction against its plain version; after the
   checkpoint round trip equal metrics and parameters; every path with W8A8
   weights (b, d, e, f, g, h) launches the W8A8 kernel and never
   ``torch._int_mm`` (a counting wrapper is installed); the W8A8 kernel is
   held against the plain chain on one decode call of path b and on path g's
   refill prefill, and the staged block against the plain versions on one
   mid-chunk call of path h and of each fused greedy run, with the ring's
   cells live; for path i finite phase times and critic metrics, the value
   head, a backbone layer and the actor moved, values 0 past each response,
   ``rollout/probs_diff_mean`` within ``PROBS_DIFF_LIMIT``, both optimizers
   stepped with bf16 moments and no Kahan buffer; for path j 8 records, the
   summary ``summarize``'s, and a resumed call that launches neither the
   flash forward nor the dense decode kernel and returns the same summary;
   for path k finite metrics, a positive gradient norm, parameters that
   moved and a host reference copy that did not, the streamed optimizer
   stepped once with its moments on the host and exactly their bytes
   streamed each way, ``rollout/probs_diff_mean`` within
   ``PROBS_DIFF_LIMIT``, every kernel of a step launched, no dense decode
   kernel and no ``torch._int_mm``;
   for path m the TP model's fp32 log-probs within ``TP_FP32_LOGP_ATOL`` of
   the unsharded model's and its bf16 ones no further from the fp32 model
   than ``TP_BF16_DRIFT_RATIO`` times the unsharded bf16 model's (and the
   planted faults of ``TP_FAULTS_SEEN`` further), every row-parallel
   partial summed in fp32, a finite step record,
   ``rollout/probs_diff_mean`` within ``PROBS_DIFF_LIMIT``, both ranks'
   sampled tokens equal, parameters moved, every TP kernel (#1-#3, #9,
   #12's split mode, kernel A's row quantize in its split mode, kernel A
   fused and prequantized) launched on both ranks and the one-pass #12 not;
6. prints one JSON line of kernel results (each with its launches on paths i,
   j and k: ``launches_gae_path``, ``launches_eval_path``,
   ``launches_7b_path``) and of the paths (among them, as a record and not a
   check, the prefill-dequant mode's product beside kernel A at the 3B
   gate_up and m = 1,024 and 4,096), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises and exits non-zero; no phase catches its own failure.
Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import paged_cases
import spatialthinker_torch.ops.decode_attention as da
import spatialthinker_torch.ops.flash_attention as fa
import spatialthinker_torch.ops.int4_mlp as i4
import spatialthinker_torch.ops.int8_matmul as i8m
import spatialthinker_torch.ops.paged_attention as pa
import spatialthinker_torch.ops.quant as tq
import spatialthinker_torch.ops.silu_quant as sq
import spatialthinker_torch.rollout.continuous as tcont
import spatialthinker_torch.rollout.paged as tpaged
import spatialthinker_torch.trainer.grpo_trainer as gt
from spatialthinker_torch import csrc
from spatialthinker_torch.core.batch import RolloutBatch
from spatialthinker_torch.core.config import build_config
from spatialthinker_torch.data.dataset import DataLoader, RLHFDataset
from spatialthinker_torch.eval.providers import TorchProvider
from spatialthinker_torch.models.qwen2_5_vl import (
    forward, init_params, logits_from_hidden, prefill_forward, qwen25_vl_3b, window_patch_len,
)
from spatialthinker_torch.models.qwen2_5_vl.text import MLP, KVCache
from spatialthinker_torch.ops.quant import (
    QuantLinear, int8_matmul, quantize_activation, quantize_model, quantize_weight,
)
from spatialthinker_torch.parallel.offload import host_bytes
from spatialthinker_torch.rollout.engine import generate
from spatialthinker_torch.rollout.paged import generate_paged
from spatialthinker_torch.rollout.sampling import SamplingParams
from spatialthinker_torch.trainer.grpo_trainer import (
    compute_advantages, compute_log_probs_batched, packed_micro_batches, rollout_batch_from_result,
    to_device, update_actor_packed,
)
from spatialthinker_torch.trainer.main import build_model, build_trainer, load_tokenizer
from spatialthinker_torch.trainer.metrics import Timer
from spatialthinker_torch.trainer.train_step import (
    make_optimizer, make_packed_grad_fn, make_packed_update_fn,
)
from spatialthinker_torch.models.qwen2_5_vl.config import qwen25_vl_7b
from spatialthinker_torch.models.qwen2_5_vl.model import vision_to_device
from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

PROCESS_T0 = time.perf_counter()  # this process's start, after its imports

# bf16 kernel vs fp32-softmax plain version on the same bf16 inputs: both
# accumulate in fp32 and round the softmax weights and the output to bf16 at
# different points — a few bf16 ulps of an O(1) output.
OUT_ATOL = 3e-2
LSE_ATOL = 5e-3  # fp32 logsumexp, fast-math exp/log in the kernel
# Paged kernels repeat their plain versions' arithmetic page by page: stats
# within 2e-3; outputs of quantized pools are O(0.3) and an int8 softmax
# weight on a rounding tie may flip by one step (1/127 of its row max).
PAGED_STAT_ATOL = 2e-3
PAGED_OUT_ATOL = {"bf16": 3e-2, "int8": 1e-2, "int4_i8": 1e-2, "int4": 1e-2}
# Quantized dense caches: the kernels repeat the plain version's arithmetic
# with a running max instead of the global one; outputs are O(0.3), bf16, and
# an int8 softmax weight on a rounding tie may flip by one step (1/127 of its
# block's largest weight).
DECODE_QUANT_ATOL = 1e-2
# silu -> int8: values at most one step apart (ties), scales 1e-5 relative
SILU_SCALE_RTOL = 1e-5
# int4 MLP kernels vs plain: the row quantize is the plain version's to the
# bit and the int32 group dots are exact; the fp32 order of the group sums,
# the silu's last bit and the bf16 rounding of the output remain: the largest
# error within 1e-2 of the largest output magnitude (two bf16 ulps); down in
# fp32 within 1e-4 of it (only the order of the fp32 sums differs). Two calls
# are bit-identical (the plan's cluster ranks are summed in rank order).
INT4_REL_TOL = 1e-2
INT4_F32_REL_TOL = 1e-4
INT4_MS = (136, 128, 8)  # path g's lanes (128 slots + trash, to a multiple of 8), path f's 128 rows, small
INT4_FALLBACK_M = 256    # the JAX package's rule admits gate_up here and refuses down: the MLP is int8
# The fused W8A8 kernel repeats the plain chain (quantize, int32 dot, two
# rounded scale products) exactly, whatever its plan's split of K: equal bit
# for bit. Rows: path b's lanes (64 slots + trash), 128 slots + trash, path
# g's lanes (decode plans: all rows in one row tile, K split), path b's
# refill chunk (4 rows x 256) and path g's refill prefill (prefill plans).
W8A8_MS = (65, 129, 136, 1024, 4096)
# Full 3B prefill, last-position logits: both bf16 paths (kernels, plain
# attention) drift from an fp32 plain-path reference by bf16 rounding through
# 36 text layers and 32 vision blocks. The kernel path must stay within twice
# the plain path's own drift.
KERNEL_DRIFT_RATIO = 2.0
# ... and the two bf16 paths may differ from each other by at most 5% of the
# largest |logit| (each drifts ~3% from fp32 at this depth on the H100).
LOGITS_REL_TOL = 0.05
# The shipped path (W8A8 weights, int4 KV, int8 dots) against the bf16 model
# on the SAME tokens, mean |log-prob difference| (the reference logs it as
# rollout/probs_diff). Random weights give near-flat logits (std ~0.9), on
# which per-token int8 activations (0.4% of a row max per operand) through
# 36 layers and 4-bit KV move a log-prob by about a tenth: 0.114 measured on
# an H100, of which 0.09 is there on the first token, which no quantized KV
# has touched yet (W8A8 alone). The limit is ~2.5x the measurement; a wrong
# page, nibble or scale moves log-probs by whole units.
PROBS_DIFF_LIMIT = 0.3
# First greedy tokens of the int4 path vs the dense bf16 engine: the top two
# logits of a random model are ~0.15 apart, so a 0.09 shift flips some of
# them (10 of 16 agreed on an H100).
FIRST_TOKEN_MIN_AGREEMENT = 0.4
# bf16-pool paged path vs dense engine: same bf16 weights, same bf16 KV, other
# kernels. The first token comes from the same prefill and must be equal.
# Beyond it the two cannot agree token for token on random weights: bf16
# rounding alone (attention weights rounded at other points, 17-lane against
# 16-row matmuls) moves a logit by ~3% of the largest (see LOGITS_REL_TOL),
# as much as the gap between the top two. So each engine's log-probs are held
# against the same bf16 model run over prompt + response in one forward, and
# the paged engine may drift at most twice as far from it as the dense one.
ENGINE_DRIFT_RATIO = 2.0

# Flash backward kernels vs the fp32 plain version: the kernels round p and ds
# to bf16 (8 bits) before the second products and the gradients themselves to
# bf16; each gradient within this share of its own largest magnitude
# (4e-3 to 7e-3 measured on an H100).
BWD_REL_TOL = 1e-2
# The backward's pre-pass: delta = rowsum(dO * o) over D = 80 / 128 bf16
# products in fp32, summed in another order than the eager expression.
PREP_DELTA_ATOL = 1e-4
# Training path. No optimizer step lies between the old log-probs and the first
# mini-batch of a step, so that mini-batch's forward recomputes them up to
# bf16 and packing noise (other row neighbours, other matmul shapes).
FIRST_MINIBATCH_PPO_KL = 5e-3   # 6e-4 measured on an H100
FIRST_MINIBATCH_CLIPFRAC = 0.01
# Packed vs per-sample log-probs of the same samples, bf16 model: the same
# tokens meet other row lengths and matmul shapes; mean |difference|.
PACKED_LOGP_ATOL = 3e-2
# Gradient of one packed row through the whole model, the two backward kernels
# against ``flash_bwd_plain`` on the card. Both arms run the kernel forward
# (the same o and lse reach both backwards), so only the backward kernels'
# bf16 rounding of p and ds separates them: relative difference of the global
# norms, and the cosine between the two gradients.
GRAD_NORM_REL_TOL = 5e-3
GRAD_COSINE_MIN = 0.999
ACTOR = dict(
    clip_ratio_low=0.2, clip_ratio_high=0.3, clip_ratio_dual=3.0, use_kl_loss=True,
    kl_loss_coef=1e-2, kl_penalty="low_var_kl", max_grad_norm=1.0, remat=True, chunk_size=1024,
    temperature=1.0, grad_accum_dtype=torch.float32,
)
# global_batch_size 128 of the shipped script cut to 64: two optimizer steps per GRPO step
TRAIN = dict(global_batch_size=64, micro_rows=4, experience_micro=16, lr=1e-6, strategy="adamw")
GRPO_STEPS = 1
# Paths d, i and l1 run at 3B widths with 4 of the 36 text layers (6 until
# the TP cases of the dense / continuous engines and w4a8 were added) and 8 of
# the 32 vision blocks (full attention in every fourth block, as in the whole
# tower; at 6 text layers the whole tower was ~70% of a sample's forward):
# paths e and k take a step at full depth through the trainer, and the smoke
# has to stay within its 800 s on a slow host.
TRAIN_LAYERS = 4
TRAIN_VISION_DEPTH, TRAIN_FULLATT = 8, (3, 7)


def cut_depth(cfg, layers: int = TRAIN_LAYERS):
    """``cfg`` at ``layers`` text layers and ``TRAIN_VISION_DEPTH`` vision
    blocks, every width as it is."""
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=layers),
        vision=dataclasses.replace(cfg.vision, depth=TRAIN_VISION_DEPTH, fullatt_block_indexes=TRAIN_FULLATT))



# A log-prob piece of 16 samples runs the vision tower over their 16 images as
# one sequence (32,768 slots); its full-attention forward is recorded in path d
# as the first vision call of at least this many slots.
LOGPROB_VISION_MIN_SLOTS = 20000
# Path f: the dense engine over an int8 cache differs from path b's engine only
# in the KV format (8 bits instead of 4), so its drift from the trainer's own
# log-probs may exceed path b's measured probs_diff by at most this much.
INT8_CACHE_EXTRA_DRIFT = 0.05
# Paths g and f with w4a8: int4 g128 MLP weights carry ~11% RMS error per
# weight on normal weights (tests/test_int4_mlp.py bounds the product at 15%)
# against ~0.5% for int8, so the engine drifts further from the trainer's bf16
# log-probs than W8A8's 0.09 (path e): 0.43 on an H100. The limit's other
# side is measured in every run: ``w4_controls`` repeats the dense_w4a8 case
# with miswired int4 copies, and each must land above it.
W4_PROBS_DIFF_LIMIT = 0.5
# The checkpoint round trip: the loaded trainer repeats the saving trainer's
# next step on the same batch with the same sampling stream. Nothing in that
# step is random, so metrics agree to fp32 summation noise. With random weights
# no response earns a reward, so the gradient is the KL term's, ~1e-9 a
# parameter, and Adam turns its sign into a step of lr = 1e-6: where summation
# noise flips a sign the two trainers' parameters end two steps apart.
CKPT_METRIC_RTOL, CKPT_METRIC_ATOL = 1e-3, 1e-5
CKPT_PARAM_ATOL = 2.5e-6
TRAINER_SCRIPT = "scripts/spatialthinker_3b_grpo.sh"
# the deploy-scale knobs of the shipped script, cut to one card and one short step (with
# path l, two steps took the smoke past 750 s of its 1,200; path g takes the trainer's next step)
TRAINER_OVERRIDES = [
    "worker.actor.model.model_path=Qwen/Qwen2.5-VL-3B-Instruct",
    "worker.actor.model.tokenizer_path=synthetic",
    "data.rollout_batch_size=16", "data.max_prompt_length=512", "data.max_response_length=64",
    "worker.rollout.decode_batch_size=64", "worker.rollout.page_size=256",
    "trainer.n_chips=1", "trainer.max_steps=1",
    "trainer.val_before_train=true", "trainer.val_freq=-1", "trainer.save_freq=-1",
    "trainer.logger=['console','jsonl']",
    # the shipped default remat_policy=dots does not fit one card at 3B with
    # fp32 moments: the policy, the reference copy and the moments (45.2 GB),
    # the fp32 accumulator (15 GB) and the kept weight products of a
    # micro-batch ran out at 82.97 GB (NVIDIA H100 80GB HBM3, 700.00 W);
    # path k runs dots, at 7B, with the moments on the host
    "worker.actor.sharding.remat_policy=full",
]
TRAINER_VAL_ROWS = 8
# path f's knob cases and the w4 controls: 8 of path e's 16 prompts x n 8 = 64 rows, one wave of the
# paged engine's 64 slots and of the dense engine's batch; the continuous engine's case takes all 16
# (128 rows through its 64 slots, 72 lanes: two waves, so it harvests and refills lanes mid-decode)
KNOB_PROMPTS = 8
CONTINUOUS_KNOB_PROMPTS = 16
CKPT_LAYERS = 4

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

MAX_NEW_TOKENS = 64
QUESTIONS = [
    "Is the red mug to the left of the laptop?",
    "How many chairs are around the table?",
    "Which object is closer to the camera, the lamp or the sofa?",
    "Is the bicycle in front of or behind the fence?",
]
# the paged path: 16 requests x 8 samples = 128 lanes through 64 slots
PAGED_REQUESTS = 16
PAGED = dict(
    group_n=8, slots=64, page_size=256, total_pages=129, decode_chunk_size=16,
    refill_batch=8, prefill_rows=4, max_num_batched_tokens=1024,
)
CHECK_NEW_TOKENS = 16  # the greedy agreement runs


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_us(fn, calls: int = 20) -> float:
    """Microseconds of a call among ``calls`` queued back to back behind a
    sleeping kernel: the device time of a call with the gaps between launches,
    by CUDA events (the profiler can return no device events late in a long
    process)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms: longer than issuing the calls
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    """Least milliseconds the card could take: every input read once and
    every output written once at the memory rate, or the operations at the
    peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _kv_groups(q, k):
    """(kv head as a slice, its G query heads as a slice) for every kv head."""
    g = q.shape[2] // k.shape[2]
    return [(slice(h, h + 1), slice(h * g, (h + 1) * g)) for h in range(k.shape[2])]


def flash_fwd_plain_by_head(q, k, v, q_seg, kv_seg, **kw):
    """``flash_fwd_plain`` one kv head (with its G query heads) at a time: the
    fp32 score tensors of all 16 heads of a 16,384-slot vision pack at once
    would not fit the card."""
    parts = [fa.flash_fwd_plain(q[:, :, hq], k[:, :, hk], v[:, :, hk], q_seg, kv_seg, **kw)
             for hk, hq in _kv_groups(q, k)]
    return torch.cat([o for o, _ in parts], dim=2), torch.cat([lse for _, lse in parts], dim=1)


def flash_bwd_plain_by_head(q, k, v, q_seg, kv_seg, o, lse, do, **kw):
    """``flash_bwd_plain`` one kv head at a time, for the same reason."""
    parts = [fa.flash_bwd_plain(q[:, :, hq], k[:, :, hk], v[:, :, hk], q_seg, kv_seg,
                                o[:, :, hq], lse[:, hq], do[:, :, hq], **kw)
             for hk, hq in _kv_groups(q, k)]
    return tuple(torch.cat(grads, dim=2) for grads in zip(*parts))


@contextmanager
def plain_attention(forward: bool = True):
    """Route the model's attention through the plain versions on the card (for
    the kernel-vs-plain comparisons only): forward and backward, or with
    ``forward=False`` the backward alone behind the kernel forward."""
    saved = fa.flash_fwd, fa.flash_bwd
    if forward:
        fa.flash_fwd = fa.flash_fwd_plain
    fa.flash_bwd = flash_bwd_plain_by_head
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = saved


PLAIN_VERSIONS = [
    (fa, "flash_fwd_plain"), (fa, "flash_bwd_plain"), (fa, "flash_bwd_prep_plain"),
    (da, "decode_attention_plain"), (pa, "paged_attention_plain"),
    (pa, "paged_attention_int4_i8_plain"), (pa, "paged_attention_int4_plain"),
    (pa, "paged_attention_gathered"),
    (sq, "fused_silu_quantize_plain"), (i4, "w4_gateup_silu_plain"), (i4, "w4_matmul_plain"),
    (i4, "w4_matmul_split_plain"),
    (i8m, "fused_w8a8_matmul_plain"), (i8m, "w8a8_matmul_prequantized_plain"),
    (sq, "silu_row_amax_plain"), (sq, "silu_quantize_with_amax_plain"),
    (i8m, "row_amax_plain"), (i8m, "quantize_rows_with_amax_plain"),
]

_LIBRARY_INT_MM = torch._int_mm


def counted_int_mm(*args, **kwargs):
    """``torch._int_mm`` with a call count (installed by ``main``): the library
    matmul the W8A8 kernel replaced must not run on a main path."""
    counted_int_mm.launches += 1
    return _LIBRARY_INT_MM(*args, **kwargs)


counted_int_mm.launches = 0


@contextmanager
def forbid_plain_versions():
    """Fail loudly if a main path reaches a kernel's plain version."""
    saved = [getattr(mod, name) for mod, name in PLAIN_VERSIONS]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a main path")

    for mod, name in PLAIN_VERSIONS:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for (mod, name), fn in zip(PLAIN_VERSIONS, saved):
            setattr(mod, name, fn)


def reset_counts() -> None:
    # looked up at call time: a wrapper may have been re-bound meanwhile
    for fn in (fa.flash_fwd, fa._launch_ranges, fa._launch_bwd_prep, fa._launch_bwd_dq, fa._launch_bwd_dkv,
               da.decode_attention,
               da._launch_int8_kernel, da._launch_int4_kernel, da._launch_int4_i8_kernel,
               pa._launch_pool_kernel, pa._launch_int4_i8_kernel, pa._launch_int4_kernel,
               sq.fused_silu_quantize, i4.w4_gateup_silu, i4.w4_matmul, i4.w4_matmul_split, i8m.fused_w8a8_matmul,
               i8m.w8a8_matmul_prequantized, sq.silu_row_amax, sq.silu_quantize_with_amax, i8m.row_amax,
               i8m.quantize_rows_with_amax, counted_int_mm):
        fn.launches = 0
    pa._launch.staged_launches = 0


def read_counts() -> dict:
    return {
        "flash_fwd": fa.flash_fwd.launches, "flash_ranges": fa._launch_ranges.launches,
        "flash_bwd_prep": fa._launch_bwd_prep.launches,
        "flash_bwd_dq": fa._launch_bwd_dq.launches,
        "flash_bwd_dkv": fa._launch_bwd_dkv.launches, "decode_attention": da.decode_attention.launches,
        "decode_attention_int8": da._launch_int8_kernel.launches,
        "decode_attention_int4": da._launch_int4_kernel.launches,
        "decode_attention_int4_i8": da._launch_int4_i8_kernel.launches,
        "paged_attention_pool": pa._launch_pool_kernel.launches,
        "paged_attention_int4_i8": pa._launch_int4_i8_kernel.launches,
        "paged_attention_int4": pa._launch_int4_kernel.launches,
        "silu_quant": sq.fused_silu_quantize.launches,
        "int4_gateup": i4.w4_gateup_silu.launches, "int4_down": i4.w4_matmul.launches,
        # #14's split entry (a row-parallel down shard under tensor parallelism)
        "int4_down_split": i4.w4_matmul_split.launches,
        "w8a8": i8m.fused_w8a8_matmul.launches, "w8a8_prequantized": i8m.w8a8_matmul_prequantized.launches,
        "paged_staged": pa._launch.staged_launches, "int_mm": counted_int_mm.launches,
        # #12's split mode (tensor parallelism), its two passes
        "silu_amax": sq.silu_row_amax.launches, "silu_with_amax": sq.silu_quantize_with_amax.launches,
        # kernel A's row quantize in its split mode (a row-parallel input under tensor parallelism)
        "quant_amax": i8m.row_amax.launches, "quant_with_amax": i8m.quantize_rows_with_amax.launches,
    }


def flash_checks(counts: dict) -> dict:
    """The flash forward of a path: launched, each launch behind its range launch."""
    return {"flash launched": counts["flash_fwd"] > 0,
            "flash range tables with every forward": counts["flash_ranges"] == counts["flash_fwd"]}


def w8a8_checks(counts: dict) -> dict:
    """The W8A8 route of a path with quantized weights: kernel A launched, the
    library's ``_int_mm`` not at all."""
    return {"W8A8 kernel launched": counts["w8a8"] > 0, "no torch._int_mm": counts["int_mm"] == 0}


def requests(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    prompts = [QUESTIONS[i % len(QUESTIONS)] + (f" (scene {i})" if i >= len(QUESTIONS) else "")
               for i in range(n)]
    images = [[(rng.random((480, 640, 3)) * 255).astype(np.uint8)] for _ in prompts]
    return prompts, images


def randn_bf16(rng, dev, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------


def check_flash(dev, prep, cfg):
    """Flash kernel vs plain at the main paths' shapes: text prefill (causal,
    left-padded), vision full attention and windows (D=80), and the
    causal-offset chunk the paged path's chunked prefill gives it (4 rows x
    256 queries against the 512-cell prefix). Returns (forward results,
    range-launch results)."""
    rng = np.random.default_rng(1)
    tc, vc = cfg.text, cfg.vision
    seg_text = prep["prompt_segment_ids"].to(torch.int32).contiguous()
    b, p = seg_text.shape
    vis = prep["vision"]
    n = vis.seg_full.shape[0]
    wlen = window_patch_len(vc)
    seg_full = vis.seg_full.to(torch.int32).reshape(1, n).contiguous()
    seg_win = vis.seg_window.to(torch.int32).reshape(n // wlen, wlen).contiguous()
    chunk = p // 2
    cases = [
        ("text_prefill", (b, p, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim),
         seg_text, seg_text, True, 0, p),
        ("vision_full", (1, n, vc.num_heads, vc.num_heads, vc.head_dim), seg_full, seg_full, False, 0, n),
        ("vision_window", (n // wlen, wlen, vc.num_heads, vc.num_heads, vc.head_dim),
         seg_win, seg_win, False, 0, wlen),
        ("causal_offset_chunk", (b, chunk, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim),
         seg_text[:, chunk:].contiguous(), seg_text, True, chunk, p),
    ]
    results, range_results = [], []
    for name, (bb, sq_len, hq, hkv, d), q_seg, kv_seg, causal, off, skv in cases:
        q, k, v = (randn_bf16(rng, dev, bb, s, h, d) for s, h in ((sq_len, hq), (skv, hkv), (skv, hkv)))
        fwd, ranges = flash_fwd_case(name, q, k, v, q_seg, kv_seg, causal, off)
        results.append(fwd)
        range_results.append(ranges)
        del q, k, v
        torch.cuda.empty_cache()
    return results, range_results


def flash_fwd_case(name, q, k, v, q_seg, kv_seg, causal, off, by_head=False, plain_iters=10):
    """The forward kernel (range launch + forward, one call) against
    ``flash_fwd_plain`` (head by head with ``by_head``), timed beside the
    plain version and SDPA with the equivalent mask; ``live_tile_share`` is
    the share of (q tile, kv tile) pairs the forward runs. Then the range
    launch alone against ``tile_ranges``. Returns (forward, range) results."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kw = dict(causal=causal, scale=d**-0.5, causal_offset=off)
    plain = flash_fwd_plain_by_head if by_head else fa.flash_fwd_plain
    o_ref, lse_ref = plain(q, k, v, q_seg, kv_seg, **kw)
    before = fa._launch_ranges.launches, fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, q_seg, kv_seg, **kw)
    torch.cuda.synchronize()
    one_each = (fa._launch_ranges.launches, fa.flash_fwd.launches) == (before[0] + 1, before[1] + 1)
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    dead_ok = bool(torch.all(o[q_seg == 0] == 0))
    del o_ref, lse_ref
    q_rng, kv_rng = fa._launch_ranges(q_seg, kv_seg)
    want = fa.tile_ranges(q_seg), fa.tile_ranges(kv_seg)
    ranges_equal = torch.equal(q_rng, want[0]) and torch.equal(kv_rng, want[1])
    live_share = fa.fwd_live_tiles(want[0], want[1], causal, off, sq, skv).float().mean().item()
    plain_ms = cuda_ms(lambda: plain(q, k, v, q_seg, kv_seg, **kw), iters=plain_iters,
                       warmup=1 if plain_iters < 10 else 3)
    ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, q_seg, kv_seg, **kw))
    ranges_ms = cuda_ms(lambda: fa._launch_ranges(q_seg, kv_seg))
    ranges_plain_ms = cuda_ms(lambda: (fa.tile_ranges(q_seg), fa.tile_ranges(kv_seg)))
    # the one PyTorch call for the same function: SDPA with the equivalent mask
    mask = fa.make_attention_mask(q_seg, kv_seg, causal, off)[:, None]
    pairs = int(mask.sum())
    g = hq // hkv
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                  (q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=d**-0.5),
                     iters=min(plain_iters, 10))
    b_ms, b_by = bound_ms(nbytes(q, k, v, o, lse, q_seg, kv_seg), 4.0 * pairs * hq * d, "bf16")
    rb_ms, rb_by = bound_ms(nbytes(q_seg, kv_seg, q_rng, kv_rng), 0.0, "bf16")
    print(f"flash {name}: q{tuple(q.shape)} kv{tuple(k.shape)} causal={causal} offset={off} "
          f"max_abs_err={err:.3e} lse_err={lse_err:.3e} padding_rows_zero={dead_ok} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
          f"live_tile_share={live_share:.4f} (unmasked pair share {pairs / (b * sq * skv):.4f}); range launch "
          f"counted once={one_each}, tables equal={ranges_equal}, ranges_ms={ranges_ms:.4f} "
          f"(plain {ranges_plain_ms:.4f}, bound {rb_ms:.5f})", flush=True)
    if not (err <= OUT_ATOL and lse_err <= LSE_ATOL and dead_ok and one_each):
        raise AssertionError(f"flash kernel disagrees with plain on {name}")
    if not ranges_equal:
        raise AssertionError(f"flash range launch disagrees with tile_ranges on {name}")
    fwd = dict(shape=name, max_abs_err=err, lse_err=lse_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, live_tile_share=live_share)
    ranges = dict(shape=name, max_abs_err=0.0, ms=ranges_ms, plain_ms=ranges_plain_ms, bound_ms=rb_ms,
                  bound_by=rb_by, library_ms=None)
    del o, lse, mask, qt, kt, vt
    return fwd, ranges


def synthetic_training_cases(cfg):
    """Hand-made segment ids of the training path's three attention forms:
    packed text rows (2-3 segments per row and a padded tail), vision full
    attention over a padded patch sequence, and the batched windows form."""
    wlen = window_patch_len(cfg.vision)
    seg_text = np.zeros((4, 1024), np.int32)
    for row, cuts in enumerate(((400, 790, 1000), (520, 980), (330, 660, 940), (470, 900, 1024))):
        start = 0
        for i, end in enumerate(cuts):
            seg_text[row, start:end] = i + 1
            start = end
    seg_full = np.zeros((1, 8192), np.int32)
    for i in range(5):  # five 34 x 46 images and a padded tail
        seg_full[0, i * 1564 : (i + 1) * 1564] = i + 1
    seg_win = np.ones((8192 // wlen, wlen), np.int32)
    seg_win[-3:, wlen // 2 :] = 0   # edge windows padded in place
    seg_win[-1] = 0                 # a whole padding window
    return training_cases(cfg, "synthetic", seg_text, seg_full, seg_win)


def training_cases(cfg, prefix, seg_text, seg_full, seg_win, text_form="text_packed_rows"):
    tc, vc = cfg.text, cfg.vision
    wlen = window_patch_len(vc)
    text = (tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim)
    vis = (vc.num_heads, vc.num_heads, vc.head_dim)
    return [
        (f"{prefix}_{text_form}", text, np.asarray(seg_text, np.int32), True),
        (f"{prefix}_vision_full", vis, np.asarray(seg_full, np.int32).reshape(1, -1), False),
        (f"{prefix}_vision_window", vis, np.asarray(seg_win, np.int32).reshape(-1, wlen), False),
    ]


def check_flash_training(dev, cases):
    """The flash forward and the backward kernels vs their plain versions
    (run head by head) on the training path's attention forms: packed text
    rows (causal), vision full attention and the batched windows form (D = 80,
    non-causal). ``cases`` are (name, (Hq, Hkv, D), segment ids (B, S), causal).
    The backward runs twice and must agree bit for bit. Each backward kernel
    is timed on its own (the pre-pass's outputs precomputed) and the whole
    backward (pre-pass, dQ, dK/dV) as one call; the library yardsticks are
    SDPA with the equivalent mask and its backward, which computes dq, dk and
    dv together. ``live_tile_share`` is the share of (q tile, kv tile) pairs
    the backward kernels run. Returns (forward, pre-pass, dQ, dK/dV) results."""
    rng = np.random.default_rng(8)
    fwd_cases, prep_cases, dq_cases, dkv_cases = [], [], [], []
    for name, (hq, hkv, d), seg_np, causal in cases:
        seg = torch.from_numpy(seg_np).to(dev)
        bb, s_len = seg.shape
        q, do = randn_bf16(rng, dev, bb, s_len, hq, d), randn_bf16(rng, dev, bb, s_len, hq, d)
        k, v = randn_bf16(rng, dev, bb, s_len, hkv, d), randn_bf16(rng, dev, bb, s_len, hkv, d)
        kw = dict(causal=causal, scale=d**-0.5)
        dead = seg == 0
        ranges_before = fa._launch_ranges.launches
        o, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
        ranges_counted = fa._launch_ranges.launches == ranges_before + 1
        o_ref, lse_ref = flash_fwd_plain_by_head(q, k, v, seg, seg, **kw)
        fwd_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        fwd_ok = (fwd_err <= OUT_ATOL and lse_err <= LSE_ATOL and bool(torch.all(o[dead] == 0))
                  and ranges_counted)
        del o_ref, lse_ref
        ref = flash_bwd_plain_by_head(q, k, v, seg, seg, o, lse, do, **kw)
        got = fa.flash_bwd(q, k, v, seg, seg, o, lse, do, **kw)
        again = fa.flash_bwd(q, k, v, seg, seg, o, lse, do, **kw)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
        errs, rels, zeros = {}, {}, True
        for gname, x, r in zip(("dq", "dk", "dv"), got, ref):
            errs[gname] = (x.float() - r.float()).abs().max().item()
            rels[gname] = errs[gname] / r.float().abs().max().item()
            zeros = zeros and bool(torch.isfinite(x.float()).all()) and bool(torch.all(x[dead] == 0))
        del ref, got, again
        delta, q_rng, kv_rng = fa._launch_bwd_prep(do, o, seg, seg)
        want = fa.flash_bwd_prep_plain(do, o, seg, seg)
        prep_err = (delta - want[0]).abs().max().item()
        ranges_equal = torch.equal(q_rng, want[1]) and torch.equal(kv_rng, want[2])
        live_share = fa.live_tile_pairs(q_rng, kv_rng, causal).float().mean().item()
        n_tile_pairs = q_rng.shape[0] * q_rng.shape[1] * kv_rng.shape[1]
        fwd_live = fa.fwd_live_tiles(q_rng, kv_rng, causal, 0, s_len, s_len)
        fwd_share = fwd_live.float().mean().item()
        del want
        fwd_plain_ms = cuda_ms(lambda: flash_fwd_plain_by_head(q, k, v, seg, seg, **kw), iters=5, warmup=1)
        fwd_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, seg, seg, **kw))
        plain_ms = cuda_ms(lambda: flash_bwd_plain_by_head(q, k, v, seg, seg, o, lse, do, **kw),
                           iters=5, warmup=1)
        prep_ms = cuda_ms(lambda: fa._launch_bwd_prep(do, o, seg, seg))
        prep_plain_ms = cuda_ms(lambda: fa.flash_bwd_prep_plain(do, o, seg, seg))
        args = (q, k, v, do, lse, delta, seg, seg, q_rng, kv_rng, causal, d**-0.5)
        dq_ms = cuda_ms(lambda: fa._launch_bwd_dq(*args))
        dkv_ms = cuda_ms(lambda: fa._launch_bwd_dkv(*args))
        pair_ms = cuda_ms(lambda: fa.flash_bwd(q, k, v, seg, seg, o, lse, do, **kw))
        # the one PyTorch call for the same function: SDPA, and its backward
        mask = fa.make_attention_mask(seg, seg, causal)[:, None]
        pairs = int(mask.sum())
        g = hq // hkv
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in
                      (q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
        with torch.no_grad():
            fwd_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                        scale=d**-0.5), iters=10)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=d**-0.5)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), iters=10)
        fwd_b, fwd_by = bound_ms(nbytes(q, k, v, o, lse, seg, seg), 4.0 * pairs * hq * d, "bf16")
        prep_b, prep_by = bound_ms(nbytes(do, o, seg, seg, delta, q_rng, kv_rng), 2.0 * do.numel(), "fp32")
        common = nbytes(q, k, v, do, lse, delta, seg, seg, q_rng, kv_rng)
        dq_b, dq_by = bound_ms(common + nbytes(q), 6.0 * pairs * hq * d, "bf16")
        dkv_b, dkv_by = bound_ms(common + nbytes(k, v), 8.0 * pairs * hq * d, "bf16")
        print(f"flash forward {name}: q{tuple(q.shape)} kv{tuple(k.shape)} causal={causal} "
              f"max_abs_err={fwd_err:.3e} lse_err={lse_err:.3e} ms={fwd_ms:.4f} plain_ms={fwd_plain_ms:.4f} "
              f"sdpa_ms={fwd_lib_ms:.4f} bound_ms={fwd_b:.5f} ({fwd_by}) live_tile_share={fwd_share:.4f} "
              f"(of {fwd_live.numel()} tile pairs of {fa.FWD_Q_ROWS} x {fa.FWD_KV_ROWS} rows); range launch "
              f"counted once={ranges_counted}", flush=True)
        print(f"flash backward {name}: q{tuple(q.shape)} kv{tuple(k.shape)} causal={causal} "
              f"max_abs_err dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e} "
              f"(of max |grad|: {rels['dq']:.2e} {rels['dk']:.2e} {rels['dv']:.2e}, tol {BWD_REL_TOL}) "
              f"padding_rows_zero={zeros} bit_identical_twice={deterministic} "
              f"live_tile_share={live_share:.4f} (of {n_tile_pairs} tile pairs; "
              f"unmasked pair share {pairs / (bb * s_len * s_len):.4f}) "
              f"prep_ms={prep_ms:.4f} (plain {prep_plain_ms:.4f}, bound {prep_b:.5f}, {prep_by}; "
              f"delta err {prep_err:.2e}, ranges equal {ranges_equal}) "
              f"dq_ms={dq_ms:.4f} (bound {dq_b:.5f}, {dq_by}) "
              f"dkv_ms={dkv_ms:.4f} (bound {dkv_b:.5f}, {dkv_by}) pair_ms={pair_ms:.4f} "
              f"(pre-pass + dQ + dK/dV, one call) plain_ms={plain_ms:.4f} sdpa_bwd_ms={lib_ms:.4f}", flush=True)
        if not fwd_ok:
            raise AssertionError(f"flash kernel disagrees with plain on {name}")
        if not (max(rels.values()) <= BWD_REL_TOL and zeros):
            raise AssertionError(f"flash backward kernels disagree with plain on {name}")
        if not deterministic:
            raise AssertionError(f"flash backward kernels gave two different results on {name}")
        if not (prep_err <= PREP_DELTA_ATOL and ranges_equal):
            raise AssertionError(f"flash backward pre-pass disagrees with plain on {name}")
        fwd_cases.append(dict(shape=name, max_abs_err=fwd_err, lse_err=lse_err, ms=fwd_ms,
                              plain_ms=fwd_plain_ms, bound_ms=fwd_b, bound_by=fwd_by, library_ms=fwd_lib_ms,
                              live_tile_share=fwd_share))
        bwd = dict(pair_ms=pair_ms, sdpa_bwd_ms=lib_ms, live_tile_share=live_share,
                   bit_identical_twice=deterministic)
        prep_cases.append(dict(shape=name, max_abs_err=prep_err, ms=prep_ms, plain_ms=prep_plain_ms,
                               bound_ms=prep_b, bound_by=prep_by, library_ms=None, **bwd))
        dq_cases.append(dict(shape=name, max_abs_err=errs["dq"], rel_err=rels["dq"], ms=dq_ms,
                             plain_ms=plain_ms, bound_ms=dq_b, bound_by=dq_by, library_ms=lib_ms, **bwd))
        dkv_cases.append(dict(shape=name, max_abs_err=max(errs["dk"], errs["dv"]),
                              rel_err=max(rels["dk"], rels["dv"]), ms=dkv_ms, plain_ms=plain_ms,
                              bound_ms=dkv_b, bound_by=dkv_by, library_ms=lib_ms, **bwd))
        del q, k, v, do, o, lse, delta, q_rng, kv_rng, fwd_live, args, mask, qt, kt, vt, out, dot
        torch.cuda.empty_cache()
    return fwd_cases, prep_cases, dq_cases, dkv_cases


def check_decode(dev, cfg, rows: int, width: int, prompt_len: int, label: str = "sampled_call_cache"):
    """Dense decode kernel vs plain at the sampled call's cache shape."""
    rng = np.random.default_rng(2)
    tc = cfg.text
    shape = (tc.num_hidden_layers, rows, tc.num_key_value_heads, width, tc.head_dim)
    kc, vc = randn_bf16(rng, dev, *shape), randn_bf16(rng, dev, *shape)
    q = randn_bf16(rng, dev, rows, tc.num_attention_heads, tc.head_dim)
    seg = torch.zeros((rows, width), dtype=torch.int32, device=dev)
    seg[:, : prompt_len + MAX_NEW_TOKENS // 2] = 1
    seg[0, :100] = 0  # left padding
    layer = tc.num_hidden_layers - 1
    scale = tc.head_dim**-0.5
    ref = da.decode_attention_plain(q, kc, vc, seg, layer, scale)
    out = da.decode_attention(q, kc, vc, seg, layer)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    plan, twice = decode_plan_and_twice(q, kc, vc, seg, layer)
    plain_ms = cuda_ms(lambda: da.decode_attention_plain(q, kc, vc, seg, layer, scale))
    ms = cuda_ms(lambda: da.decode_attention(q, kc, vc, seg, layer))
    g = tc.num_attention_heads // tc.num_key_value_heads
    qt = q[:, :, None, :]
    kt = kc[layer].repeat_interleave(g, dim=1)
    vt = vc[layer].repeat_interleave(g, dim=1)
    mask = (seg != 0)[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale))
    cells = int(seg.sum())
    cell_bytes = 2 * tc.num_key_value_heads * tc.head_dim * 2  # k and v, bf16
    b_ms, b_by = bound_ms(cells * cell_bytes + nbytes(q, out, seg),
                          4.0 * cells * tc.num_attention_heads * tc.head_dim, "bf16")
    print(f"decode [{label}]: q{tuple(q.shape)} cache{tuple(kc.shape)} layer={layer} max_abs_err={err:.3e} "
          f"bit_identical_twice={twice} ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}) plan={json.dumps(plan)}", flush=True)
    if not (err <= OUT_ATOL and twice):
        raise AssertionError("decode kernel disagrees with plain or with itself")
    return [dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, bit_identical_twice=twice, plan=plan)]


def decode_plan_and_twice(q, kc, vc, seg, layer, ks=None, vs=None, i8=False):
    """(the split kernel's plan of a call as a dict; whether two more calls
    agree bit for bit)."""
    int4 = kc.dtype == torch.uint8
    mode = (da.MODE_INT4_I8 if i8 else da.MODE_INT4) if int4 else da.MODE_BF16 if ks is None else da.MODE_INT8
    plan = da.decode_plan(q.shape[0], kc.shape[2], q.shape[1] // kc.shape[2], seg.shape[1], mode,
                          sms=pa.device_sms(q.device.index)).__dict__
    first = da.decode_attention(q, kc, vc, seg, layer, ks, vs, int4_i8dot=i8)
    second = da.decode_attention(q, kc, vc, seg, layer, ks, vs, int4_i8dot=i8)
    torch.cuda.synchronize()
    return plan, bool(torch.equal(first, second))


def check_decode_quant(dev, cfg, kind: str, rows: int, width: int, prompt_len: int, label: str = ""):
    """A quantized dense-decode kernel vs the plain version at the trainer's
    dense-engine shape (path f): every row of the rollout batch mid-generation
    over the full layer stack, random stored values and scales, ragged
    ``kv_seg`` (left padding per row, the unwritten tail) and one row with no
    valid cell."""
    rng = np.random.default_rng({"int8": 12, "int4": 13, "int4_i8": 14}[kind])
    tc = cfg.text
    hq, hkv, d, n_layers = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim, tc.num_hidden_layers
    int4 = kind != "int8"
    shape = (n_layers, rows, hkv, width // 2 if int4 else width, d)
    gen = torch.Generator(device=dev).manual_seed(15)
    lo, hi, dtype = (0, 256, torch.uint8) if int4 else (-127, 128, torch.int8)
    kc = torch.randint(lo, hi, shape, dtype=dtype, device=dev, generator=gen)
    vc = torch.randint(lo, hi, shape, dtype=dtype, device=dev, generator=gen)
    s_lo, s_hi = (0.01, 0.1) if int4 else (0.001, 0.02)
    ks, vs = ((torch.rand((n_layers, rows, hkv, width), device=dev, generator=gen) * (s_hi - s_lo) + s_lo)
              .to(torch.bfloat16) for _ in range(2))
    q = randn_bf16(rng, dev, rows, hq, d)
    seg_np = np.zeros((rows, width), np.int32)
    pads = rng.integers(0, 120, size=rows)
    for i, pad in enumerate(pads):
        seg_np[i, pad : prompt_len + MAX_NEW_TOKENS // 2] = 1
    seg_np[rows - 1] = 0  # a row with no valid cell
    seg = torch.from_numpy(seg_np).to(dev)
    return decode_quant_case(cfg, kind, q, kc, vc, seg, n_layers - 1, ks, vs,
                             label or f"{kind}_cache_{rows}_rows_width_{width}")


def decode_quant_case(cfg, kind: str, q, kc, vc, seg, layer: int, ks, vs, label: str):
    """One quantized dense-decode call, kernel vs plain version on the same
    inputs: the largest difference, the rows with no valid cell left at 0,
    two more calls bit-identical, the plan, both times (and the kernel's
    µs a call queued back to back), the bound from the valid cells, and SDPA on
    the layer's DEQUANTIZED bf16 cache as the library yardstick (the
    dequantization is not timed)."""
    tc = cfg.text
    hq, hkv, d = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    int4, i8 = kind != "int8", kind == "int4_i8"
    scale = d**-0.5
    ref = da.decode_attention_plain(q, kc, vc, seg, layer, scale, ks, vs, i8)
    out = da.decode_attention(q, kc, vc, seg, layer, ks, vs, int4_i8dot=i8)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    dead = (seg == 0).all(dim=1)
    dead_ok = bool(torch.all(out[dead] == 0))
    plan, twice = decode_plan_and_twice(q, kc, vc, seg, layer, ks, vs, i8)
    plain_ms = cuda_ms(lambda: da.decode_attention_plain(q, kc, vc, seg, layer, scale, ks, vs, i8), iters=10)
    ms = cuda_ms(lambda: da.decode_attention(q, kc, vc, seg, layer, ks, vs, int4_i8dot=i8))
    dev_us = queued_us(lambda: da.decode_attention(q, kc, vc, seg, layer, ks, vs, int4_i8dot=i8))
    g = hq // hkv

    def dequantized(cache, scales):
        vals = cache[layer]
        if int4:
            vals = torch.cat([(vals & 15).to(torch.int8) - 8, (vals >> 4).to(torch.int8) - 8], dim=2)
        return (vals.float() * scales[layer].float()[..., None]).to(torch.bfloat16).repeat_interleave(g, dim=1)

    kt, vt = dequantized(kc, ks), dequantized(vc, vs)
    qt = q[:, :, None, :]
    mask = (seg != 0)[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale))
    cells = int((seg != 0).sum())
    cell_bytes = 2 * hkv * (d * (0.5 if int4 else 1.0) + 2)  # k and v values + bf16 scales
    b_ms, b_by = bound_ms(cells * cell_bytes + nbytes(q, out, seg), 4.0 * cells * hq * d,
                          "int8" if i8 else "bf16")
    print(f"decode {kind} [{label}]: q{tuple(q.shape)} cache{tuple(kc.shape)} cells={cells} "
          f"rows_without_cells={int(dead.sum())} cache_bytes_per_launch="
          f"{nbytes(kc[layer], vc[layer], ks[layer], vs[layer])} layer={layer} max_abs_err={err:.3e} "
          f"ms={ms:.4f} queued_us={dev_us:.2f} plain_ms={plain_ms:.4f} sdpa_dequantized_ms={lib_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}) bit_identical_twice={twice} plan={json.dumps(plan)}", flush=True)
    if not (err <= DECODE_QUANT_ATOL and dead_ok and twice):
        raise AssertionError(f"decode kernel ({kind}, {label}) disagrees with plain or with itself")
    return [dict(shape=label, max_abs_err=err, ms=ms, queued_us=dev_us, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib_ms, bit_identical_twice=twice, plan=plan)]


@contextmanager
def record_call(module, name: str, pick: int, when=None, keep=None):
    """Pass every call of ``module.name`` through and keep a copy of the
    tensors of call number ``pick`` (from 0; counting only the calls for which
    ``when(*args, **kwargs)`` holds, if given): the real inputs a main path
    gave a kernel, to hold the kernel against its plain version afterwards.
    ``keep(args, kwargs) -> (args, kwargs)`` makes the copy instead (a
    paged call's pool cut to its pages)."""
    real = getattr(module, name)
    seen, kept = [0], {}

    def copy_of(a):
        if isinstance(a, tuple):
            return tuple(copy_of(x) for x in a)
        return a.clone() if isinstance(a, torch.Tensor) else a

    def recording(*args, **kwargs):
        if when is None or when(*args, **kwargs):
            if seen[0] == pick and keep is not None:
                kept["args"], kept["kwargs"] = keep(args, kwargs)
            elif seen[0] == pick:
                kept["args"] = tuple(copy_of(a) for a in args)
                kept["kwargs"] = {k: copy_of(v) for k, v in kwargs.items()}
            seen[0] += 1
        return real(*args, **kwargs)

    recording.launches = getattr(real, "launches", 0)
    setattr(module, name, recording)
    try:
        yield kept
    finally:
        setattr(module, name, real)
    if "args" not in kept:
        raise AssertionError(f"{name} was called {seen[0]} times, not the {pick + 1} needed to record one")


def decode_pick(cfg) -> int:
    """The decode-attention call to record: the last layer at the middle decode step."""
    layers = cfg.text.num_hidden_layers
    return layers * (MAX_NEW_TOKENS // 2) + layers - 1


def recorded_decode_case(cfg, kind: str, rec, path: str):
    """The kernel vs its plain version on the inputs one continuous-engine
    decode call really had (``decode_pick``: the slot cache with the prompt,
    the unwritten gap and the ring cells; the trash and padding lanes
    without a valid cell)."""
    q, kc, vc, seg, layer, ks, vs = rec["args"]
    if rec["kwargs"].get("int4_i8dot", False) != (kind == "int4_i8"):
        raise AssertionError(f"recorded decode call is not the {kind} mode")
    label = f"{path}_{q.shape[0]}_lanes_step_{MAX_NEW_TOKENS // 2}_width_{seg.shape[1]}"
    return decode_quant_case(cfg, kind, q, kc, vc, seg, layer, ks, vs, label)


PAGED_MODES = {"bf16": pa.MODE_BF16, "int8": pa.MODE_INT8, "int4_i8": pa.MODE_INT4_I8, "int4": pa.MODE_INT4}


def paged_plan_and_twice(kind: str, args, staged=None):
    """(the mode's plan as a dict; whether two more calls of the kernel agree
    bit for bit)."""
    q, k, table = args[0], args[1], args[3]
    ring = 0 if staged is None else staged[0].shape[3]
    plan = pa.paged_plan(q.shape[0], k.shape[2], q.shape[1] // k.shape[2], pa._page_cells(k), table.shape[1],
                         ring, sms=pa.device_sms(q.device.index), mode=PAGED_MODES[kind]).__dict__
    kw = dict(return_stats=True, int4_i8dot=kind == "int4_i8", staged=staged)
    first, second = pa.paged_attention(*args, **kw), pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    return plan, all(torch.equal(a, b) for a, b in zip(first, second))


def check_paged(dev, cfg, kind: str, lanes: int, prompt_len: int, page: int, n_pages: int):
    """A paged kernel vs its plain version at the paged path's shapes: every
    lane of the engine (the trash lane has length 0) mid-generation, pages
    scattered over a pool of the path's size, the last layer."""
    rng = np.random.default_rng({"bf16": 3, "int8": 4, "int4_i8": 5, "int4": 5}[kind])
    packed = kind in ("int4_i8", "int4")
    tc = cfg.text
    hq, hkv, d, n_layers = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim, tc.num_hidden_layers
    lengths = rng.integers(prompt_len - 90, prompt_len + MAX_NEW_TOKENS - 16, size=lanes)
    lengths[-1] = 0
    per_slot = -(-(prompt_len + MAX_NEW_TOKENS) // page) + 1
    table = np.zeros((lanes, per_slot), np.int32)
    for i, ell in enumerate(lengths):
        n = -(-int(ell) // page)
        table[i, :n] = rng.choice(np.arange(1, n_pages), size=n, replace=False)
    rows = page // 2 if packed else page
    shape = (n_layers, n_pages, hkv, rows, d)
    scales = (None, None)
    if kind == "bf16":
        k, v = randn_bf16(rng, dev, *shape), randn_bf16(rng, dev, *shape)
    else:
        dtype, lo, hi = (torch.uint8, 0, 256) if packed else (torch.int8, -127, 128)
        gen = torch.Generator(device=dev).manual_seed(7)
        k = torch.randint(lo, hi, shape, dtype=dtype, device=dev, generator=gen)
        v = torch.randint(lo, hi, shape, dtype=dtype, device=dev, generator=gen)
        s_lo, s_hi = (0.01, 0.1) if packed else (0.001, 0.02)
        scales = tuple(
            (torch.rand(shape[:3] + (page,), device=dev, generator=gen) * (s_hi - s_lo) + s_lo).to(torch.bfloat16)
            for _ in range(2)
        )
    q = randn_bf16(rng, dev, lanes, hq, d)
    layer = n_layers - 1
    args = (q, k, v, torch.from_numpy(table).to(dev), torch.from_numpy(lengths.astype(np.int32)).to(dev),
            layer, *scales)
    i8 = kind == "int4_i8"
    plain = {"int4_i8": pa.paged_attention_int4_i8_plain,
             "int4": pa.paged_attention_int4_plain}.get(kind, pa.paged_attention_plain)
    scale = d**-0.5
    o_ref, m_ref, l_ref = plain(*args, scale)
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=i8)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    stat_err = max((m - m_ref).abs().max().item(), ((l - l_ref).abs() / (1 + l_ref.abs())).max().item())
    dead_ok = bool(torch.all(o[-1] == 0) and torch.all(l[-1] == 0))
    plan, twice = paged_plan_and_twice(kind, args)
    plain_ms = cuda_ms(lambda: plain(*args, scale), iters=10)
    ms = cuda_ms(lambda: pa.paged_attention(*args, return_stats=True, int4_i8dot=i8))
    cells = int(lengths.sum())
    value_bytes = {"bf16": 2.0, "int8": 1.0, "int4_i8": 0.5, "int4": 0.5}[kind]
    cell_bytes = 2 * hkv * (d * value_bytes + (0 if kind == "bf16" else 2))  # k and v (+ scales)
    b_ms, b_by = bound_ms(cells * cell_bytes + nbytes(q, o, m, l, args[3], args[4]),
                          4.0 * cells * hq * d, "int8" if i8 else "bf16")
    print(f"paged {kind}: q{tuple(q.shape)} pool{tuple(k.shape)} page={page} cells={cells} layer={layer} "
          f"max_abs_err={err:.3e} stat_err={stat_err:.3e} bit_identical_twice={twice} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) plan={json.dumps(plan)}", flush=True)
    if not (err <= PAGED_OUT_ATOL[kind] and stat_err <= PAGED_STAT_ATOL and dead_ok and twice):
        raise AssertionError(f"paged kernel ({kind}) disagrees with plain or with itself")
    return dict(shape=f"{kind}_pools_{lanes}_lanes", max_abs_err=err, stat_err=stat_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, bit_identical_twice=twice,
                plan=plan)


def check_paged_shipped(dev, kind: str = "int4_i8"):
    """A paged kernel at the shipped scale (``scripts/spatialthinker_3b_grpo.sh``:
    decode batch 128 + the trash lane, page 1024, prompt 6,144 + response
    2,048), on ``paged_cases.py``'s inputs: 16 groups of 8 lanes sharing
    their prompt pages and owning their response pages, a one-layer pool of
    ``kind``'s format (int4 for #9 and #8, int8 and bf16 for #7). The bound
    counts each distinct page's live cells once."""
    case = paged_cases.make_shipped(torch, np, dev, kind={"int4_i8": "int4"}.get(kind, kind))
    q = case["q"]
    args = paged_cases.call_args(torch, case, dev)
    scale = q.shape[-1] ** -0.5
    i8 = kind == "int4_i8"
    plain = {"int4_i8": pa.paged_attention_int4_i8_plain,
             "int4": pa.paged_attention_int4_plain}.get(kind, pa.paged_attention_plain)
    o_ref, m_ref, l_ref = plain(*args, scale)
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=i8)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    stat_err = max((m - m_ref).abs().max().item(), ((l - l_ref).abs() / (1 + l_ref.abs())).max().item())
    dead_ok = bool(torch.all(o[-1] == 0) and torch.all(l[-1] == 0) and torch.all(m[-1] == pa.NEG_INF))
    plan, twice = paged_plan_and_twice(kind, args)
    plain_ms = cuda_ms(lambda: plain(*args, scale), iters=5)
    ms = cuda_ms(lambda: pa.paged_attention(*args, return_stats=True, int4_i8dot=i8))
    cells = int(case["lengths"].sum())
    b_ms, b_by = bound_ms(paged_cases.bound_bytes(case, distinct=True), 4.0 * cells * q.shape[1] * q.shape[2],
                          "int8" if i8 else "bf16")
    label = f"{kind}_pools_shipped_{q.shape[0]}_lanes_page_{case['page']}"
    print(f"paged {kind} [{label}]: q{tuple(q.shape)} pool{tuple(case['k'].shape)} cells={cells} "
          f"max_abs_err={err:.3e} stat_err={stat_err:.3e} bit_identical_twice={twice} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}, distinct pages) plan={json.dumps(plan)}", flush=True)
    if not (err <= PAGED_OUT_ATOL[kind] and stat_err <= PAGED_STAT_ATOL and dead_ok and twice):
        raise AssertionError(f"paged kernel ({kind}) disagrees with plain or with itself [{label}]")
    return dict(shape=label, max_abs_err=err, stat_err=stat_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, bit_identical_twice=twice, plan=plan)


def w8a8_linears(cfg) -> dict:
    """The five W8A8 products of a decode step: (K, N, output dtype)."""
    tc = cfg.text
    hd = tc.head_dim
    return {
        "qkv": (tc.hidden_size, (tc.num_attention_heads + 2 * tc.num_key_value_heads) * hd, torch.bfloat16),
        "o": (tc.num_attention_heads * hd, tc.hidden_size, torch.bfloat16),
        "gate_up": (tc.hidden_size, 2 * tc.intermediate_size, torch.bfloat16),
        "down": (tc.intermediate_size, tc.hidden_size, torch.bfloat16),
        "head": (tc.hidden_size, tc.vocab_size, torch.float32),  # the tied head's fp32 logits
    }


def w8a8_case(x, w, ws, out_dtype, label: str) -> dict:
    """Kernel A (quantize prologue + int8 GEMM + epilogue) vs the plain chain
    on the same inputs: bit-equal; times of both, of ``torch._int_mm`` alone on
    the pre-quantized x (the library call for the dot; yardstick only) and the
    bound (x, w, scales read once, the output written once; 2 m N K int8
    operations)."""
    out = i8m.fused_w8a8_matmul(x, w, ws, out_dtype)
    ref = i8m.fused_w8a8_matmul_plain(x, w, ws, out_dtype)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    equal = torch.equal(out, ref)
    xq, _ = i8m.quantize_rows(x)
    w_kn = w.t()
    ms = cuda_ms(lambda: i8m.fused_w8a8_matmul(x, w, ws, out_dtype))
    plain_ms = cuda_ms(lambda: i8m.fused_w8a8_matmul_plain(x, w, ws, out_dtype), iters=10)
    lib_ms = cuda_ms(lambda: i8m.int8_matmul(xq, w_kn))
    (m, k), n = x.shape, w.shape[0]
    b_ms, b_by = bound_ms(nbytes(x, w, ws, out), 2.0 * m * n * k, "int8")
    plan = i8m.w8a8_plan(m, n, k).describe()
    print(f"w8a8 [{label}]: x{tuple(x.shape)} {str(x.dtype)[6:]} w({n}, {k}) -> {str(out_dtype)[6:]} "
          f"max_abs_err={err:.3e} bit_equal={equal} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"int_mm_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) plan={json.dumps(plan)}", flush=True)
    if not equal:
        raise AssertionError(f"W8A8 kernel differs from the plain chain [{label}]")
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, plan=plan)


def check_w8a8(dev, cfg) -> list:
    """Kernel A at the five 3B linears and ``W8A8_MS`` rows, on seeded int8
    weights with per-row scales (the ``QuantLinear`` layout)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for name, (k, n, out_dtype) in w8a8_linears(cfg).items():
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-4
        for m in W8A8_MS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            cases.append(w8a8_case(x, w, ws, out_dtype, f"{name}_m{m}"))
        del w, ws
        torch.cuda.empty_cache()
    return cases


def recorded_w8a8_case(rec, label: str) -> dict:
    """Kernel A vs the plain chain on one call a main path really made."""
    x, w, ws, out_dtype = rec["args"]
    return w8a8_case(x, w, ws, out_dtype, f"{label}_m{x.shape[0]}_n{w.shape[0]}")


def staged_case(rec, kind: str, label: str) -> dict:
    """The paged kernel with its staged block vs the plain version with the
    same ring, on one recorded decode call (mid-chunk: ring cells live); timed
    with and without the ring. Bound: the live pool and ring cells' bytes
    (k, v and their scales) plus q, the table, the lengths, the ring's
    validity and the outputs; 4 Hq D operations per live cell."""
    args, kw = rec["args"], rec["kwargs"]
    q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale = args
    staged, i8 = kw["staged"], kw.get("int4_i8dot", False)
    if i8 != (kind == "int4_i8") or staged is None:
        raise AssertionError(f"recorded paged call is not the fused {kind} mode")
    plain = {"int4_i8": pa.paged_attention_int4_i8_plain,
             "int4": pa.paged_attention_int4_plain}.get(kind, pa.paged_attention_plain)
    scale = q.shape[-1] ** -0.5
    o_ref, m_ref, l_ref = plain(*args, scale, staged)
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=i8, staged=staged)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    stat_err = max((m - m_ref).abs().max().item(), ((l - l_ref).abs() / (1 + l_ref.abs())).max().item())
    plan, twice = paged_plan_and_twice(kind, args, staged)
    ms = cuda_ms(lambda: pa.paged_attention(*args, return_stats=True, int4_i8dot=i8, staged=staged))
    ms_pool_only = cuda_ms(lambda: pa.paged_attention(*args, return_stats=True, int4_i8dot=i8))
    plain_ms = cuda_ms(lambda: plain(*args, scale, staged), iters=5)
    hq, d = q.shape[1], q.shape[2]
    hkv = k_pool.shape[2]
    cells, ring = int(lengths.sum()), int((staged[4] != 0).sum())
    value_bytes = {"bf16": 2.0, "int8": 1.0, "int4_i8": 0.5, "int4": 0.5}[kind]
    scale_bytes = 0 if kind == "bf16" else 2
    pool_bytes = cells * 2 * hkv * (d * value_bytes + scale_bytes)
    ring_bytes = ring * 2 * hkv * (d * (2 if kind == "bf16" else 1) + scale_bytes)
    b_ms, b_by = bound_ms(pool_bytes + ring_bytes + nbytes(q, o, m, l, table, lengths, staged[4]),
                          4.0 * (cells + ring) * hq * d, "int8" if i8 else "bf16")
    print(f"staged {kind} [{label}]: q{tuple(q.shape)} pool cells {cells} ring cells {ring} of "
          f"{tuple(staged[4].shape)} layer {layer} max_abs_err={err:.3e} stat_err={stat_err:.3e} "
          f"bit_identical_twice={twice} ms={ms:.4f} (without the ring {ms_pool_only:.4f}) "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) plan={json.dumps(plan)}", flush=True)
    if not (ring > 0 and err <= PAGED_OUT_ATOL[kind] and stat_err <= PAGED_STAT_ATOL and twice):
        raise AssertionError(f"paged kernel with its staged block ({kind}) disagrees with plain or with itself "
                             f"[{label}]")
    return dict(shape=f"{label}_{kind}_{q.shape[0]}_lanes_{ring}_ring_cells", max_abs_err=err,
                stat_err=stat_err, ms=ms, ms_without_ring=ms_pool_only, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, bit_identical_twice=twice, plan=plan)


def check_silu(dev, cfg, m: int):
    """silu -> int8 junction kernel vs plain at the prefill's (rows x chunk, 2I)."""
    rng = np.random.default_rng(6)
    return silu_case(randn_bf16(rng, dev, m, 2 * cfg.text.intermediate_size), f"prefill_rows_{m}")


def silu_case(gu, label: str):
    m, inter = gu.shape[0], gu.shape[1] // 2
    q_ref, s_ref = sq.fused_silu_quantize_plain(gu)
    q, s = sq.fused_silu_quantize(gu)
    q2, s2 = sq.fused_silu_quantize(gu)
    torch.cuda.synchronize()
    diff = (q.int() - q_ref.int()).abs()
    err = float(diff.max())
    flips = float((diff != 0).float().mean())
    scale_err = ((s - s_ref).abs() / s_ref).max().item()
    bit_equal = bool(torch.equal(q, q_ref) and torch.equal(s, s_ref))
    twice = bool(torch.equal(q, q2) and torch.equal(s, s2))
    plan = sq.silu_plan(inter).__dict__
    plain_ms = cuda_ms(lambda: sq.fused_silu_quantize_plain(gu), iters=10)
    ms = cuda_ms(lambda: sq.fused_silu_quantize(gu))
    b_ms, b_by = bound_ms(nbytes(gu, q, s), 12.0 * m * inter, "fp32")
    print(f"silu_quant [{label}]: gu{tuple(gu.shape)} max_abs_err={err:.0f} (int8 steps) differing={flips:.2e} "
          f"scale_rel_err={scale_err:.2e} bit_equal_to_plain={bit_equal} bit_identical_twice={twice} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) plan={json.dumps(plan)}", flush=True)
    if not (err <= 1 and flips < 1e-2 and scale_err <= SILU_SCALE_RTOL and twice):
        raise AssertionError(f"silu_quant kernel disagrees with plain or with itself ({label})")
    return [dict(shape=label, max_abs_err=err, differing=flips, scale_rel_err=scale_err, bit_equal_to_plain=bit_equal,
                 bit_identical_twice=twice, plan=plan, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=None)]


def device_us(fn, calls: int = 20) -> float:
    """The profiler's device µs of a call (every kernel the call launches)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events() if e.device_type.name == "CUDA") / calls


def _int4_case(name, m, fn, plain_fn, lib_fn, n_bytes, n_ops, plan):
    ref = plain_fn()
    out = fn()
    again = fn()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    plain_ms = cuda_ms(plain_fn, iters=5, warmup=1)
    ms = cuda_ms(fn)
    lib_ms = cuda_ms(lib_fn)
    b_ms, b_by = bound_ms(n_bytes(out), n_ops, "int8")
    return out, dict(shape=f"{name}_m{m}", max_abs_err=err, rel_err=rel,
                     bit_identical_twice=bool(torch.equal(out, again)), ms=ms, device_us=device_us(fn),
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, plan=plan.describe())


def check_int4(dev, cfg, m: int):
    """The int4 MLP kernels (#13 gate_up + silu, #14 down) vs their plain
    versions at the 3B widths and ``m`` rows, group 128; down takes the
    gate_up output as its input. Library yardstick: ``torch._int_mm`` on the
    INT8 copy of the same weights at the same m on pre-quantized rows (plus
    silu * up for gate_up) — int8 weights, yardstick only: no PyTorch call
    computes the int4 function."""
    rng = np.random.default_rng(30 + m)
    tc = cfg.text
    e, inter = tc.hidden_size, tc.intermediate_size
    gen = torch.Generator(device=dev).manual_seed(31)
    gu_w = torch.randn((2 * inter, e), device=dev, generator=gen) * 0.02
    dn_w = torch.randn((e, inter), device=dev, generator=gen) * 0.02
    gu4, dn4 = i4.Int4Weight.from_weight(gu_w, 128), i4.Int4Weight.from_weight(dn_w, 128)
    gu8, dn8 = quantize_weight(gu_w, 1)["qvalue"], quantize_weight(dn_w, 1)["qvalue"]  # the W8A8 copies
    del gu_w, dn_w
    x = randn_bf16(rng, dev, m, e)
    xq, _ = quantize_activation(x)

    def gateup_lib():
        acc = int8_matmul(xq, gu8.t())
        return F.silu(acc[:, :inter].float()) * acc[:, inter:].float()

    sms = pa.device_sms(dev.index)
    h, gu_case = _int4_case(
        "gate_up", m, lambda: i4.w4_gateup_silu(x, gu4), lambda: i4.w4_gateup_silu_plain(x, gu4.q4, gu4.gscale),
        gateup_lib, lambda out: nbytes(x, gu4.q4, gu4.gscale, out), 2.0 * m * e * 2 * inter,
        i4.w4_plan(m, e, inter, True, sms))
    hq, _ = quantize_activation(h)
    dn_plan = i4.w4_plan(m, inter, e, False, sms)
    _, dn_case = _int4_case(
        "down", m, lambda: i4.w4_matmul(h, dn4), lambda: i4.w4_matmul_plain(h, dn4.q4, dn4.gscale),
        lambda: int8_matmul(hq, dn8.t()), lambda out: nbytes(h, dn4.q4, dn4.gscale, out),
        2.0 * m * inter * e, dn_plan)
    _, f32_case = _int4_case(
        "down_f32", m, lambda: i4.w4_matmul(h, dn4, torch.float32),
        lambda: i4.w4_matmul_plain(h, dn4.q4, dn4.gscale, torch.float32),
        lambda: int8_matmul(hq, dn8.t()), lambda out: nbytes(h, dn4.q4, dn4.gscale, out),
        2.0 * m * inter * e, dn_plan)
    for name, c, tol in (("gate_up+silu", gu_case, INT4_REL_TOL), ("down", dn_case, INT4_REL_TOL),
                         ("down fp32", f32_case, INT4_F32_REL_TOL)):
        print(f"int4 {name}: m={m} E={e} I={inter} group 128 max_abs_err={c['max_abs_err']:.3e} "
              f"(of max |out|: {c['rel_err']:.2e}, tol {tol}) bit_identical_twice={c['bit_identical_twice']} "
              f"ms={c['ms']:.4f} device_us={c['device_us']:.2f} plain_ms={c['plain_ms']:.4f} "
              f"int_mm_int8_weights_ms={c['library_ms']:.4f} bound_ms={c['bound_ms']:.5f} ({c['bound_by']}) "
              f"plan={json.dumps(c['plan'])}", flush=True)
        if not (c["rel_err"] <= tol and c["bit_identical_twice"]):
            raise AssertionError(f"int4 {name} kernel disagrees with plain or with itself at m={m}")
    return gu_case, [dn_case, f32_case]


def check_int4_fallback(dev, cfg):
    """One 3B MLP of a w4a8 copy at m = INT4_FALLBACK_M, where the JAX
    package's rule admits gate_up and refuses down: the whole MLP takes the
    int8 path (equal to the same MLP with the int4 copies switched off) and
    neither int4 kernel launches. At m = 136 both launch and the result is
    the int4 function's."""
    tc = cfg.text
    gen = torch.Generator(device=dev).manual_seed(33)
    mlp = MLP(tc, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        for lin in (mlp.gate_up_proj, mlp.down_proj):
            lin.weight.normal_(0.0, 0.02, generator=gen)
    mlp.gate_up_w4 = i4.Int4Weight.from_weight(mlp.gate_up_proj.weight, 128)
    mlp.down_w4 = i4.Int4Weight.from_weight(mlp.down_proj.weight, 128)
    mlp.gate_up_proj = QuantLinear.from_linear(mlp.gate_up_proj)
    mlp.down_proj = QuantLinear.from_linear(mlp.down_proj)
    out = {}
    for m in (INT4_FALLBACK_M, INT4_MS[0]):
        x = randn_bf16(np.random.default_rng(m), dev, 1, m, tc.hidden_size)
        reset_counts()
        with forbid_plain_versions(), torch.no_grad():
            y = mlp(x)
            torch.cuda.synchronize()
            counts = read_counts()
            mlp.w4 = False
            y8 = mlp(x)
            mlp.w4 = True
        out[m] = dict(gateup=counts["int4_gateup"], down=counts["int4_down"], int8_equal=bool(torch.equal(y, y8)))
    print(f"int4 fallback: m={INT4_FALLBACK_M} launches gate_up {out[INT4_FALLBACK_M]['gateup']} down "
          f"{out[INT4_FALLBACK_M]['down']}, output equal to the int8 path {out[INT4_FALLBACK_M]['int8_equal']}; "
          f"m={INT4_MS[0]} launches {out[INT4_MS[0]]['gateup']} / {out[INT4_MS[0]]['down']}, equal to the int8 "
          f"path {out[INT4_MS[0]]['int8_equal']}", flush=True)
    fb, on = out[INT4_FALLBACK_M], out[INT4_MS[0]]
    if not (fb["gateup"] == fb["down"] == 0 and fb["int8_equal"]
            and on["gateup"] == on["down"] == 1 and not on["int8_equal"]):
        raise AssertionError("the int4 MLP's fallback to the int8 path does not follow the eligibility rule")
    return out


# ---------------------------------------------------------------------------
# model-level checks
# ---------------------------------------------------------------------------


def prefill_logits(model, prep):
    tc = model.cfg.text
    b, p = prep["input_ids"].shape
    cache = KVCache.init(tc.num_hidden_layers, b, p, tc.num_key_value_heads, tc.head_dim,
                         dtype=torch.bfloat16, device=prep["input_ids"].device)
    seg = prep["prompt_segment_ids"].to(torch.int32)
    with torch.no_grad():
        hidden, _ = prefill_forward(model, prep["input_ids"], prep["position_ids"], seg, cache, seg,
                                    vision=prep["vision"])
        return logits_from_hidden(model.text, hidden[:, -1, :])


@torch.no_grad()
def teacher_forced_logps(model, prep, responses, mask):
    """Log-probs (T = 1) of ``responses`` (B, R) under ``model`` run over
    prompt + response in one forward — what a trainer recomputes."""
    dev = prep["input_ids"].device
    resp = torch.as_tensor(responses, device=dev)
    m = torch.as_tensor(mask, device=dev).to(torch.int32)
    b, p = prep["input_ids"].shape
    r = resp.shape[1]
    ids = torch.cat([prep["input_ids"], resp], dim=1)
    seg = torch.cat([prep["prompt_segment_ids"].to(torch.int32), m], dim=1)
    resp_pos = prep["gen_pos_start"].to(torch.int64)[:, None] + torch.arange(r, device=dev)[None]
    pos = torch.cat([prep["position_ids"], resp_pos[None].expand(3, b, r)], dim=2)
    hidden, _ = forward(model, ids, pos, segment_ids=seg, vision=prep["vision"])
    logits = logits_from_hidden(model.text, hidden[:, p - 1 : p - 1 + r])
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, resp[..., None])[..., 0].cpu().numpy() * np.asarray(mask)


def engine_drift(model, prep, tokens, logp) -> float:
    """Mean |log-prob difference| between an engine's greedy run and the same
    model teacher-forced over the same tokens."""
    ones = np.ones_like(tokens, dtype=np.int32)
    return float(np.abs(np.asarray(logp) - teacher_forced_logps(model, prep, tokens, ones)).mean())


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------


def _objects(items) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    return arr


def prompt_batch(host) -> RolloutBatch:
    """The provider's host inputs as the RolloutBatch a train step starts
    from: one row per prompt, a uid per prompt for the GRPO groups."""
    n = host["input_ids"].shape[0]
    return RolloutBatch(
        tensors={
            "input_ids": host["input_ids"], "segment_ids": host["segment_ids"],
            "position_ids": np.transpose(host["position_ids"], (1, 0, 2)),  # (B, 3, P)
            "gen_pos_start": host["gen_pos_start"],
        },
        non_tensors={
            "patches": _objects(host["patches_list"]), "image_grid_thw": _objects(host["grids_list"]),
            "uid": _objects([f"prompt-{i:03d}" for i in range(n)]),
        },
    )


def grpo_step(model, ref_model, prompts: RolloutBatch, rollout, packed_update, *, step: int,
              group_n: int, score_rng, experience_micro: int, global_batch_size: int,
              micro_rows: int, temperature: float, device):
    """One GRPO step in the order of the JAX package's ``GRPOTrainer.train_step``:
    rollout -> scores -> old log-probs (policy) -> ref log-probs (frozen copy)
    -> GRPO advantages -> packed actor update. ``rollout()`` returns the
    engine's result for ``prompts`` x ``group_n`` (row i*group_n + j = sample
    j of prompt i). The scores are scaffolding: one seeded random number on
    each response's last valid token stands in for the reward functions, which
    are host code outside this package so far. Returns (rolled batch, actor
    metrics, seconds per phase)."""
    timer = Timer()
    with timer("gen"):
        result = rollout()
    repeated = prompts.select(np.repeat(np.arange(len(prompts)), group_n))
    rolled = rollout_batch_from_result(repeated, result.responses, result.response_mask,
                                       result.rollout_log_probs)
    mask = rolled.tensors["response_mask"]
    scores = np.zeros(mask.shape, np.float32)
    scores[np.arange(len(mask)), mask.sum(-1).astype(np.int64) - 1] = score_rng.random(len(mask))
    rolled.tensors["token_level_scores"] = scores
    logp_kw = dict(micro_batch_size=experience_micro, temperature=temperature, device=device)
    with timer("old"):
        rolled.tensors["old_log_probs"] = compute_log_probs_batched(model, rolled, **logp_kw)
    with timer("ref"):
        rolled.tensors["ref_log_probs"] = compute_log_probs_batched(ref_model, rolled, **logp_kw)
    with timer("adv"):
        rolled.tensors["token_level_rewards"] = rolled.tensors["token_level_scores"]
        adv, ret = compute_advantages(rolled, "grpo")
        rolled.tensors["advantages"], rolled.tensors["returns"] = adv, ret
    with timer("update_actor"):
        metrics = update_actor_packed(
            rolled, packed_update, model.cfg.vision, global_batch_size=global_batch_size,
            micro_rows=micro_rows, global_step=step, device=device,
        )
    return rolled, metrics, timer.timing


def checksums(tensors) -> list:
    """One fp64 sum per tensor: equal lists mean nothing moved."""
    return [float(torch.sum(t.detach(), dtype=torch.float64)) for t in tensors]


def training_path(dev, model, qmodel_holder, host, paged_kw, card):
    """Path d: ``GRPO_STEPS`` GRPO steps of ``model`` (3B widths), then the
    checks that need the plain versions or a second forward (outside the
    counted run)."""
    cfg = model.cfg
    prompts = prompt_batch(host)
    host_inputs = (host["input_ids"], host["segment_ids"], host["position_ids"], host["gen_pos_start"])
    ref_model = copy.deepcopy(model).requires_grad_(False)
    ref_sums = checksums(ref_model.parameters())
    optimizer = make_optimizer(TRAIN["lr"], strategy=TRAIN["strategy"])
    inner_update = make_packed_update_fn(model, optimizer, **ACTOR)
    seen = []  # per mini-batch: metrics, rows, fill, tokens
    first_micro = {}  # segment ids the flash kernels get in the first micro-batch of the update

    def packed_update(ptb, vision):
        if not first_micro:
            first_micro.update(seg_text=ptb.segment_ids[0].cpu().numpy(),
                               seg_full=vision.seg_full[0].cpu().numpy(),
                               seg_window=vision.seg_window[0].cpu().numpy(),
                               images=int(vision.seg_full[0].max()))
        metrics = inner_update(ptb, vision)
        live = ptb.segment_ids != 0
        seen.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                         rows=live.shape[0] * live.shape[1], row_len=live.shape[2],
                         tokens=int(live.sum()), fill=float(live.float().mean())))
        return metrics

    def rollout():
        t0 = time.perf_counter()
        if qmodel_holder["model"] is None:  # the policy moved: quantize it again
            qmodel_holder["model"] = quantize_model(model, mode="int8")
            torch.cuda.synchronize()
        qmodel_holder["quantize_s"] = time.perf_counter() - t0
        out = generate_paged(
            qmodel_holder["model"], *host_inputs, sampling=SamplingParams(temperature=1.0),
            generator=torch.Generator(device=dev).manual_seed(20 + len(steps)), **paged_kw)
        qmodel_holder["model"] = None  # free the int8 copy and the pools before the update
        torch.cuda.empty_cache()
        return out

    steps = []
    score_rng = np.random.default_rng(11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rolled = None
    logprob_vision = record_call(fa, "flash_attention", 0,
                                 when=lambda q, *a, **kw: q.shape[1] >= LOGPROB_VISION_MIN_SLOTS)
    with forbid_plain_versions(), logprob_vision as logprob_call:
        for step in range(1, GRPO_STEPS + 1):
            before = read_counts()
            sums_before = checksums(model.parameters())
            n_seen = len(seen)
            rolled, metrics, timing = grpo_step(
                model, ref_model, prompts, rollout, packed_update, step=step,
                group_n=paged_kw["group_n"], score_rng=score_rng,
                experience_micro=TRAIN["experience_micro"],
                global_batch_size=TRAIN["global_batch_size"], micro_rows=TRAIN["micro_rows"],
                temperature=ACTOR["temperature"], device=dev)
            torch.cuda.synchronize()
            after = read_counts()
            sums_after = checksums(model.parameters())
            mask = rolled.tensors["response_mask"].astype(bool)
            drift = np.abs(rolled.tensors["old_log_probs"] - rolled.tensors["rollout_log_probs"])[mask]
            minis = seen[n_seen:]
            info = dict(
                step=step, timing=timing, quantize_s=qmodel_holder["quantize_s"], metrics=metrics,
                first_minibatch=minis[0]["metrics"], optimizer_steps=len(minis),
                update_tokens=sum(m["tokens"] for m in minis), rows=[m["rows"] for m in minis],
                row_len=[m["row_len"] for m in minis], fill=[m["fill"] for m in minis],
                old_vs_rollout=float(drift.mean()),
                tensors_moved=sum(a != b for a, b in zip(sums_before, sums_after)),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                launches={k: after[k] - before[k] for k in after},
            )
            steps.append(info)
            print(f"grpo step {step}: rollout {timing['gen']:.3f} s (quantize_model "
                  f"{info['quantize_s']:.3f} s), old log-probs {timing['old']:.3f} s, ref log-probs "
                  f"{timing['ref']:.3f} s, advantages {timing['adv']:.4f} s, update {timing['update_actor']:.3f} s "
                  f"in {info['optimizer_steps']} optimizer steps; update tokens {info['update_tokens']}, "
                  f"packed rows {info['rows']} x {info['row_len']} fill "
                  f"{[round(f, 3) for f in info['fill']]}; old vs rollout log-probs mean |d| "
                  f"{info['old_vs_rollout']:.4f}; parameter tensors moved {info['tensors_moved']}; "
                  f"peak allocated {info['peak_gb']:.2f} GB, reserved {info['peak_reserved_gb']:.2f} GB of "
                  f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f} GB  [{card}]", flush=True)
            print(f"grpo step {step} metrics: {json.dumps(metrics)}; first mini-batch "
                  f"{json.dumps(info['first_minibatch'])}", flush=True)
            print(f"grpo step {step} launches: {info['launches']}", flush=True)
    launches = read_counts()

    checks = {}
    for info in steps:
        s, first = info["step"], info["first_minibatch"]
        everything = list(info["metrics"].values()) + list(first.values())
        checks[f"step {s}: metrics finite"] = bool(np.isfinite(everything).all())
        checks[f"step {s}: grad norm > 0"] = info["metrics"]["actor/grad_norm"] > 0
        checks[f"step {s}: parameters moved"] = info["tensors_moved"] > 0
        checks[f"step {s}: first mini-batch ppo_kl ~ 0"] = abs(first["actor/ppo_kl"]) < FIRST_MINIBATCH_PPO_KL
        checks[f"step {s}: first mini-batch unclipped"] = (
            first["actor/pg_clipfrac_higher"] < FIRST_MINIBATCH_CLIPFRAC
            and first["actor/pg_clipfrac_lower"] < FIRST_MINIBATCH_CLIPFRAC)
        checks[f"step {s}: old log-probs near the engine's"] = info["old_vs_rollout"] <= PROBS_DIFF_LIMIT
        checks[f"step {s}: optimizer steps"] = (
            info["optimizer_steps"] == len(rolled) // TRAIN["global_batch_size"] >= 2)
        checks[f"step {s}: every kernel of the step launched"] = all(
            info["launches"][k] > 0 for k in ("flash_fwd", "flash_ranges", "flash_bwd_prep", "flash_bwd_dq",
                                              "flash_bwd_dkv",
                                              "paged_attention_int4_i8", "silu_quant", "w8a8"))
        checks[f"step {s}: no torch._int_mm"] = info["launches"]["int_mm"] == 0
    checks["reference copy untouched"] = checksums(ref_model.parameters()) == ref_sums
    checks["optimizer count"] = optimizer.state["count"] == sum(i["optimizer_steps"] for i in steps)

    # a forced non-finite gradient: parameters, moments and count stay as they are
    piece = rolled.select(slice(0, 8))
    ptb_all, vis_all = packed_micro_batches(piece, cfg.vision, micro_rows=1)
    ptb = to_device(type(ptb_all)(*(x[:1] for x in ptb_all)), dev)   # one micro-batch of one row
    vis = vision_to_device(type(vis_all)(*(x[:1] for x in vis_all)), dev)
    p_sums = checksums(model.parameters())
    mu_sums = checksums(optimizer.state["mu"].values())
    count = optimizer.state["count"]
    bad = inner_update(ptb._replace(advantages=ptb.advantages * float("nan")), vis)
    torch.cuda.synchronize()
    checks["non-finite gradient skipped"] = (
        not np.isfinite(float(bad["actor/grad_norm"])) and optimizer.state["count"] == count
        and checksums(model.parameters()) == p_sums
        and checksums(optimizer.state["mu"].values()) == mu_sums)
    optimizer.reset_moments()  # room for two sets of fp32 gradients
    del inner_update
    torch.cuda.empty_cache()

    # the gradient of that row through the whole model: the backward kernels
    # against flash_bwd_plain behind the same kernel forward
    grad_fn = make_packed_grad_fn(model, **ACTOR)
    t0 = time.perf_counter()
    grads_kernel, m_kernel = grad_fn(ptb, vis)[:2]
    norm_kernel = float(m_kernel["actor/grad_norm"])
    kernel_s = time.perf_counter() - t0
    with plain_attention(forward=False):
        grads_plain, m_plain = grad_fn(ptb, vis)[:2]
    norm_plain = float(m_plain["actor/grad_norm"])
    dot = sum(float(torch.dot(grads_kernel[n].flatten(), grads_plain[n].flatten())) for n in grads_kernel)
    grad_cos = dot / (norm_kernel * norm_plain)
    del grads_kernel, grads_plain
    torch.cuda.empty_cache()
    grad_rel = abs(norm_kernel - norm_plain) / norm_plain
    checks["kernel-path gradient equals the plain backward's"] = (
        grad_rel < GRAD_NORM_REL_TOL and grad_cos > GRAD_COSINE_MIN)

    # packed and per-sample log-probs of the same 8 samples
    kw = dict(micro_batch_size=8, temperature=ACTOR["temperature"], device=dev)
    lp_packed = compute_log_probs_batched(model, piece, padding_free=True, **kw)
    lp_plain = compute_log_probs_batched(model, piece, padding_free=False, **kw)
    sel = piece.tensors["response_mask"].astype(bool)
    lp_diff = np.abs(lp_packed - lp_plain)[sel]
    checks["packed log-probs equal per-sample log-probs"] = float(lp_diff.mean()) <= PACKED_LOGP_ATOL
    print(f"training checks: one packed row {tuple(ptb.input_ids.shape)} forward+backward {kernel_s:.3f} s; "
          f"gradient norm backward kernels {norm_kernel:.6e} vs plain backward {norm_plain:.6e} (relative "
          f"{grad_rel:.3e}, limit {GRAD_NORM_REL_TOL}; cosine {grad_cos:.6f}, floor {GRAD_COSINE_MIN}; losses "
          f"behind the same kernel forward {float(m_kernel['actor/loss']):.6e} and "
          f"{float(m_plain['actor/loss']):.6e}); packed vs per-sample log-probs of 8 samples "
          f"({int(sel.sum())} tokens): mean |d| {lp_diff.mean():.4e}, max {lp_diff.max():.4e} "
          f"(limit on the mean {PACKED_LOGP_ATOL})", flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"training-path checks failed: {failed}")
    return dict(steps=steps, launches=launches, grad_norm_rel=grad_rel, grad_cosine=grad_cos,
                packed_logp_diff=float(lp_diff.mean()), first_micro=first_micro, logprob_call=logprob_call)


def earlier_paths(dev, card, cfg) -> dict:
    """The kernel-vs-plain checks of the serving and update kernels and paths
    a-d. Everything that holds device memory dies with this frame; the
    numbers the report needs come back."""
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.2f} s", flush=True)

    tok = QwenSyntheticTokenizer(cfg)
    prompts, images = requests(len(QUESTIONS))
    provider = TorchProvider(model, cfg, tok, max_new_tokens=MAX_NEW_TOKENS,
                             temperature=0.0, max_prompt_length=1024, prompt_bucket=512)
    prep = provider.prepare(prompts, images)
    b, p = prep["input_ids"].shape
    print(f"requests: {len(prompts)} prompts, padded length {p}, "
          f"{int(prep['prompt_segment_ids'].sum())} prompt tokens, "
          f"{prep['vision'].patches.shape[0]} vision patch slots", flush=True)

    # ---- every kernel against its plain version ----
    flash_cases, range_cases = check_flash(dev, prep, cfg)
    synth_fwd, synth_prep, synth_dq, synth_dkv = check_flash_training(dev, synthetic_training_cases(cfg))
    n_samp = 5
    width = -(-(p + MAX_NEW_TOKENS) // 128) * 128
    decode_cases = check_decode(dev, cfg, len(prompts) * n_samp, width, p)
    lanes = PAGED["slots"] + 1
    page, n_pages = PAGED["page_size"], PAGED["total_pages"]
    int4_cases = [check_paged(dev, cfg, "int4_i8", lanes, p, page, n_pages), check_paged_shipped(dev)]
    pool_cases = [check_paged(dev, cfg, "bf16", PAGED_REQUESTS + 1, p, page, n_pages),
                  check_paged(dev, cfg, "int8", lanes, p, page, n_pages),
                  check_paged_shipped(dev, "bf16"), check_paged_shipped(dev, "int8")]
    rows_chunk = tcont.effective_prefill_chunk(p, PAGED["prefill_rows"], 0, PAGED["max_num_batched_tokens"])
    silu_cases = check_silu(dev, cfg, PAGED["prefill_rows"] * (rows_chunk or p))
    torch.cuda.empty_cache()

    # kernel path and plain path vs an fp32 reference: prefill last-position logits
    logits_k = prefill_logits(model, prep)
    with plain_attention():
        logits_p = prefill_logits(model, prep)
        model32 = copy.deepcopy(model).float()
        logits_ref = prefill_logits(model32, prep)
    del model32
    torch.cuda.synchronize()
    drift_k = (logits_k - logits_ref).abs().max().item()
    drift_p = (logits_p - logits_ref).abs().max().item()
    k_vs_p = (logits_k - logits_p).abs().max().item()
    scale = logits_ref.abs().max().item()
    print(f"prefill logits vs fp32 reference (max |logit| {scale:.4e}): kernel path {drift_k:.4e}, "
          f"plain path {drift_p:.4e}; kernel vs plain {k_vs_p:.4e} (tol {LOGITS_REL_TOL * scale:.4e})",
          flush=True)
    if not torch.isfinite(logits_k).all():
        raise AssertionError("kernel-path prefill logits are not finite")
    if not drift_k <= KERNEL_DRIFT_RATIO * drift_p:
        raise AssertionError("kernel-path prefill logits drift further from fp32 than the plain path")
    if not k_vs_p <= LOGITS_REL_TOL * scale:
        raise AssertionError("kernel-path prefill logits disagree with the plain path")
    del logits_k, logits_p, logits_ref
    torch.cuda.empty_cache()

    # ---- path a: the dense engine; counts from zero, plain versions forbidden ----
    sampled = SamplingParams(temperature=1.0, top_p=1.0, top_k=-1, n=n_samp)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with forbid_plain_versions():
        t0 = time.perf_counter()
        texts = provider.generate(prompts, images)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0

        # the sampled call on the same prepared prompts; a 1-token call first
        # times prefill + lane fanout + first sample alone
        t0 = time.perf_counter()
        generate(model, **prep, max_new_tokens=1, sampling=sampled, generator=gen, n=n_samp)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        result = generate(model, **prep, max_new_tokens=MAX_NEW_TOKENS,
                          sampling=sampled, generator=gen, n=n_samp)
        torch.cuda.synchronize()
        sampled_s = time.perf_counter() - t0
    dense_launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    rows = len(prompts) * n_samp
    steps = int(result.response_mask.sum(-1).max()) - 1
    decode_tok_s = rows * steps / (sampled_s - prefill_s)
    print(f"dense greedy: {len(texts)} answers via TorchProvider in {greedy_s:.3f} s (host preparation "
          f"included)  [{card}]; first: {texts[0][:60]!r}", flush=True)
    print(f"dense sampled n={n_samp}: responses {tuple(result.responses.shape)} in {sampled_s:.3f} s; "
          f"prefill (R=1 call) {prefill_s:.3f} s; decode {decode_tok_s:.1f} tok/s over {steps} steps "
          f"x {rows} rows; peak allocated {peak_gb:.2f} GB  [{card}]", flush=True)
    print(f"dense-path launches: {dense_launches}", flush=True)

    logp = result.rollout_log_probs
    mask = result.response_mask
    checks = {
        "four answers": len(texts) == len(prompts) and all(isinstance(t, str) for t in texts),
        "sampled shape": tuple(result.responses.shape) == (rows, MAX_NEW_TOKENS),
        "log-probs finite": bool(torch.isfinite(logp).all()),
        "log-probs <= 0": bool((logp <= 0).all()),
        "sampled tokens in vocab": bool(((result.responses >= 0) & (result.responses < cfg.text.vocab_size)).all()),
        "every row has a token": bool((mask.sum(-1) >= 1).all()),
        **flash_checks(dense_launches),
        "decode launched": dense_launches["decode_attention"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dense-path checks failed: {failed}")
    del result, logp, mask
    torch.cuda.empty_cache()

    # ---- path b: the shipped paged engine (W8A8, int4 pools, int8 dots) ----
    t0 = time.perf_counter()
    qmodel = quantize_model(model, mode="int8")
    torch.cuda.synchronize()
    q_bytes = sum(bf.numel() * bf.element_size() for bf in qmodel.text.buffers())
    print(f"quantize_model: int8 text weights {q_bytes / 1e9:.3f} GB in {time.perf_counter() - t0:.2f} s",
          flush=True)
    prompts16, images16 = requests(PAGED_REQUESTS, seed=3)
    provider16 = TorchProvider(model, cfg, tok, max_new_tokens=MAX_NEW_TOKENS, temperature=0.0,
                               max_prompt_length=1024, prompt_bucket=512)
    host = provider16.prepare_host(prompts16, images16)
    p16 = host["input_ids"].shape[1]
    prompt_lens = host["segment_ids"].sum(-1)
    chunk = tcont.effective_prefill_chunk(p16, PAGED["prefill_rows"], 0, PAGED["max_num_batched_tokens"])
    print(f"paged requests: {PAGED_REQUESTS} prompts x group_n {PAGED['group_n']}, padded length {p16}, "
          f"prompt tokens {int(prompt_lens.min())}..{int(prompt_lens.max())}, prefill rows "
          f"{PAGED['prefill_rows']} x chunk {chunk} of {p16}; {PAGED}", flush=True)
    if not (0 < chunk < p16 and PAGED["prefill_rows"] * chunk >= 1024
            and int(prompt_lens.min()) > PAGED["page_size"] and int(prompt_lens.max()) % PAGED["page_size"]):
        raise AssertionError("the paged path's shapes miss a chunked prefill, the fused junction, "
                             "a shared full page or a tail page")
    paged_kw = dict(
        max_new_tokens=MAX_NEW_TOKENS, kv_cache_dtype=torch.uint8, int4_i8dot=True,
        patches_list=host["patches_list"], grids_list=host["grids_list"], **PAGED,
    )
    host_inputs = (host["input_ids"], host["segment_ids"], host["position_ids"], host["gen_pos_start"])
    n_layers = cfg.text.num_hidden_layers
    decode_rows = lambda x, *a, **k: x.shape[0] == lanes  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # kernel A's decode calls: 4 linears per layer and the head per step; keep
    # step 8's first gate_up
    with record_call(tq, "fused_w8a8_matmul", (4 * n_layers + 1) * 8 + 2, when=decode_rows) as w8_rec:
        reset_counts()
        with forbid_plain_versions():
            t0 = time.perf_counter()
            paged = generate_paged(qmodel, *host_inputs, sampling=SamplingParams(temperature=1.0),
                                   generator=torch.Generator(device=dev).manual_seed(2), **paged_kw)
            torch.cuda.synchronize()
            paged_s = time.perf_counter() - t0
        paged_launches = read_counts()
    paged_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = paged.stats
    n_lanes_out = PAGED_REQUESTS * PAGED["group_n"]
    gen_tokens = int(paged.response_mask.sum())
    decode_tok_s_paged = (gen_tokens - n_lanes_out) / st["decode_s"]
    unshared = PAGED["slots"] * -(-int(prompt_lens.max()) // PAGED["page_size"])
    print(f"paged int4: responses {paged.responses.shape} in {paged_s:.3f} s; stats peak_pages "
          f"{st['peak_pages']} of {st['total_pages']} (unshared prompts alone would take {unshared}), "
          f"preemptions {st['preemptions']}, refills {st['refills']}, chunks {st['chunks']}; prefill "
          f"{st['refill_s']:.3f} s; decode {decode_tok_s_paged:.1f} tok/s over {st['decode_s']:.3f} s at "
          f"{PAGED['slots']} slots; peak allocated {paged_peak_gb:.2f} GB  [{card}]", flush=True)
    print(f"paged-int4-path launches: {paged_launches}", flush=True)
    plogp, pmask = paged.rollout_log_probs, paged.response_mask
    checks = {
        "paged shape": paged.responses.shape == (n_lanes_out, MAX_NEW_TOKENS),
        "paged log-probs finite": bool(np.isfinite(plogp).all()),
        "paged log-probs <= 0": bool((plogp <= 0).all()),
        "paged tokens in vocab": bool(((paged.responses >= 0) & (paged.responses < cfg.text.vocab_size)).all()),
        "every lane has a token": bool((pmask.sum(-1) >= 1).all()),
        "lanes of a group differ (sampled)": bool((paged.responses[0] != paged.responses[1]).any()),
        "prompt pages shared": st["peak_pages"] < unshared,
        "several refills": st["refills"] >= 2,
        **flash_checks(paged_launches),
        "int4 paged kernel launched": paged_launches["paged_attention_int4_i8"] > 0,
        "silu junction launched": paged_launches["silu_quant"] > 0,
        "no dense decode kernel": paged_launches["decode_attention"] == 0,
        "ring merged outside the kernel": paged_launches["paged_staged"] == 0,
        **w8a8_checks(paged_launches),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"paged-path checks failed: {failed}")
    w8a8_cases = [recorded_w8a8_case(w8_rec, "path_b_decode")]
    del w8_rec

    # rollout/probs_diff: lane 0 of every prompt, the bf16 model on the same tokens
    prep16 = provider16.prepare(prompts16, images16)
    lane0 = slice(0, None, PAGED["group_n"])
    ref_logp = teacher_forced_logps(model, prep16, paged.responses[lane0], pmask[lane0])
    sel = pmask[lane0].astype(bool)
    probs_diff = float(np.abs(plogp[lane0][sel] - ref_logp[sel]).mean())
    probs_diff_max = float(np.abs(plogp[lane0][sel] - ref_logp[sel]).max())
    print(f"paged int4 vs bf16 teacher forcing on the same tokens ({int(sel.sum())} tokens): mean |dlogp| "
          f"{probs_diff:.4f} (limit {PROBS_DIFF_LIMIT}), max {probs_diff_max:.4f}", flush=True)
    if not probs_diff <= PROBS_DIFF_LIMIT:
        raise AssertionError("the int4 path's log-probs are too far from the bf16 model's")
    torch.cuda.empty_cache()

    # ---- greedy agreement: dense bf16 engine, int4 path, and path c (bf16 pools) ----
    greedy = SamplingParams(temperature=0.0)
    agree_kw = dict(paged_kw, max_new_tokens=CHECK_NEW_TOKENS, group_n=1, slots=PAGED_REQUESTS,
                    refill_batch=0, prefill_rows=0, max_num_batched_tokens=0, total_pages=0,
                    decode_chunk_size=8)
    with forbid_plain_versions():
        dense = generate(model, **prep16, max_new_tokens=CHECK_NEW_TOKENS, sampling=greedy,
                         generator=gen)
        g4 = generate_paged(qmodel, *host_inputs, sampling=greedy,
                            generator=torch.Generator(device=dev).manual_seed(3), **agree_kw)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        g16 = generate_paged(model, *host_inputs, sampling=greedy,
                             generator=torch.Generator(device=dev).manual_seed(3),
                             **dict(agree_kw, kv_cache_dtype=torch.bfloat16, int4_i8dot=False))
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
    bf16_launches = read_counts()
    dense_tokens = dense.responses.cpu().numpy()
    dense_logp = dense.rollout_log_probs.cpu().numpy()
    first_agree = float((g4.responses[:, 0] == dense_tokens[:, 0]).mean())
    first_dlogp = float(np.abs(g4.rollout_log_probs[:, 0] - dense_logp[:, 0]).mean())
    print(f"greedy int4 path vs dense bf16 engine: first tokens equal {first_agree:.3f} "
          f"(floor {FIRST_TOKEN_MIN_AGREEMENT}), mean |dlogp| of the first token {first_dlogp:.4f}",
          flush=True)
    if not first_agree >= FIRST_TOKEN_MIN_AGREEMENT:
        raise AssertionError("the int4 path's first greedy tokens disagree with the dense engine's")
    print(f"paged bf16 pools: {g16.responses.shape} in {bf16_s:.3f} s, stats {g16.stats}; "
          f"launches {bf16_launches}", flush=True)
    same = g16.responses == dense_tokens
    drift_paged = engine_drift(model, prep16, g16.responses, g16.rollout_log_probs)
    drift_dense = engine_drift(model, prep16, dense_tokens, dense_logp)
    rows_equal = float(same.all(axis=1).mean())
    print(f"paged bf16 pools vs dense engine: first tokens equal {same[:, 0].mean():.3f}, rows equal "
          f"throughout {rows_equal:.3f}, tokens equal {same.mean():.3f}; mean |dlogp| against bf16 "
          f"teacher forcing: paged {drift_paged:.4f}, dense {drift_dense:.4f} "
          f"(limit {ENGINE_DRIFT_RATIO} x dense)", flush=True)
    if not same[:, 0].all():
        raise AssertionError("paged bf16 pools vs dense engine: first tokens differ")
    if not drift_paged <= ENGINE_DRIFT_RATIO * drift_dense:
        raise AssertionError("the bf16-pool paged engine drifts further from the model than the dense engine")
    if not (bf16_launches["paged_attention_pool"] > 0 and all(flash_checks(bf16_launches).values())):
        raise AssertionError(f"the bf16-pool path did not launch its kernels: {bf16_launches}")

    # ---- path h: path b with the staging ring fused into the paged kernel ----
    # keep one mid-chunk attention call (step 8 of the first chunk, last layer)
    h_pick = n_layers * (PAGED["decode_chunk_size"] // 2) + n_layers - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with record_call(tpaged, "paged_attention", h_pick) as h_rec:
        reset_counts()
        with forbid_plain_versions():
            t0 = time.perf_counter()
            fused = generate_paged(qmodel, *host_inputs, sampling=SamplingParams(temperature=1.0),
                                   generator=torch.Generator(device=dev).manual_seed(2), fuse_staged=True,
                                   **paged_kw)
            torch.cuda.synchronize()
            fused_s = time.perf_counter() - t0
        h_launches = read_counts()
    h_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st_h = fused.stats
    hlogp, hmask = fused.rollout_log_probs, fused.response_mask
    decode_tok_s_fused = (int(hmask.sum()) - n_lanes_out) / st_h["decode_s"]
    ref_h = teacher_forced_logps(model, prep16, fused.responses[lane0], hmask[lane0])
    sel_h = hmask[lane0].astype(bool)
    probs_diff_h = float(np.abs(hlogp[lane0][sel_h] - ref_h[sel_h]).mean())
    print(f"path h (path b, ring fused): responses {fused.responses.shape} in {fused_s:.3f} s; refills "
          f"{st_h['refills']}, chunks {st_h['chunks']}, peak_pages {st_h['peak_pages']}; prefill "
          f"{st_h['refill_s']:.3f} s; decode {decode_tok_s_fused:.1f} tok/s over {st_h['decode_s']:.3f} s "
          f"(path b unfused in this run: {decode_tok_s_paged:.1f} tok/s over {st['decode_s']:.3f} s); "
          f"probs_diff {probs_diff_h:.4f} (limit {PROBS_DIFF_LIMIT}); peak allocated {h_peak_gb:.2f} GB "
          f"[{card}]", flush=True)
    print(f"path-h launches: {h_launches}", flush=True)
    checks = {
        "shape": fused.responses.shape == (n_lanes_out, MAX_NEW_TOKENS),
        "log-probs finite and <= 0": bool(np.isfinite(hlogp).all() and (hlogp <= 0).all()),
        "tokens in vocab": bool(((fused.responses >= 0) & (fused.responses < cfg.text.vocab_size)).all()),
        "every lane has a token": bool((hmask.sum(-1) >= 1).all()),
        "every int4 paged launch ran the ring": (
            h_launches["paged_staged"] == h_launches["paged_attention_int4_i8"] > 0),
        "silu junction launched": h_launches["silu_quant"] > 0,
        "probs_diff within the limit": probs_diff_h <= PROBS_DIFF_LIMIT,
        **w8a8_checks(h_launches),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path-h checks failed: {failed}")
    staged_cases = [staged_case(h_rec, "int4_i8", "path_h")]
    del h_rec, fused

    # the staged block in the other three pool modes, on a mid-chunk call of a
    # greedy fused run each (bf16 pools: path c's configuration)
    small_pick = n_layers * (agree_kw["decode_chunk_size"] // 2) + n_layers - 1
    for kind, engine_model, kv in (("bf16", model, torch.bfloat16), ("int8", qmodel, torch.int8),
                                   ("int4", qmodel, torch.uint8)):
        with record_call(tpaged, "paged_attention", small_pick) as rec:
            reset_counts()
            with forbid_plain_versions():
                run = generate_paged(engine_model, *host_inputs, sampling=greedy,
                                     generator=torch.Generator(device=dev).manual_seed(3), fuse_staged=True,
                                     **dict(agree_kw, kv_cache_dtype=kv, int4_i8dot=False))
                torch.cuda.synchronize()
            counts = read_counts()
        kernel = "paged_attention_int4" if kind == "int4" else "paged_attention_pool"
        if not (counts["paged_staged"] == counts[kernel] > 0 and np.isfinite(run.rollout_log_probs).all()):
            raise AssertionError(f"fused {kind}-pool run: launches {counts}")
        staged_cases.append(staged_case(rec, kind, f"greedy_{kind}_pools"))
        del rec, run

    # ---- path d: one GRPO step (rollout, log-probs, advantages, packed update) ----
    del dense, g4, g16, paged, prep16, qmodel
    torch.cuda.empty_cache()
    train_cfg = cut_depth(cfg)
    train_model = init_params(train_cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    holder = {"model": None, "quantize_s": 0.0}  # the rollout quantizes the policy it trains
    train = training_path(dev, train_model, holder, host, paged_kw, card)
    del train_model
    train_launches = train["launches"]

    # the flash kernels once more, on the segment ids the update's first
    # micro-batch gave them (its packed text rows and its vision pack)
    first = train.pop("first_micro")
    print(f"first micro-batch of the update: text rows {first['seg_text'].shape}, vision pack "
          f"{first['seg_full'].shape[0]} patch slots holding {first['images']} images", flush=True)
    path_fwd, prep_cases, dq_cases, dkv_cases = check_flash_training(
        dev, training_cases(cfg, "update", first["seg_text"], first["seg_full"], first["seg_window"]))
    # the forward once more, on the inputs of path d's first log-prob vision call
    # (old log-probs, first piece, the first full-attention block)
    rec = train.pop("logprob_call")
    q, k, v, q_seg, kv_seg = rec["args"]
    print(f"log-prob vision call of path d: q{tuple(q.shape)}, {int(q_seg.max())} images in "
          f"{q_seg.shape[1]} patch slots ({int((q_seg != 0).sum())} live)", flush=True)
    logprob_fwd, logprob_ranges = flash_fwd_case(
        f"path_d_logprob_vision_full_{q_seg.shape[1]}", q, k, v, q_seg, kv_seg, rec["kwargs"]["causal"],
        rec["kwargs"]["causal_offset"], by_head=True, plain_iters=2)
    del rec, q, k, v, q_seg, kv_seg
    torch.cuda.empty_cache()
    flash_cases += path_fwd + synth_fwd + [logprob_fwd]
    range_cases.append(logprob_ranges)
    prep_cases += synth_prep
    dq_cases += synth_dq
    dkv_cases += synth_dkv

    return dict(
        flash_cases=flash_cases, range_cases=range_cases, prep_cases=prep_cases, dq_cases=dq_cases,
        dkv_cases=dkv_cases,
        decode_cases=decode_cases,
        pool_cases=pool_cases, int4_cases=int4_cases, silu_cases=silu_cases, w8a8_cases=w8a8_cases,
        staged_cases=staged_cases, h_launches=h_launches, decode_tok_s_fused=decode_tok_s_fused,
        st_h=st_h, probs_diff_h=probs_diff_h, h_peak_gb=h_peak_gb,
        dense_launches=dense_launches, paged_launches=paged_launches, bf16_launches=bf16_launches,
        train_launches=train_launches, train=train, prompt_len=p, p16=p16,
        decode_tok_s=decode_tok_s, prefill_s=prefill_s, peak_gb=peak_gb,
        decode_tok_s_paged=decode_tok_s_paged, st=st, paged_peak_gb=paged_peak_gb,
        probs_diff=probs_diff, first_agree=first_agree, rows_equal=rows_equal,
        drift_paged=drift_paged, drift_dense=drift_dense, bf16_s=bf16_s,
    )


# ---------------------------------------------------------------------------
# the trainer (paths e and f) and the checkpoint round trip
# ---------------------------------------------------------------------------


def script_dotlist(script: str) -> list:
    """The key=value lines a shipped training script passes to the trainer
    CLI, with the config file's path made absolute."""
    root = Path(__file__).resolve().parent
    out = []
    for line in (root / script).read_text().splitlines():
        line = line.strip().rstrip("\\").strip()
        if re.fullmatch(r"[a-z_][a-z0-9_.]*=\S+", line):
            out.append(f"config={root / 'scripts' / 'config.yaml'}" if line.startswith("config=") else line)
    if not out:
        raise AssertionError(f"no dotlist parsed from {script}")
    return out


def trainer_config(save_dir, extra=()):
    return build_config(script_dotlist(TRAINER_SCRIPT) + TRAINER_OVERRIDES
                        + [f"trainer.save_checkpoint_path={save_dir}", *extra])


def scene_rows(n: int, seed: int) -> list:
    """Seeded rows in the shape of the spatial dataset: a question with the
    image size, a 640 x 480 image, a ground-truth trace with a scene graph."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        x0, y0 = (int(v) for v in rng.integers(0, 300, size=2))
        scene = {"objects": [{"id": "mug.1", "bbox": [x0, y0, x0 + 120, y0 + 90]},
                             {"id": "laptop.2", "bbox": [x0 + 150, y0 + 20, x0 + 330, y0 + 170]}],
                 "relationships": [{"subject": "mug.1", "predicate": "left of", "object": "laptop.2"}]}
        answer = ("<observe>A mug and a laptop.</observe>" f"<scene>{json.dumps(scene)}</scene>"
                  "<think>The mug is on the left.</think><answer>yes</answer>")
        rows.append({"problem": f"{QUESTIONS[i % len(QUESTIONS)]} (scene {i}) Image size: (640 x 480)",
                     "answer": answer, "image": [(rng.random((480, 640, 3)) * 255).astype(np.uint8)]})
    return rows


METRIC_FAMILIES = ("actor/", "critic/score/", "reward/", "timing_s/", "perf/", "rollout/kv_")
TRAIN_KERNELS = ("flash_fwd", "flash_ranges", "flash_bwd_prep", "flash_bwd_dq", "flash_bwd_dkv",
                 "paged_attention_int4_i8", "silu_quant", "w8a8")
DECODE_KERNELS = ("decode_attention", "decode_attention_int8", "decode_attention_int4",
                  "decode_attention_int4_i8", "paged_attention_pool", "paged_attention_int4_i8",
                  "paged_attention_int4")
PAGED_KERNELS = ("paged_attention_pool", "paged_attention_int4_i8", "paged_attention_int4")
INT4_KERNELS = ("int4_gateup", "int4_down")


def trainer_path(dev, card, work_dir):
    """Path e: one step of ``GRPOTrainer.fit`` at full 3B width on the shipped
    script's dotlist. Returns (trainer, dataset, results)."""
    config = trainer_config(work_dir)
    t0 = time.perf_counter()
    model = build_model(config)
    tok = load_tokenizer(config.worker.actor.model.tokenizer_path, model.cfg)
    rows = scene_rows(config.data.rollout_batch_size + TRAINER_VAL_ROWS, seed=21)
    n_train = config.data.rollout_batch_size
    train_ds = RLHFDataset.from_rows(rows[:n_train], tok, config.data, model.cfg)
    val_ds = RLHFDataset.from_rows(rows[n_train:], tok, config.data, model.cfg)
    trainer = build_trainer(config, tok, model, train_ds, val_ds)
    torch.cuda.synchronize()
    roll = config.worker.rollout
    print(f"trainer: {TRAINER_SCRIPT} dotlist + {TRAINER_OVERRIDES}; built in "
          f"{time.perf_counter() - t0:.2f} s; engine name={roll.name} page_size={roll.page_size} "
          f"kv_cache_dtype={roll.kv_cache_dtype} quantization={roll.quantization} "
          f"int4_i8dot={roll.int4_i8dot} slots={roll.decode_batch_size} n={roll.n}; resident "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB (policy, reference copy, moments)", flush=True)
    p_sums = checksums(model.parameters())
    ref_sums = checksums(trainer.ref_model.parameters())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with forbid_plain_versions():
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log = Path(work_dir) / f"{config.trainer.experiment_name}_metrics.jsonl"
    records = {r["step"]: r for r in map(json.loads, log.read_text().splitlines())}
    moved = sum(a != b for a, b in zip(p_sums, checksums(model.parameters())))
    checks = {
        "validation before training logged val/reward_score": "val/reward_score" in records.get(0, {}),
        "one step record": 1 in records and trainer.global_step == 1,
        "parameters moved": moved > 0,
        "reference copy untouched": checksums(trainer.ref_model.parameters()) == ref_sums,
        "every kernel of a step launched": all(launches[k] > 0 for k in TRAIN_KERNELS),
        "no dense decode kernel": launches["decode_attention"] == 0,
        "no torch._int_mm": launches["int_mm"] == 0,
        "pool sized from free memory": (trainer._paged_pool_cache or 0) > 0,
    }
    for step in (1,):
        rec = records.get(step, {})
        for family in METRIC_FAMILIES:
            vals = [v for k, v in rec.items() if k.startswith(family)]
            checks[f"step {step}: {family}* present and finite"] = bool(vals) and bool(np.isfinite(vals).all())
        checks[f"step {step}: rollout/probs_diff_mean within the limit"] = (
            rec.get("rollout/probs_diff_mean", np.inf) <= PROBS_DIFF_LIMIT)
        if rec:
            t = {k.split("/", 1)[1]: v for k, v in rec.items() if k.startswith("timing_s/")}
            print(f"trainer step {step}: " + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(t.items()))
                  + f"; throughput {rec['perf/throughput']:.1f} tok/s, mfu_actor {rec['perf/mfu_actor']:.4f}, "
                  f"probs_diff_mean {rec['rollout/probs_diff_mean']:.4f}, reward/overall "
                  f"{rec['reward/overall']:.4f}, actor/grad_norm {rec['actor/grad_norm']:.3e}, actor/kl_loss "
                  f"{rec.get('actor/kl_loss', float('nan')):.3e}, response_length/mean "
                  f"{rec['response_length/mean']:.1f}, kv peak_pages {rec['rollout/kv_peak_pages']:.0f} of "
                  f"{rec['rollout/kv_total_pages']:.0f}, preemptions {rec['rollout/kv_preemptions']:.0f}  [{card}]",
                  flush=True)
    print(f"trainer fit: {fit_s:.2f} s for validation + 1 step; val/reward_score "
          f"{records.get(0, {}).get('val/reward_score')}; page pool the trainer chose "
          f"{trainer._paged_pool_cache} pages of {roll.page_size}; parameter tensors moved {moved}; "
          f"peak allocated {peak_gb:.2f} GB, reserved {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
          f"[{card}]; launches {launches}", flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"trainer-path checks failed: {failed}")
    results = dict(fit_s=fit_s, launches=launches, peak_gb=peak_gb, pool_pages=trainer._paged_pool_cache,
                   steps={s: {k: v for k, v in records[s].items() if k != "time"} for s in (1,)},
                   val_reward_score=records[0]["val/reward_score"])
    return trainer, train_ds, results


KNOB_CASES = [
    # label, rollout knobs, the kernels the case must reach, limit on probs_diff (None: path b's + extra)
    ("dense_int8", dict(name="jax", kv_cache_dtype="int8", int4_i8dot=False), ("decode_attention_int8",), None),
    ("dense_int4", dict(name="jax", kv_cache_dtype="int4", int4_i8dot=False), ("decode_attention_int4",),
     PROBS_DIFF_LIMIT),
    ("dense_int4_i8dot", dict(name="jax", kv_cache_dtype="int4", int4_i8dot=True),
     ("decode_attention_int4_i8",), PROBS_DIFF_LIMIT),
    ("paged_int4", dict(name="continuous", kv_cache_dtype="int4", int4_i8dot=False),
     ("paged_attention_int4",), PROBS_DIFF_LIMIT),
    # the continuous engine with W8A8 weights over an int8 slot cache (#4')
    ("continuous_int8", dict(name="continuous", page_size=0, kv_cache_dtype="int8", int4_i8dot=False),
     ("decode_attention_int8",), None),
    # the dense engine with the w4a8 copy: 64 rows decode through the int4 MLP
    ("dense_w4a8", dict(name="jax", kv_cache_dtype="int4", int4_i8dot=True, quantization="w4a8"),
     ("decode_attention_int4_i8", "int4_gateup", "int4_down"), W4_PROBS_DIFF_LIMIT),
]


@contextmanager
def kept_continuous_result():
    """The trainer's ``generate_continuous`` wrapped so that the engine's own
    result (its stats: lanes, refills, chunks) is kept in the dict yielded;
    the result passes on unchanged."""
    kept, real = {}, gt.generate_continuous

    def keep(*args, **kwargs):
        kept["result"] = real(*args, **kwargs)
        return kept["result"]

    gt.generate_continuous = keep
    try:
        yield kept
    finally:
        gt.generate_continuous = real


def knob_rollout(trainer, batch, knobs: dict):
    """One rollout through the trainer's own ``generate_sequences`` with these
    rollout knobs, then the trainer's own log-probs of the same tokens (what
    it logs as ``rollout/probs_diff_mean``), plain versions forbidden.
    Returns (rolled, launches, generation seconds, probs_diff)."""
    roll = trainer.config.worker.rollout
    for key, value in knobs.items():
        setattr(roll, key, value)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with forbid_plain_versions():
        t0 = time.perf_counter()
        rolled = trainer.generate_sequences(batch, trainer.sampling)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = read_counts()
        old = trainer.compute_log_probs_batched(rolled, trainer.model)
    mask = rolled.tensors["response_mask"].astype(bool)
    diff = float(np.abs(old - rolled.tensors["rollout_log_probs"])[mask].mean())
    return rolled, counts, gen_s, diff


def knob_paths(dev, card, trainer, train_ds, paged_probs_diff: float) -> dict:
    """Path f: one rollout per knob case (``knob_rollout``). The continuous
    engine's case also keeps one decode call's inputs and holds its kernel
    against the plain version on them, and must run two waves (refills)."""
    batches = {p: next(iter(DataLoader(train_ds, p, shuffle=False))) for p in (KNOB_PROMPTS, CONTINUOUS_KNOB_PROMPTS)}
    out = {}
    for label, knobs, kernels, limit in KNOB_CASES:
        limit = paged_probs_diff + INT8_CACHE_EXTRA_DRIFT if limit is None else limit
        continuous = knobs.get("page_size") == 0
        recorder = record_call(tcont, "decode_attention", decode_pick(trainer.model_cfg)) if continuous \
            else nullcontext()
        with recorder as rec, (kept_continuous_result() if continuous else nullcontext({})) as kept:
            batch = batches[CONTINUOUS_KNOB_PROMPTS if continuous else KNOB_PROMPTS]
            rolled, counts, gen_s, diff = knob_rollout(trainer, batch, knobs)
        refills = kept["result"].stats["refills"] if continuous else None
        mask = rolled.tensors["response_mask"].astype(bool)
        logp = rolled.tensors["rollout_log_probs"]
        launched = {k: counts[k] for k in kernels}
        others = {k: counts[k] for k in DECODE_KERNELS + INT4_KERNELS if k not in kernels and counts[k]}
        print(f"knob case {label}: {knobs} -> responses {rolled.tensors['responses'].shape} in {gen_s:.3f} s, "
              f"{int(mask.sum())} tokens; launches {launched}, other decode kernels {others}; "
              f"probs_diff_mean {diff:.4f} (limit {limit:.4f}); refills {refills}; peak allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]", flush=True)
        checks = {
            "its kernels launched": all(launched.values()), "no other decode kernel": not others,
            "log-probs finite and <= 0": bool(np.isfinite(logp).all() and (logp <= 0).all()),
            "every row has a token": bool((mask.sum(-1) >= 1).all()),
            "probs_diff within the limit": diff <= limit,
            **w8a8_checks(counts),
            **({"two waves: lanes harvested and refilled mid-decode": refills >= 2} if continuous else {}),
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"knob case {label} failed: {failed}")
        out[label] = dict(launches=launched, probs_diff=diff, limit=limit, seconds=gen_s,
                          w8a8_launches=counts["w8a8"], refills=refills)
        if continuous:
            kind = "int4_i8" if knobs["int4_i8dot"] else knobs["kv_cache_dtype"]
            out[label]["decode_cases"] = recorded_decode_case(trainer.model_cfg, kind, rec, label)
        del rolled, rec
    return out


# Controls for W4_PROBS_DIFF_LIMIT: the dense_w4a8 case with its int4 copies
# miswired the way a wiring fault would (the trainer's rollout copy altered
# after ``quantize_model``); each must land above the limit.
W4_CONTROLS = ("gate_up_halves_swapped", "next_layers_copy")


def miswire(model, how: str):
    mlps = [layer.mlp for layer in model.text.layers]
    if how == "gate_up_halves_swapped":  # silu(up) * gate
        for mlp in mlps:
            w, i = mlp.gate_up_w4, mlp.gate_up_w4.q4.shape[0] // 2
            w.q4 = torch.cat([w.q4[i:], w.q4[:i]])
            w.gscale = torch.cat([w.gscale[:, i:], w.gscale[:, :i]], dim=1)
    else:  # layer j runs layer j + 1's int4 copies
        copies = [(mlp.gate_up_w4, mlp.down_w4) for mlp in mlps]
        for j, mlp in enumerate(mlps):
            mlp.gate_up_w4, mlp.down_w4 = copies[(j + 1) % len(mlps)]
    return model


def w4_controls(card, trainer, train_ds) -> dict:
    """The dense_w4a8 knob case with each of ``W4_CONTROLS``: the int4
    kernels still launch, and ``rollout/probs_diff_mean`` must exceed
    ``W4_PROBS_DIFF_LIMIT`` -- the limit tells a sound copy from these."""
    batch = next(iter(DataLoader(train_ds, KNOB_PROMPTS, shuffle=False)))
    knobs = next(k for label, k, _, _ in KNOB_CASES if label == "dense_w4a8")
    real = gt.quantize_model
    out = {}
    for how in W4_CONTROLS:
        gt.quantize_model = lambda model, mode="int8", how=how, **kw: miswire(real(model, mode=mode, **kw), how)
        rolled, counts, gen_s, diff = knob_rollout(trainer, batch, knobs)
        gt.quantize_model = real
        print(f"w4 control {how}: probs_diff_mean {diff:.4f} (must exceed {W4_PROBS_DIFF_LIMIT}); launches "
              f"gate_up {counts['int4_gateup']} down {counts['int4_down']}; {gen_s:.3f} s  [{card}]", flush=True)
        if not (diff > W4_PROBS_DIFF_LIMIT and counts["int4_gateup"] > 0 and counts["int4_down"] > 0):
            raise AssertionError(f"W4_PROBS_DIFF_LIMIT does not tell a sound int4 copy from {how}")
        out[how] = dict(probs_diff=diff, seconds=gen_s)
        del rolled
    return out


# Path g: path e's dotlist with four knobs changed; the rest (int4 KV with
# int8 dots, 16 prompts x n 8, prompt 512, response 64) stays
PATH_G_KNOBS = dict(name="continuous", page_size=0, quantization="w4a8", decode_batch_size=128)


def continuous_w4a8_path(dev, card, trainer, train_ds) -> dict:
    """Path g: ONE ``train_step`` of path e's trainer with the continuous
    engine and the w4a8 rollout copy (the trainer reads the knobs at each
    rollout): 128 samples through 128 slots = 136 lanes, the real
    ``spatial_sgg`` reward, old / ref log-probs and the update. The engine's
    own result is kept (a wrapper around the trainer's ``generate_continuous``
    that returns it unchanged) for the row checks and its stats."""
    roll = trainer.config.worker.rollout
    for key, value in PATH_G_KNOBS.items():
        setattr(roll, key, value)
    batch = next(iter(DataLoader(train_ds, trainer.config.data.rollout_batch_size, shuffle=False)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    layers = trainer.model_cfg.text.num_hidden_layers
    prefill_rows = lambda x, *a, **k: x.shape[0] >= tq.FUSED_SILU_MIN_M  # noqa: E731
    with kept_continuous_result() as engine, \
            record_call(tcont, "decode_attention", decode_pick(trainer.model_cfg)) as decode_rec, \
            record_call(sq, "fused_silu_quantize", layers - 1) as silu_rec, \
            record_call(tq, "fused_w8a8_matmul", 2, when=prefill_rows) as w8_rec:
        reset_counts()
        with forbid_plain_versions():
            trainer.global_step += 1
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = engine["result"]
    st = res.stats
    chunk = inspect.signature(gt.generate_continuous).parameters["decode_chunk_size"].default
    steps = st["chunks"] * chunk
    mask = res.response_mask.astype(bool)
    logp = res.rollout_log_probs
    n_rows = trainer.config.data.rollout_batch_size * roll.n
    timing = {k.split("/", 1)[1]: v for k, v in metrics.items() if k.startswith("timing_s/")}
    gen_tokens = int(mask.sum())
    print(f"path g (continuous + w4a8): {PATH_G_KNOBS} on {TRAINER_SCRIPT}; {n_rows} samples through "
          f"{st['lanes']} lanes: {st['refills']} refills {st['refill_s']:.3f} s, {st['chunks']} decode chunks of "
          f"{chunk} ({steps} steps) {st['decode_s']:.3f} s = {(gen_tokens - n_rows) / st['decode_s']:.1f} tok/s; "
          f"step {step_s:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(timing.items()))
          + f"; throughput {metrics['perf/throughput']:.1f} tok/s, probs_diff_mean "
          f"{metrics['rollout/probs_diff_mean']:.4f} (limit {W4_PROBS_DIFF_LIMIT}), reward/overall "
          f"{metrics['reward/overall']:.4f}, response_length/mean {metrics['response_length/mean']:.1f}; "
          f"peak allocated {peak_gb:.2f} GB  [{card}]", flush=True)
    print(f"path g launches: {counts}", flush=True)
    print(f"path g metrics: {json.dumps(metrics)}", flush=True)
    checks = {
        "136 lanes": st["lanes"] == -(-(roll.decode_batch_size + 1) // 8) * 8 == 136,
        "int4 gate_up: 36 per decode step": counts["int4_gateup"] == layers * steps,
        "int4 down: 36 per decode step": counts["int4_down"] == layers * steps,
        "int4 int8-dot decode kernel launched": counts["decode_attention_int4_i8"] == layers * steps,
        "silu junction launched (prefill)": counts["silu_quant"] > 0,
        "flash kernels launched": all(counts[k] > 0 for k in ("flash_fwd", "flash_ranges", "flash_bwd_prep",
                                                               "flash_bwd_dq", "flash_bwd_dkv")),
        "no paged kernel": not any(counts[k] for k in PAGED_KERNELS),
        "no other dense decode kernel": not any(
            counts[k] for k in ("decode_attention", "decode_attention_int8", "decode_attention_int4")),
        "every row has a token": bool((mask.sum(-1) >= 1).all()) and res.responses.shape[0] == n_rows,
        "log-probs finite and <= 0": bool(np.isfinite(logp).all() and (logp <= 0).all()),
        "metrics finite": all(np.isfinite(v) for v in metrics.values()),
        "probs_diff within the limit": metrics["rollout/probs_diff_mean"] <= W4_PROBS_DIFF_LIMIT,
        "no paged telemetry": not any(k.startswith("rollout/kv_") for k in metrics),
        **w8a8_checks(counts),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path g checks failed: {failed}")
    # #6 and #12 against their plain versions on inputs this step gave them
    decode_cases = recorded_decode_case(trainer.model_cfg, "int4_i8", decode_rec, "path_g")
    gu = silu_rec["args"][0]
    silu_cases = silu_case(gu, f"path_g_refill_rows_{gu.shape[0]}")
    w8a8_cases = [recorded_w8a8_case(w8_rec, "path_g_refill")]
    del decode_rec, silu_rec, gu, w8_rec
    return dict(launches=counts, stats=st, step_s=step_s, decode_steps=steps, peak_gb=peak_gb,
                decode_tok_s=(gen_tokens - n_rows) / st["decode_s"],
                metrics={k: v for k, v in metrics.items() if k != "time"},
                decode_cases=decode_cases, silu_cases=silu_cases, w8a8_cases=w8a8_cases)


LOGGED_NOT_COMPARED = ("timing_s/", "timing_per_token_ms/", "perf/", "rollout/kv_refill_s",
                       "rollout/kv_decode_s")  # seconds and memory: not a function of the state


def checkpoint_round_trip(dev, card, cfg, work_dir) -> dict:
    """3B widths, ``CKPT_LAYERS`` text layers and vision blocks: trainer A takes
    a step and saves; trainer B is built anew from the same initial weights (a
    resumed run builds its policy, and from it the reference copy, from the
    same model path), loads, and both take the next step on the same batch."""
    vis = dataclasses.replace(cfg.vision, depth=CKPT_LAYERS, fullatt_block_indexes=(1, 3))
    small = dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=CKPT_LAYERS), vision=vis)
    # two trainers share the card here, so neither may size its page pool from
    # the free memory it sees: the pool is fixed (rollout.kv_pages_override)
    extra = ["data.rollout_batch_size=4", "worker.actor.global_batch_size=32", "trainer.max_steps=1",
             "trainer.val_before_train=false", "trainer.logger=['console']",
             f"worker.rollout.kv_pages_override={PAGED['total_pages']}"]
    rows = scene_rows(4, seed=22)

    def make(seed: int, more=()):
        config = trainer_config(work_dir, [*extra, *more])
        model = init_params(small, torch.Generator(device=dev).manual_seed(seed), dtype=torch.bfloat16)
        tok = load_tokenizer("synthetic", small)
        ds = RLHFDataset.from_rows(rows, tok, config.data, small)
        return build_trainer(config, tok, model, ds), ds

    a, ds = make(31)
    with forbid_plain_versions():
        a.fit()
    t0 = time.perf_counter()
    a.save_checkpoint()
    save_s = time.perf_counter() - t0
    step_dir = Path(work_dir) / "global_step_1"
    size_gb = sum(f.stat().st_size for f in step_dir.iterdir()) / 1e9
    b, _ = make(31, [f"trainer.load_checkpoint_path={work_dir}"])
    differed = checksums(a.model.parameters()) != checksums(b.model.parameters())
    t0 = time.perf_counter()
    b.load_checkpoint()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded_equal = checksums(a.model.parameters()) == checksums(b.model.parameters())
    metrics = []
    with forbid_plain_versions():
        for t in (a, b):
            t.global_step += 1
            metrics.append(t.train_step(next(iter(DataLoader(ds, 4, shuffle=False)))))
    torch.cuda.synchronize()
    keys = [k for k in metrics[0] if not k.startswith(LOGGED_NOT_COMPARED)]
    worst = max(keys, key=lambda k: abs(metrics[0][k] - metrics[1][k]))
    metrics_close = set(metrics[0]) == set(metrics[1]) and all(
        np.isclose(metrics[0][k], metrics[1][k], rtol=CKPT_METRIC_RTOL, atol=CKPT_METRIC_ATOL) for k in keys)
    param_diff = max(float((pa_.detach().float() - pb_.detach().float()).abs().max())
                     for pa_, pb_ in zip(a.model.parameters(), b.model.parameters()))
    n_params = sum(p_.numel() for p_ in a.model.parameters())
    print(f"checkpoint round trip: {n_params / 1e9:.3f} B params at 3B widths, {CKPT_LAYERS} layers; "
          f"saved {size_gb:.2f} GB in {save_s:.2f} s, loaded in {load_s:.2f} s; fresh trainer differed "
          f"before the load {differed}, equal after {loaded_equal}, step {b.global_step - 1} restored, "
          f"optimizer count {b.optimizer.state['count'] - 1}; next step: {len(keys)} metrics compared, "
          f"largest difference {worst} {metrics[0][worst]:.6g} vs {metrics[1][worst]:.6g}; parameters "
          f"max |difference| {param_diff:.3e} (limit {CKPT_PARAM_ATOL})  [{card}]", flush=True)
    checks = {
        "fresh trainer differed before the load": differed, "parameters equal after the load": loaded_equal,
        "step restored": b.global_step == a.global_step == 2,
        "optimizer count restored": b.optimizer.state["count"] == a.optimizer.state["count"],
        "next step gives equal metrics": metrics_close,
        "next step gives equal parameters": param_diff <= CKPT_PARAM_ATOL,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"checkpoint round trip failed: {failed}")
    return dict(params=n_params, size_gb=size_gb, save_s=save_s, load_s=load_s, param_diff=param_diff)


# path i: path e's dotlist with the critic, both optimizers with bf16 moments
# and no Kahan buffer (fp32 moments for two 3B models do not fit on 80 GB)
GAE_OVERRIDES = [
    "algorithm.adv_estimator=gae",
    "worker.actor.optim.strategy=adamw_bf16", "worker.critic.optim.strategy=adamw_bf16",
    "worker.actor.optim.use_kahan_summation=false", "worker.critic.optim.use_kahan_summation=false",
    # as the actor's (TRAINER_OVERRIDES): two 3B models, their moments and the
    # critic's fp32 accumulator leave no room for the kept weight products
    "worker.critic.sharding.remat_policy=full",
]
GAE_TIMINGS = ("gen", "old", "ref", "values", "adv", "update_critic", "update_actor", "step")
GAE_METRICS = ("critic/vf_loss", "critic/vf_clipfrac", "critic/grad_norm", "critic/values/mean",
               "critic/returns/mean")
EVAL_ROWS, EVAL_BATCH = 8, 4


def _is_text_call(cfg):
    """A ``flash_attention`` call of the decoder (causal)."""
    return lambda q, *a, causal, **kw: causal and q.shape[-1] == cfg.text.head_dim


def _is_vision_call(cfg, windows: bool):
    """A ``flash_attention`` call of the vision tower: the batched windows form
    or full attention over the whole pack."""
    wlen = window_patch_len(cfg.vision)
    return lambda q, *a, causal, **kw: (not causal and q.shape[-1] == cfg.vision.head_dim
                                        and (q.shape[1] == wlen and q.shape[0] > 1) == windows)


def gae_path(dev, card, work_dir) -> tuple:
    """Path i: ONE ``train_step`` of the trainer with ``algorithm.adv_estimator=gae``
    at full 3B width and ``cut_depth`` (the critic shares the actor's
    preset, so its depth too; paths e and k take a step at full depth). The
    first critic micro-batch's flash calls are recorded, and #1 / #2 / #3 held
    against their plain versions on those segment ids afterwards. Returns
    (trainer, results)."""
    from spatialthinker_torch.models.qwen2_5_vl import init_params

    config = trainer_config(work_dir, GAE_OVERRIDES)
    t0 = time.perf_counter()
    cfg = qwen25_vl_3b()
    cfg = cut_depth(cfg)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(config.trainer.seed), device=dev,
                        dtype=torch.bfloat16)
    tok = load_tokenizer(config.worker.actor.model.tokenizer_path, model.cfg)
    train_ds = RLHFDataset.from_rows(scene_rows(config.data.rollout_batch_size, seed=23), tok, config.data, cfg)
    trainer = build_trainer(config, tok, model, train_ds)
    critic = trainer.critic
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    print(f"path i (gae): {TRAINER_SCRIPT} dotlist + {TRAINER_OVERRIDES} + {GAE_OVERRIDES}; built in "
          f"{time.perf_counter() - t0:.2f} s; critic {sum(p.numel() for p in critic.parameters()) / 1e9:.3f} B "
          f"params {critic.text.norm.weight.dtype}, value head {critic.value_head.weight.dtype}; resident "
          f"{resident_gb:.2f} GB (policy, reference copy, critic, both optimizers' bf16 moments)  [{card}]",
          flush=True)
    actor_sums = checksums(model.parameters())
    head_sums = checksums(critic.value_head.parameters())
    layer_sums = checksums(critic.text.layers[0].parameters())
    kept = {}
    real_values = trainer.compute_values_batched

    def values_kept(batch):
        values = real_values(batch)
        kept.update(values=values, mask=batch.tensors["response_mask"].astype(bool))
        return values

    trainer.compute_values_batched = values_kept
    real_update = trainer.update_critic
    recorded = {}

    def update_recorded(batch):
        # the first flash call of each form in the critic update: micro-batch 0's forward
        with record_call(fa, "flash_attention", 0, when=_is_text_call(cfg)) as text, \
                record_call(fa, "flash_attention", 0, when=_is_vision_call(cfg, False)) as full, \
                record_call(fa, "flash_attention", 0, when=_is_vision_call(cfg, True)) as win:
            out = real_update(batch)
        recorded.update(text=text, full=full, win=win)
        return out

    trainer.update_critic = update_recorded
    batch = next(iter(DataLoader(train_ds, config.data.rollout_batch_size, shuffle=False)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with forbid_plain_versions():
        trainer.global_step = 1
        metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb, reserved_gb = torch.cuda.max_memory_allocated() / 1e9, torch.cuda.max_memory_reserved() / 1e9
    trainer.compute_values_batched, trainer.update_critic = real_values, real_update

    values, mask = kept["values"], kept["mask"]
    printed = {f"timing_s/{k}": metrics.get(f"timing_s/{k}", float("nan")) for k in GAE_TIMINGS}
    printed.update({k: metrics.get(k, float("nan")) for k in GAE_METRICS})
    printed["rollout/probs_diff_mean"] = metrics.get("rollout/probs_diff_mean", float("inf"))
    print("path i step: " + ", ".join(f"{k} {v:.6g}" for k, v in printed.items())
          + f"; page pool the trainer chose {trainer._paged_pool_cache} pages of "
          f"{config.worker.rollout.page_size}; peak allocated {peak_gb:.2f} GB, reserved {reserved_gb:.2f} GB of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f} GB; wall {step_s:.2f} s  [{card}]",
          flush=True)
    print(f"path i launches: {launches}", flush=True)
    checks = {
        "every printed metric finite": bool(np.isfinite(list(printed.values())).all()),
        "every metric of the step finite": bool(np.isfinite(list(metrics.values())).all()),
        "critic value head moved": checksums(critic.value_head.parameters()) != head_sums,
        "critic backbone layer 0 moved": checksums(critic.text.layers[0].parameters()) != layer_sums,
        "actor moved": checksums(model.parameters()) != actor_sums,
        "values finite, 0 past each response, not all 0": bool(
            np.isfinite(values).all() and np.all(values[~mask] == 0) and np.any(values[mask] != 0)),
        "rollout/probs_diff_mean within the limit": printed["rollout/probs_diff_mean"] <= PROBS_DIFF_LIMIT,
        "both optimizers stepped once": (trainer.optimizer.state["count"] == 1
                                         and trainer.critic_optimizer.state["count"] == 1),
        "bf16 moments, no Kahan buffer": (not trainer.optimizer.state["compensation"]
                                          and not trainer.critic_optimizer.state["compensation"]
                                          and trainer.critic_optimizer.moment_dtype == torch.bfloat16),
        "every kernel of a step launched": all(launches[k] > 0 for k in TRAIN_KERNELS),
        "no dense decode kernel": launches["decode_attention"] == 0,
        "no torch._int_mm": launches["int_mm"] == 0,
        "pool sized from free memory": (trainer._paged_pool_cache or 0) > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path i checks failed: {failed}")

    segs = {k: recorded[k]["args"][3].cpu().numpy() for k in ("text", "full", "win")}
    print(f"path i first critic micro-batch: text segment ids {segs['text'].shape}, vision full "
          f"{segs['full'].shape} ({int(segs['full'].max())} images), windows {segs['win'].shape}", flush=True)
    del recorded
    torch.cuda.empty_cache()
    fwd, prep, dq, dkv = check_flash_training(
        dev, training_cases(cfg, "path_i_critic_update", segs["text"], segs["full"], segs["win"],
                            text_form="text_rows"))
    results = dict(step_s=step_s, launches=launches, peak_gb=peak_gb, reserved_gb=reserved_gb,
                   resident_gb=resident_gb, pool_pages=trainer._paged_pool_cache, metrics=printed,
                   flash=dict(fwd=fwd, prep=prep, dq=dq, dkv=dkv))
    return trainer, results


def eval_path(dev, card, trainer, work_dir) -> dict:
    """Path j: ``run_evaluation`` with a ``TorchProvider`` over path i's policy
    (bf16) on 8 in-memory rows in cv-bench's layout (the harness's loader
    replaced), ``batch_size`` 4, 64 new tokens; then the same call resumed from
    its output file."""
    from spatialthinker_torch.eval import harness as ev

    spec = ev.get_dataset_spec("cv-bench")
    tasks = sorted(spec.tasks)
    rng = np.random.default_rng(24)
    rows = []
    for i in range(EVAL_ROWS):
        choices = ["one", "two", "three", "four"][: 2 + i % 3]
        rows.append({"instruction": f"{QUESTIONS[i % len(QUESTIONS)]} ({i})",
                     "images": [(rng.random((480, 640, 3)) * 255).astype(np.uint8)],
                     "response": f"({'ABCD'[i % len(choices)]})", "choices": choices, "options": None,
                     "task": tasks[i % len(tasks)]})
    provider = TorchProvider(trainer.model, trainer.model.cfg, trainer.tokenizer, max_new_tokens=MAX_NEW_TOKENS)
    out_file = str(Path(work_dir) / "eval_cv_bench.json")
    config = ev.EvalConfig(dataset="cv-bench", batch_size=EVAL_BATCH, output_file=out_file)
    real_loader = ev.load_benchmark
    ev.load_benchmark = lambda spec, n=-1: rows
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with forbid_plain_versions():
            summary = ev.run_evaluation(provider, config)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = read_counts()
        records = json.loads(Path(out_file).read_text())["records"]
        reset_counts()
        with forbid_plain_versions():
            resumed = ev.run_evaluation(provider, config)
        torch.cuda.synchronize()
        resumed_launches = read_counts()
    finally:
        ev.load_benchmark = real_loader
    print(f"path j (eval): {len(records)} records of cv-bench-shaped rows (640 x 480, 2-4 choices) in "
          f"{eval_s:.2f} s = {eval_s / EVAL_ROWS:.3f} s a request (batch {EVAL_BATCH}, {MAX_NEW_TOKENS} new "
          f"tokens); summary {json.dumps(summary)}; launches {launches}; resumed call launches "
          f"{ {k: v for k, v in resumed_launches.items() if v} }  [{card}]", flush=True)
    checks = {
        "8 records written": len(records) == EVAL_ROWS,
        "summary keys are summarize's": set(summary) == set(ev.summarize(records, spec.tasks)),
        "summary is summarize's": summary == ev.summarize(records, spec.tasks),
        "flash forward and dense decode launched": launches["flash_fwd"] > 0 and launches["decode_attention"] > 0,
        "resumed call launches neither": resumed_launches["flash_fwd"] == resumed_launches["decode_attention"] == 0,
        "resumed call gives the same summary": resumed == summary,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path j checks failed: {failed}")
    return dict(seconds=eval_s, seconds_per_request=eval_s / EVAL_ROWS, launches=launches, summary=summary)


# ---------------------------------------------------------------------------
# path k: the shipped 7B script through the trainer, host-resident state
# ---------------------------------------------------------------------------

SEVENB_SCRIPT = "scripts/spatialthinker_7b_grpo.sh"
SEVENB_OVERRIDES = [
    # the two knobs that fit 7B GRPO on one card: bf16 moments (and the Kahan
    # buffer) streamed from the host, the reference copy on the host
    "worker.actor.optim.stream=true", "worker.ref.offload=true",
    # path e's deploy-scale cuts: 16 prompts x n 8, prompt 512, response 64,
    # one card, one step, no validation, no saves
    "worker.actor.model.model_path=Qwen/Qwen2.5-VL-7B-Instruct",
    "worker.actor.model.tokenizer_path=synthetic",
    "data.rollout_batch_size=16", "data.max_prompt_length=512", "data.max_response_length=64",
    "trainer.n_chips=1", "trainer.max_steps=1",
    "trainer.val_before_train=false", "trainer.val_freq=-1", "trainer.save_freq=-1",
    "trainer.logger=['console','jsonl']",
]
SEVENB_TIMINGS = ("gen", "reward", "old", "ref", "adv", "update_actor", "step")
# the 7B linears' kernel A cases: path k's decode lanes (128 slots + trash)
# and a refill prefill (prefill_rows 8 x prompt 512)
SEVENB_W8A8_MS = (129, 4096)
# the paged decode call to record: the last layer at the middle decode step
# (every slot live, the first response page partly written)
SEVENB_PAGED_PICK_STEP = MAX_NEW_TOKENS // 2


def meminfo_gb() -> dict:
    """``MemTotal`` and ``MemAvailable`` of ``/proc/meminfo``, in GB."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, value = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(value.split()[0]) * 1024 / 1e9
    return out


def compact_paged_call(args, kwargs):
    """The inputs of one paged decode call with the pool cut to the pages its
    page table names in its layer (a card-sized pool is not copied): the
    call's arithmetic is unchanged, the table renumbered."""
    q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale = args[:8]
    used, remap = torch.unique(table, return_inverse=True)
    cut = lambda pool: None if pool is None else pool[layer][used].unsqueeze(0).clone()  # noqa: E731
    kept = (q.clone(), cut(k_pool), cut(v_pool), remap.to(torch.int32).contiguous(), lengths.clone(), 0,
            cut(k_scale), cut(v_scale))
    return kept, {k: v for k, v in kwargs.items() if k in ("int4_i8dot", "staged")}


def paged_call_case(kind: str, args, label: str) -> dict:
    """A paged kernel vs its plain version on one call's inputs (no staged
    block): output and partial-softmax stats, two more calls bit-identical,
    the plan, both times, the byte bound over the live cells."""
    q, k_pool = args[0], args[1]
    lengths = args[4]
    i8 = kind == "int4_i8"
    plain = {"int4_i8": pa.paged_attention_int4_i8_plain,
             "int4": pa.paged_attention_int4_plain}.get(kind, pa.paged_attention_plain)
    scale = q.shape[-1] ** -0.5
    o_ref, m_ref, l_ref = plain(*args, scale)
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=i8)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    stat_err = max((m - m_ref).abs().max().item(), ((l - l_ref).abs() / (1 + l_ref.abs())).max().item())
    plan, twice = paged_plan_and_twice(kind, args)
    plain_ms = cuda_ms(lambda: plain(*args, scale), iters=5)
    ms = cuda_ms(lambda: pa.paged_attention(*args, return_stats=True, int4_i8dot=i8))
    hq, d, hkv = q.shape[1], q.shape[2], k_pool.shape[2]
    cells = int(lengths.sum())
    value_bytes = {"bf16": 2.0, "int8": 1.0, "int4_i8": 0.5, "int4": 0.5}[kind]
    cell_bytes = 2 * hkv * (d * value_bytes + (0 if kind == "bf16" else 2))
    b_ms, b_by = bound_ms(cells * cell_bytes + nbytes(q, o, m, l, args[3], lengths), 4.0 * cells * hq * d,
                          "int8" if i8 else "bf16")
    print(f"paged {kind} [{label}]: q{tuple(q.shape)} G={hq // hkv} pool pages of the call "
          f"{tuple(k_pool.shape)} cells={cells} max_abs_err={err:.3e} stat_err={stat_err:.3e} "
          f"bit_identical_twice={twice} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
          f"plan={json.dumps(plan)}", flush=True)
    if not (err <= PAGED_OUT_ATOL[kind] and stat_err <= PAGED_STAT_ATOL and twice):
        raise AssertionError(f"paged kernel ({kind}) disagrees with plain or with itself [{label}]")
    return dict(shape=label, max_abs_err=err, stat_err=stat_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, bit_identical_twice=twice, plan=plan)


def sevenb_path(dev, card, work_dir) -> dict:
    """Path k: ONE step of ``GRPOTrainer.fit`` on the dotlist of
    ``scripts/spatialthinker_7b_grpo.sh`` with ``SEVENB_OVERRIDES``: the 7B
    preset at full width and depth (28 x 3584 text, G = 7), the moments
    streamed from the host, the reference copy on the host. The update's
    first text flash call, a mid-decode paged call (cut to its pages), the
    first silu junction call and a decode call of kernel A are recorded and
    each kernel held against its plain version afterwards, beside kernel A at
    the five 7B linears."""
    config = build_config(script_dotlist(SEVENB_SCRIPT) + SEVENB_OVERRIDES
                          + [f"trainer.save_checkpoint_path={work_dir}"])
    mem_before = meminfo_gb()
    t0 = time.perf_counter()
    model = build_model(config)
    tok = load_tokenizer(config.worker.actor.model.tokenizer_path, model.cfg)
    cfg = model.cfg
    train_ds = RLHFDataset.from_rows(scene_rows(config.data.rollout_batch_size, seed=31), tok, config.data, cfg)
    trainer = build_trainer(config, tok, model, train_ds)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    opt_state = trainer.optimizer.state
    pinned = {
        "reference copy": host_bytes(trainer.ref_host),
        "moments (mu, nu)": sum(t.numel() * t.element_size() for part in ("mu", "nu")
                                for t in opt_state[part].values()),
        "Kahan buffer": sum(t.numel() * t.element_size() for t in opt_state["compensation"].values()),
    }
    mem_after = meminfo_gb()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    roll = config.worker.rollout
    n_params = sum(p.numel() for p in model.parameters())
    print(f"path k (7b): {SEVENB_SCRIPT} dotlist + {SEVENB_OVERRIDES}; {n_params / 1e9:.3f} B params, "
          f"G = {cfg.text.num_attention_heads // cfg.text.num_key_value_heads}, built in {build_s:.2f} s; engine "
          f"name={roll.name} page_size={roll.page_size} kv_cache_dtype={roll.kv_cache_dtype} "
          f"quantization={roll.quantization} int4_i8dot={roll.int4_i8dot} slots={roll.decode_batch_size} "
          f"n={roll.n}; remat_policy={config.worker.actor.sharding.remat_policy}, optimizer "
          f"{type(trainer.optimizer).__name__} (Kahan {trainer.optimizer.use_kahan_summation}); host before "
          f"the build: MemTotal {mem_before['MemTotal']:.2f} GB, MemAvailable {mem_before['MemAvailable']:.2f} "
          f"GB; host pinned: " + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in pinned.items())
          + f" (total {sum(pinned.values()) / 1e9:.2f} GB), MemAvailable after {mem_after['MemAvailable']:.2f} "
          f"GB; card resident {resident_gb:.2f} GB (the policy)  [{card}]", flush=True)
    ref_sums = [float(torch.sum(h.buffer.to(dev), dtype=torch.float64)) for h in trainer.ref_host.values()]
    p_sums = checksums(model.parameters())

    layers = cfg.text.num_hidden_layers
    recorded = {}
    # the card's peak (allocated, reserved) of each phase: the counters restart
    # at a phase's start, and "step" keeps the largest seen
    peaks = {"step": (0, 0)}

    def peak_now():
        return torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()

    def fold(name, peak):
        peaks[name] = tuple(map(max, peaks.get(name, (0, 0)), peak))
        peaks["step"] = tuple(map(max, peaks["step"], peak))

    def phase(name, fn):
        def run(*args, **kwargs):
            fold("step", peak_now())
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            fold(name, peak_now())
            return out
        return run

    def update_recorded(batch):
        with record_call(fa, "flash_attention", 0, when=_is_text_call(cfg)) as text:
            out = real_update(batch)
        recorded["text"] = text
        return out

    real_update, real_gen, real_logp = (trainer.update_actor, trainer.generate_sequences,
                                        trainer.compute_log_probs_batched)
    trainer.update_actor = phase("update", update_recorded)
    trainer.generate_sequences = phase("gen", real_gen)
    trainer.compute_log_probs_batched = phase("old and ref log-probs", real_logp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with forbid_plain_versions(), \
            record_call(tpaged, "paged_attention", layers * SEVENB_PAGED_PICK_STEP + layers - 1,
                        keep=compact_paged_call) as paged_rec, \
            record_call(sq, "fused_silu_quantize", 0) as silu_rec, \
            record_call(tq, "fused_w8a8_matmul", 2,  # layer 0's gate_up at the first decode step
                        when=lambda x, *a, **kw: x.shape[0] == roll.decode_batch_size + 1) as w8_rec:
        trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counts()  # inside: a recorder holds the silu junction's count while it is installed
    fold("step", peak_now())
    peak_gb, reserved_gb = (b / 1e9 for b in peaks["step"])
    phase_peaks = ", ".join(f"{k} {a / 1e9:.2f} / {r / 1e9:.2f}" for k, (a, r) in peaks.items() if k != "step")
    trainer.update_actor, trainer.generate_sequences, trainer.compute_log_probs_batched = (
        real_update, real_gen, real_logp)
    log = Path(work_dir) / f"{config.trainer.experiment_name}_metrics.jsonl"
    rec = {r["step"]: r for r in map(json.loads, log.read_text().splitlines())}.get(1, {})
    stats = dict(trainer.host_state_stats)
    moved = sum(a != b for a, b in zip(p_sums, checksums(model.parameters())))
    ref_now = [float(torch.sum(h.buffer.to(dev), dtype=torch.float64)) for h in trainer.ref_host.values()]
    moments_nonzero = sum(bool(t.any()) for t in opt_state["mu"].values())
    printed = {f"timing_s/{k}": rec.get(f"timing_s/{k}", float("nan")) for k in SEVENB_TIMINGS}
    for k in ("perf/throughput", "perf/mfu_actor", "rollout/probs_diff_mean", "actor/grad_norm",
              "actor/kl_loss", "actor/pg_loss", "response_length/mean", "rollout/kv_peak_pages",
              "rollout/kv_total_pages", "rollout/kv_preemptions"):
        printed[k] = rec.get(k, float("nan"))
    print("path k step: " + ", ".join(f"{k} {v:.6g}" for k, v in printed.items())
          + f"; ref restore {stats.get('ref_restore_s', float('nan')):.3f} s for "
          f"{stats.get('ref_restore_bytes', 0) / 1e9:.2f} GB; streamed apply "
          f"{stats.get('apply_s', float('nan')):.3f} s, {stats.get('apply_bytes_each_way', 0) / 1e9:.2f} GB "
          f"each way; page pool the trainer chose {trainer._paged_pool_cache} pages of {roll.page_size}; "
          f"resident {resident_gb:.2f} GB, peak allocated {peak_gb:.2f} GB, reserved {reserved_gb:.2f} GB of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f} GB; fit {fit_s:.2f} s  [{card}]",
          flush=True)
    print(f"path k peak allocated / reserved GB by phase: {phase_peaks}", flush=True)
    print(f"path k launches: {launches}", flush=True)
    checks = {
        "one step record": trainer.global_step == 1 and bool(rec),
        "every printed metric finite": bool(np.isfinite(list(printed.values())).all()),
        "every metric of the step finite": bool(np.isfinite([v for k, v in rec.items() if k != "step"]).all()),
        "gradient norm > 0": printed["actor/grad_norm"] > 0,
        "parameters moved": moved > 0,
        "host reference copy untouched": ref_now == ref_sums,
        "streamed optimizer stepped once, host moments moved": (
            opt_state["count"] == 1 and moments_nonzero > 0
            and not next(iter(opt_state["mu"].values())).is_cuda),
        "streamed bytes each way = the host moments": stats.get("apply_bytes_each_way") == (
            pinned["moments (mu, nu)"] + pinned["Kahan buffer"]),
        "rollout/probs_diff_mean within the limit": printed["rollout/probs_diff_mean"] <= PROBS_DIFF_LIMIT,
        "every kernel of a step launched": all(launches[k] > 0 for k in TRAIN_KERNELS),
        "no dense decode kernel": launches["decode_attention"] == 0,
        "no torch._int_mm": launches["int_mm"] == 0,
        "pool sized from free memory": (trainer._paged_pool_cache or 0) > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path k checks failed: {failed}")
    seg_text = recorded.pop("text")["args"][3].cpu().numpy()
    pool_pages = trainer._paged_pool_cache
    del trainer, model, real_update, real_gen, real_logp, recorded
    gc.collect()
    torch.cuda.empty_cache()

    # the path's kernels at G = 7 against their plain versions, on what the path gave them
    tc = cfg.text
    fwd, prep, dq, dkv = check_flash_training(dev, [(
        "path_k_update_text_packed_rows", (tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim),
        np.asarray(seg_text, np.int32), True)])
    paged_args = paged_rec["args"]
    if not paged_rec["kwargs"].get("int4_i8dot"):
        raise AssertionError("path k's recorded paged call is not the int4_i8 mode")
    paged = [paged_call_case("int4_i8", paged_args,
                             f"path_k_{paged_args[0].shape[0]}_lanes_page_{2 * paged_args[1].shape[3]}"
                             f"_step_{SEVENB_PAGED_PICK_STEP}")]
    silu = silu_case(silu_rec["args"][0], f"path_k_refill_rows_{silu_rec['args'][0].shape[0]}")
    w8a8 = [recorded_w8a8_case(w8_rec, "path_k_decode")]
    del paged_rec, silu_rec, w8_rec
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(12)
    for name, (k, n, out_dtype) in w8a8_linears(cfg).items():
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-4
        for m in SEVENB_W8A8_MS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            w8a8.append(w8a8_case(x, w, ws, out_dtype, f"7b_{name}_m{m}"))
        del w, ws
        torch.cuda.empty_cache()
    return dict(fit_s=fit_s, build_s=build_s, launches=launches, peak_gb=peak_gb, reserved_gb=reserved_gb,
                phase_peak_bytes={k: v for k, v in peaks.items() if k != "step"}, resident_gb=resident_gb, pool_pages=pool_pages, host_pinned_bytes=pinned,
                meminfo_before=mem_before, meminfo_after_build=mem_after, metrics=printed, host_state=stats,
                kernels=dict(fwd=fwd, prep=prep, dq=dq, dkv=dkv, paged=paged, silu=silu, w8a8=w8a8))


def prefill_dequant_cases(dev, cfg) -> list:
    """A record, not a check: the prefill-dequant mode's product
    (``quantize_model(prefill_dequant_min_m=...)``: the weight dequantized,
    then one bf16 ``torch.matmul``) beside kernel A at the 3B gate_up and
    m = 1,024 and 4,096 rows, on the same int8 weight."""
    gen = torch.Generator(device=dev).manual_seed(13)
    k, n, _ = w8a8_linears(cfg)["gate_up"]
    qw = {"qvalue": torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8),
          "scale": torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-4}
    out = []
    for m in (1024, 4096):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        dequant = {**qw, "dequant_min_m": m}
        ms = cuda_ms(lambda: tq.quantized_dot(x, dequant, 1))
        kernel_ms = cuda_ms(lambda: tq.quantized_dot(x, qw, 1))
        diff = (tq.quantized_dot(x, dequant, 1).float() - tq.quantized_dot(x, qw, 1).float()).abs().max().item()
        print(f"prefill dequant [3b_gate_up_m{m}]: x({m}, {k}) w({n}, {k}) dequantize + bf16 matmul "
              f"ms={ms:.4f} beside kernel A ms={kernel_ms:.4f} (ratio {ms / kernel_ms:.2f}); max |difference| "
              f"{diff:.3e} (bf16 weights against W8A8)", flush=True)
        out.append(dict(shape=f"3b_gate_up_m{m}", dequant_ms=ms, kernel_a_ms=kernel_ms, max_abs_difference=diff))
    return out


# ---------------------------------------------------------------------------
# path l: the trainer's distributed branch (one rank over NCCL) and sequence
# parallelism (two ranks on one card over gloo), each in processes of its own
# ---------------------------------------------------------------------------

# (l1) the wrapped model against itself unwrapped at world 1: FSDP's gather
# of one shard is a copy, so the same kernels see the same weights
L1_LOGP_ATOL = 1e-3
# (l2) ring / Ulysses at sp = 2 against one flash call on the whole row: the
# flash checks' limits (bf16 outputs; the ring merges bf16 partial outputs in
# fp32, Ulysses runs the same kernel on a head slice)
SP_OUT_ATOL = OUT_ATOL
SP_GRAD_REL_TOL = BWD_REL_TOL
# the 4-layer 3B model's packed log-probs at sp = 2 against sp = 1 on the
# card: bf16 activations through 4 layers and 32 vision blocks, attention
# rounded at other points (the ring's merge, Ulysses' head slices)
SP_LOGP_ATOL = 5e-2
SP_ROW = (6144, 1024, 1024)  # one packed row: the shipped 6,144 + 2,048 in three segments
SP_WIDTHS = {"3b": (16, 2), "7b": (28, 4)}  # (q heads, kv heads), head dim 128
SP_MODEL_LAYERS = 4
PATH_L_TIMEOUT_S = 600
FLASH_COUNTS = ("flash_fwd", "flash_ranges", "flash_bwd_prep", "flash_bwd_dq", "flash_bwd_dkv")


def _run_ranks(args_per_rank, timeout: float, check=True):
    """This script's rank entry points as processes of their own (the smoke's
    process keeps no process group), all started at once; every one is
    stopped at ``timeout``. ``check``: fail on a non-zero exit, for every
    process or (a list) for those marked True."""
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *map(str, a)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for a in args_per_rank]
    deadline = time.perf_counter() + timeout
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(deadline - time.perf_counter(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append((p.communicate()[0] or "") + "\ntimed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    checked = check if isinstance(check, list) else [check] * len(procs)
    for p, log, c in zip(procs, logs, checked):
        if c:
            if p.returncode != 0:
                raise AssertionError(f"path l rank {args_per_rank[procs.index(p)]} exited "
                                     f"{p.returncode}:\n{log[-6000:]}")
    return procs, logs


def sp_fake_rollout(batch: RolloutBatch, vocab: int, seed: int, r: int = MAX_NEW_TOKENS) -> RolloutBatch:
    """The prompts with ``r`` seeded response tokens each (every token valid)."""
    base = gt.trim_prompt_padding(batch)
    rng = np.random.default_rng(seed)
    responses = rng.integers(5, vocab, size=(len(base), r)).astype(np.int32)
    return rollout_batch_from_result(base, responses, np.ones_like(responses), np.zeros(responses.shape, np.float32))


def path_l1_rank(work_dir: str, out: str) -> int:
    """(l1) in its own process: one rank over NCCL, the trainer's distributed
    branch on path (e)'s dotlist at ``cut_depth`` (full width), ONE
    step of 128 samples (path e takes the same step at full depth)."""
    from spatialthinker_torch.models.qwen2_5_vl import init_params
    from spatialthinker_torch.parallel.multihost import initialize_if_needed

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    initialize_if_needed("cuda", init_method=f"file://{work_dir}/l1_store", world_size=1, rank=0)
    config = trainer_config(work_dir, extra=[
        "worker.actor.sharding.fsdp_size=-1", "trainer.max_steps=1", "trainer.val_before_train=false"])
    cfg = qwen25_vl_3b()
    cfg = cut_depth(cfg)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(config.trainer.seed), device=dev,
                        dtype=torch.bfloat16)
    tok = load_tokenizer(config.worker.actor.model.tokenizer_path, model.cfg)
    train_ds = RLHFDataset.from_rows(scene_rows(config.data.rollout_batch_size, seed=21), tok, config.data,
                                     model.cfg)
    rolled = sp_fake_rollout(next(iter(DataLoader(train_ds, 16, shuffle=False))), model.cfg.text.vocab_size, 5)
    micro = config.worker.actor.micro_batch_size_per_device_for_experience
    plain = compute_log_probs_batched(model, rolled, micro_batch_size=micro, device=dev)
    trainer = build_trainer(config, tok, model, train_ds)
    wrapped = compute_log_probs_batched(trainer.model, rolled, micro_batch_size=micro, device=dev,
                                        lockstep=trainer.lockstep)
    diff = float(np.abs(wrapped - plain).max())
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    p_sums = checksums(p.to_local() for p in trainer.model.parameters())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with forbid_plain_versions():
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    log = Path(work_dir) / f"{config.trainer.experiment_name}_metrics.jsonl"
    rec = {r["step"]: r for r in map(json.loads, log.read_text().splitlines())}.get(1, {})
    moved = sum(a != b for a, b in zip(p_sums, checksums(p.to_local() for p in trainer.model.parameters())))
    Path(out).write_text(json.dumps({
        "logp_diff": diff, "bit_equal": diff == 0.0, "resident_gb": resident_gb,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "reserved_gb": torch.cuda.max_memory_reserved() / 1e9, "fit_s": fit_s, "moved": moved,
        "sharded": type(next(trainer.model.parameters())).__name__,
        "world": torch.distributed.get_world_size(), "backend": torch.distributed.get_backend(),
        "launches": launches, "record": {k: v for k, v in rec.items() if k != "time"},
        "pool_pages": trainer._paged_pool_cache}))
    torch.distributed.destroy_process_group()
    return 0


def _sp_row(dev, hq: int, hkv: int, seed: int):
    """One packed row of sum(SP_ROW) tokens (segments 1, 2, 3) at head dim
    128: bf16 q, k, v and dO made alike on every rank."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = sum(SP_ROW)
    q, do = (torch.randn((1, s, hq, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, s, hkv, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    seg = torch.cat([torch.full((n,), i + 1, dtype=torch.int32, device=dev) for i, n in enumerate(SP_ROW)])[None]
    return q, k, v, seg, do


def _sp_model_batch(cfg, dev, seed: int):
    """One packed row of sum(SP_ROW) tokens with one 448 x 448 image in its
    first segment (256 merged tokens), labels and a loss mask, and the
    image's vision pack."""
    from spatialthinker_torch.data.packing import pack_vision_batch, patch_dim
    from spatialthinker_torch.trainer.train_step import PackedTrainBatch

    rng = np.random.default_rng(seed)
    s = sum(SP_ROW)
    vcfg = cfg.vision
    grid = np.asarray([[1, 32, 32]], dtype=np.int64)  # 1,024 patches, 256 merged tokens
    n_img = int(grid.prod()) // vcfg.spatial_merge_unit
    ids = rng.integers(5, cfg.text.vocab_size, size=(1, s)).astype(np.int64)
    ids[0, 16 : 16 + n_img] = cfg.image_token_id
    seg = np.concatenate([np.full(n, i + 1, np.int32) for i, n in enumerate(SP_ROW)])[None]
    pos = np.concatenate([np.arange(n) for n in SP_ROW])[None, None].repeat(3, 0).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    mask = np.ones((1, s), np.float32)
    mask[0, np.cumsum(SP_ROW) - 1] = 0  # a segment's last token predicts nothing
    patches = rng.normal(size=(int(grid.prod()), patch_dim(vcfg))).astype(np.float32)
    vision = vision_to_device(pack_vision_batch([patches], [grid], vcfg), dev)
    zeros = np.zeros((1, s), np.float32)
    batch = PackedTrainBatch(*(torch.as_tensor(x, device=dev) for x in (ids, seg, pos, labels, mask, zeros, zeros, zeros)))
    return batch, vision


def path_l2_rank(rank: int, store: str, out: str) -> int:
    """(l2) in its own process: rank ``rank`` of two on ``cuda:0`` over a gloo
    group (NCCL refuses two ranks on one device): ring and Ulysses attention
    at sp = 2 against one flash call on the whole row, at 3B's and 7B's heads,
    then the 4-layer 3B model's packed log-probs at sp = 2 against sp = 1."""
    import torch.distributed as dist

    from spatialthinker_torch.models.qwen2_5_vl import init_params
    from spatialthinker_torch.ops import ulysses
    from spatialthinker_torch.ops.ring import ring_attention
    from spatialthinker_torch.trainer.train_step import compute_packed_log_probs

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    specs = {name: ulysses.UlyssesSpec(dist.group.WORLD, backend=name) for name in ("ring", "ulysses")}
    fns = {"ring": ring_attention, "ulysses": ulysses.ulysses_attention}
    res = {"rank": rank, "backend": dist.get_backend(), "attention": {}, "model": {}}
    for width, (hq, hkv) in SP_WIDTHS.items():
        q, k, v, seg, do = _sp_row(dev, hq, hkv, seed=17)
        scale = 128 ** -0.5

        def whole():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fa.flash_attention(*leaves, seg, seg, causal=True, scale=scale)
            o.backward(do)
            return o, [t.grad for t in leaves]

        ref_o, ref_g = whole()
        one_rank_ms = cuda_ms(whole, iters=3, warmup=1)
        for name, spec in specs.items():
            chunk = lambda t: ulysses.seq_chunk(t, spec)  # noqa: E731

            def sp_call():
                leaves = [chunk(t).detach().clone().requires_grad_() for t in (q, k, v)]
                o = fns[name](*leaves, spec, segment_ids=chunk(seg), causal=True)
                o.backward(chunk(do))
                return o, [t.grad for t in leaves]

            dist.barrier()
            reset_counts()
            o, grads = sp_call()
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if k in FLASH_COUNTS}
            err = float((o.float() - chunk(ref_o).float()).abs().max())
            grad_rel = [float((g.float() - chunk(r).float()).abs().max() / chunk(r).float().abs().max())
                        for g, r in zip(grads, ref_g)]
            dist.barrier()
            sp_call()
            copy0 = dict(ulysses.HOST_COPY)
            sp_ms = cuda_ms(sp_call, iters=3, warmup=0)  # the host copies of these 3 calls only
            copy_s = (ulysses.HOST_COPY["seconds"] - copy0["seconds"]) / 3
            copy_mb = (ulysses.HOST_COPY["bytes"] - copy0["bytes"]) / 3 / 1e6
            res["attention"][f"{name}_{width}"] = dict(
                max_abs_err=err, grad_rel_err=grad_rel, launches=counts, sp_ms=sp_ms, one_rank_ms=one_rank_ms,
                host_copy_s=copy_s, host_copy_mb=copy_mb,
                ok=err <= SP_OUT_ATOL and max(grad_rel) <= SP_GRAD_REL_TOL)
    cfg = qwen25_vl_3b()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=SP_MODEL_LAYERS))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(23), device=dev, dtype=torch.bfloat16)
    batch, vision = _sp_model_batch(cfg, dev, seed=29)
    with torch.no_grad():
        sp1 = model(compute_packed_log_probs, batch, vision)[0]
        mask = batch.loss_mask.bool()
        for name, spec in specs.items():
            reset_counts()
            sp2 = model(compute_packed_log_probs, batch, vision, sp=spec)[0]
            torch.cuda.synchronize()
            diff = float((sp2 - sp1)[mask].abs().max())
            res["model"][name] = dict(max_abs_diff=diff, ok=diff <= SP_LOGP_ATOL,
                                      launches={k: v for k, v in read_counts().items() if k in FLASH_COUNTS},
                                      finite=bool(torch.isfinite(sp2).all()), mean_logp=float(sp2[mask].mean()))
    Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def nccl_probe_rank(rank: int, store: str, out: str) -> int:
    """Two NCCL ranks on one device, one all-reduce: what NCCL says."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=2)
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        result = f"no error: all_reduce gave {float(t)}"
    except Exception as e:  # noqa: BLE001 -- the probe reports what NCCL raised
        result = f"{type(e).__name__}: " + next((line for line in str(e).splitlines() if line.strip()), "")
    Path(out).write_text(result)
    return 0


def path_l(card: str, work_dir: str) -> dict:
    """Path l: (l1) the trainer's distributed branch at world 1 over NCCL and
    (l2) ring / Ulysses sequence parallelism at sp = 2 on one card, each in
    processes of their own, the kernels already built by this process."""
    t_start = time.perf_counter()
    work = Path(work_dir)
    _run_ranks([["--path-l1", work, work / "l1.json"]], PATH_L_TIMEOUT_S)
    l1 = json.loads((work / "l1.json").read_text())
    rec = l1["record"]
    timing = {k.split("/", 1)[1]: v for k, v in rec.items() if k.startswith("timing_s/")}
    print(f"path l1 (the distributed branch, {TRAIN_LAYERS} of 36 text layers and {TRAIN_VISION_DEPTH} of 32 vision "
          f"blocks, {l1['world']} rank over "
          f"{l1['backend']}, parameters "
          f"{l1['sharded']}): packed log-probs wrapped vs unwrapped max abs {l1['logp_diff']:.3e} (limit "
          f"{L1_LOGP_ATOL}, bit-equal {l1['bit_equal']}); step: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in sorted(timing.items()))
          + f"; throughput {rec.get('perf/throughput', float('nan')):.1f} tok/s, mfu_actor "
          f"{rec.get('perf/mfu_actor', float('nan')):.4f}, probs_diff_mean "
          f"{rec.get('rollout/probs_diff_mean', float('nan')):.4f}, grad_norm "
          f"{rec.get('actor/grad_norm', float('nan')):.3e}; pool {l1['pool_pages']} pages; resident "
          f"{l1['resident_gb']:.2f} GB, peak allocated {l1['peak_gb']:.2f} GB, reserved {l1['reserved_gb']:.2f} GB "
          f"[{card}]; launches {l1['launches']}", flush=True)
    # the NCCL probe (which must fail) beside the two gloo ranks of l2: its processes hold
    # nothing on the card but NCCL's refusal
    _run_ranks([["--nccl-probe", r, work / "nccl_store", work / f"nccl{r}.txt"] for r in range(2)]
               + [["--path-l2", r, work / "l2_store", work / f"l2_{r}.json"] for r in range(2)], PATH_L_TIMEOUT_S,
               check=[False, False, True, True])
    nccl = [(work / f"nccl{r}.txt").read_text() if (work / f"nccl{r}.txt").exists() else "no report"
            for r in range(2)]
    print(f"path l2: NCCL with two ranks on one device: {nccl[0]} | {nccl[1]}", flush=True)
    l2 = [json.loads((work / f"l2_{r}.json").read_text()) for r in range(2)]
    for key in l2[0]["attention"]:
        for r in l2:
            a = r["attention"][key]
            print(f"path l2 {key} rank {r['rank']} ({r['backend']}, sp 2 on one card): max_abs_err "
                  f"{a['max_abs_err']:.3e} (limit {SP_OUT_ATOL}), dq/dk/dv "
                  + "/".join(f"{e:.2e}" for e in a["grad_rel_err"]) + f" of the largest (limit {SP_GRAD_REL_TOL}); "
                  f"sp-2 call {a['sp_ms']:.3f} ms (fwd + bwd, of which host copies {a['host_copy_s'] * 1e3:.3f} ms "
                  f"for {a['host_copy_mb']:.2f} MB) against one rank on the whole row {a['one_rank_ms']:.3f} ms "
                  f"[{card}]; launches {a['launches']}", flush=True)
    for name in ("ring", "ulysses"):
        for r in l2:
            m = r["model"][name]
            print(f"path l2 model {name} rank {r['rank']}: 3B width, {SP_MODEL_LAYERS} text layers + the whole "
                  f"vision tower, one {sum(SP_ROW)}-token packed row with one image: sp 2 vs sp 1 log-probs max "
                  f"abs {m['max_abs_diff']:.3e} (limit {SP_LOGP_ATOL}), mean {m['mean_logp']:.3f}, launches "
                  f"{m['launches']}", flush=True)
    checks = {
        "l1: a distributed step over NCCL with sharded parameters": l1["backend"] == "nccl"
        and l1["sharded"] == "DTensor" and bool(rec),
        "l1: wrapped log-probs within the limit": l1["logp_diff"] <= L1_LOGP_ATOL,
        "l1: parameters moved": l1["moved"] > 0,
        "l1: every kernel of a step launched": all(l1["launches"][k] > 0 for k in TRAIN_KERNELS),
        "l1: no torch._int_mm": l1["launches"]["int_mm"] == 0,
        "l1: rollout/probs_diff_mean within the limit": rec.get("rollout/probs_diff_mean", np.inf) <= PROBS_DIFF_LIMIT,
        "l1: finite metrics": all(np.isfinite(v) for k, v in rec.items() if isinstance(v, (int, float))),
        "l2: NCCL refused two ranks on one device": not any(x.startswith("no error") for x in nccl),
        "l2: ring / Ulysses within the limits": all(a["ok"] for r in l2 for a in r["attention"].values()),
        "l2: the flash kernels launched on every rank": all(
            a["launches"][k] > 0 for r in l2 for a in r["attention"].values() for k in FLASH_COUNTS),
        "l2: sp 2 model log-probs within the limit": all(m["ok"] and m["finite"] for r in l2 for m in r["model"].values()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path l checks failed: {failed}")
    seconds = time.perf_counter() - t_start
    print(f"path l: {seconds:.1f} s", flush=True)
    return {"l1": l1, "l2": l2, "nccl_two_ranks_one_device": nccl, "seconds": seconds}


# ---------------------------------------------------------------------------
# path m: Megatron tensor parallelism on the model axis (two ranks on one card
# over gloo, each in a process of its own), and the kernels at the TP-local
# shapes a rank of a TP group gives them
# ---------------------------------------------------------------------------

# (m1) the 4-layer 3B model's packed log-probs at tp = 2 against the unsharded
# model. In fp32 (plain attention) the two differ only in summation order:
# every GEMM of the TP model has other widths, the row-parallel partials and
# the vocab reductions are summed across ranks.
TP_FP32_LOGP_ATOL = 2e-3
# In bf16 through the kernels every GEMM of other widths rounds at other
# points (1.04e-1 max abs over the 8,191 labels against the unsharded bf16
# model on an H100, where ring sp, which changes attention only, gave 4.3e-2):
# the TP model may be at most this many times as far from the fp32 model as
# the unsharded bf16 model is. Planted faults are run beside it as negative
# controls: those of TP_FAULTS_SEEN must read above the limit; the bf16-
# partials fault is read and printed (that the partials reach the group's
# sum in fp32 is checked on the forward's calls themselves).
TP_BF16_DRIFT_RATIO = 2.0
TP_FAULTS_SEEN = ("heads", "vocab")
TP_SHAPES = {"3b": (qwen25_vl_3b, 2), "7b": (qwen25_vl_7b, 4)}  # (preset, its largest tp)
TP_MS = (129, 4096)
# (m2) each rank's page pool: two processes share one card, so neither sizes
# its pool from what the card has free (the other rank's allocations race it)
TP_M2_PAGES = 1024
# n 8 as shipped; 3 prompts: the refill's prefill has 3 x 512 rows, above the
# silu junction's threshold (FUSED_SILU_MIN_M, 1,024), so #12's split mode
# runs (one prompt's 512 would not). Every forward's row-parallel sums cross
# host memory through gloo, the vision tower's most of all, so the depth is
# cut (text and vision) rather than the lanes: 24 samples check correctness,
# their step time is no measurement of TP.
TP_M2_PROMPTS, TP_M2_N = 3, 8
TP_M2_LAYERS = 4
# (m3) the same trainer after (m2)'s step, its own generate_sequences on 2 prompts x n 4 with the
# engines (m2) does not run under TP: label, rollout knobs, the kernels it must launch, its limit on
# rollout/probs_diff_mean. The continuous engine gets 4 slots (8 lanes) for its 8 rows: one prompt's
# group at a time, so the TP group harvests and refills in lockstep mid-decode
TP_M3_PROMPTS, TP_M3_N = 2, 4
TP_M3_CASES = (
    ("dense_w4a8", dict(name="jax", quantization="w4a8", kv_cache_dtype="int4", int4_i8dot=True),
     ("int4_gateup", "int4_down_split", "decode_attention_int4_i8"), W4_PROBS_DIFF_LIMIT),
    ("continuous_int8", dict(name="continuous", page_size=0, quantization="int8", kv_cache_dtype="int8",
                             int4_i8dot=False, decode_batch_size=4), ("decode_attention_int8",), PROBS_DIFF_LIMIT),
)
# (m3)'s check of the w4a8 MLP itself: rows of one decode step (path m3's 8) through layer 0's MLP
TP_M3_MLP_ROWS = 8
TP_KERNELS = ("flash_fwd", "flash_ranges", "flash_bwd_prep", "flash_bwd_dq", "flash_bwd_dkv",
              "paged_attention_int4_i8", "silu_amax", "silu_with_amax", "quant_amax", "quant_with_amax", "w8a8",
              "w8a8_prequantized")
PATH_M_TIMEOUT_S = 600


def tp_linears(cfg, tp: int) -> dict:
    """The four decoder linears of one rank of a TP group of ``tp``: (K, N)."""
    tc = cfg.text
    hd, hq, hkv, inter = tc.head_dim, tc.num_attention_heads // tp, tc.num_key_value_heads // tp, \
        tc.intermediate_size // tp
    return {"qkv": (tc.hidden_size, (hq + 2 * hkv) * hd), "o": (hq * hd, tc.hidden_size),
            "gate_up": (tc.hidden_size, 2 * inter), "down": (inter, tc.hidden_size)}


def w8a8_prequant_case(xq, xs, w, ws, label: str) -> dict:
    """Kernel A's prequantized entry (a row-parallel product under TP: fp32
    partial sums) against the plain chain: bit-equal."""
    out = i8m.w8a8_matmul_prequantized(xq, xs, w, ws, torch.float32)
    ref = i8m.w8a8_matmul_prequantized_plain(xq, xs, w, ws, torch.float32)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    equal = torch.equal(out, ref)
    ms = cuda_ms(lambda: i8m.w8a8_matmul_prequantized(xq, xs, w, ws, torch.float32))
    plain_ms = cuda_ms(lambda: i8m.w8a8_matmul_prequantized_plain(xq, xs, w, ws, torch.float32), iters=10)
    lib_ms = cuda_ms(lambda: i8m.int8_matmul(xq, w.t()))
    (m, k), n = xq.shape, w.shape[0]
    b_ms, b_by = bound_ms(nbytes(xq, xs, w, ws, out), 2.0 * m * n * k, "int8")
    plan = i8m.w8a8_plan(m, n, k).describe()
    print(f"w8a8 prequantized [{label}]: xq{tuple(xq.shape)} w({n}, {k}) -> float32 max_abs_err={err:.3e} "
          f"bit_equal={equal} ms={ms:.4f} plain_ms={plain_ms:.4f} int_mm_ms={lib_ms:.4f} bound_ms={b_ms:.5f} "
          f"({b_by}) plan={json.dumps(plan)}", flush=True)
    if not equal:
        raise AssertionError(f"W8A8 prequantized kernel differs from the plain chain [{label}]")
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, plan=plan, prequantized=True)


def paged_tp_case(dev, g: int, label: str) -> dict:
    """#9 at the shipped scale (129 lanes, page 1,024) on ONE kv head with G
    query heads: a TP rank's pools (3B / 2: G 8; 7B / 4: G 7). The bound
    counts each distinct page's live cells once, at one kv head."""
    case = paged_cases.make_shipped(torch, np, dev, kind="int4")
    case["q"] = case["q"][:, :g].contiguous()
    for key in ("k", "v", "ks", "vs"):
        case[key] = case[key][:, :, :1].contiguous()
    q = case["q"]
    args = paged_cases.call_args(torch, case, dev)
    scale = q.shape[-1] ** -0.5
    o_ref, m_ref, l_ref = pa.paged_attention_int4_i8_plain(*args, scale)
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=True)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    stat_err = max((m - m_ref).abs().max().item(), ((l - l_ref).abs() / (1 + l_ref.abs())).max().item())
    plan, twice = paged_plan_and_twice("int4_i8", args)
    plain_ms = cuda_ms(lambda: pa.paged_attention_int4_i8_plain(*args, scale), iters=5)
    ms = cuda_ms(lambda: pa.paged_attention(*args, return_stats=True, int4_i8dot=True))
    page, live = case["page"], {}
    for lane, ell in enumerate(case["lengths"]):
        for pi in range(-(-int(ell) // page)):
            pid = int(case["table"][lane, pi])
            live[pid] = max(live.get(pid, 0), min(page, int(ell) - pi * page))
    d = q.shape[-1]
    cell_bytes = 2 * (d // 2 + 2)  # K and V nibbles and their bf16 scales, one kv head
    n_bytes = sum(live.values()) * cell_bytes + nbytes(q, o, m, l, args[3], args[4])
    cells = int(case["lengths"].sum())
    b_ms, b_by = bound_ms(n_bytes, 4.0 * cells * g * d, "int8")
    print(f"paged int4_i8 [{label}]: q{tuple(q.shape)} pool{tuple(case['k'].shape)} cells={cells} "
          f"max_abs_err={err:.3e} stat_err={stat_err:.3e} bit_identical_twice={twice} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}, distinct pages) plan={json.dumps(plan)}",
          flush=True)
    if not (err <= PAGED_OUT_ATOL["int4_i8"] and stat_err <= PAGED_STAT_ATOL and twice):
        raise AssertionError(f"paged kernel (int4_i8) disagrees with plain or with itself [{label}]")
    return dict(shape=label, max_abs_err=err, stat_err=stat_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, bit_identical_twice=twice, plan=plan)


def silu_split_case(gu, tp: int, label: str) -> dict:
    """#12's split mode on the ``tp`` column slices of one whole ``gu`` (M,
    2I), the TP group's ranks emulated in one process: pass 1 on each slice,
    the max of their amaxes, pass 2 on each slice. The slices' q side by side
    and their scales must equal the one-pass kernel on the whole row bit for
    bit, and each pass its plain version; the one-pass kernel at a slice's
    width (I / tp) must equal its plain version bit for bit too."""
    m, inter = gu.shape[0], gu.shape[1] // 2
    part = inter // tp
    pieces = [torch.cat([gu[:, r * part:(r + 1) * part], gu[:, inter + r * part:inter + (r + 1) * part]], dim=1)
              .contiguous() for r in range(tp)]
    amaxes = [sq.silu_row_amax(p) for p in pieces]
    amax = torch.stack(amaxes).amax(dim=0)
    outs = [sq.silu_quantize_with_amax(p, amax) for p in pieces]
    q_whole, s_whole = sq.fused_silu_quantize(gu)
    q_one, s_one = sq.fused_silu_quantize(pieces[0])
    torch.cuda.synchronize()
    q_split = torch.cat([o[0] for o in outs], dim=1)
    split_equal_whole = bool(torch.equal(q_split, q_whole) and all(torch.equal(o[1], s_whole) for o in outs))
    amax_equal_plain = all(torch.equal(a, sq.silu_row_amax_plain(p)) for a, p in zip(amaxes, pieces))
    q_ref, s_ref = sq.silu_quantize_with_amax_plain(pieces[0], amax)
    pass2_equal_plain = bool(torch.equal(outs[0][0], q_ref) and torch.equal(outs[0][1], s_ref))
    one_ref = sq.fused_silu_quantize_plain(pieces[0])
    one_pass_equal = bool(torch.equal(q_one, one_ref[0]) and torch.equal(s_one, one_ref[1]))
    err = float((outs[0][0].int() - q_ref.int()).abs().max())
    p0 = pieces[0]
    ms1 = cuda_ms(lambda: sq.silu_row_amax(p0))
    ms2 = cuda_ms(lambda: sq.silu_quantize_with_amax(p0, amax))
    one_ms = cuda_ms(lambda: sq.fused_silu_quantize(p0))
    plain_ms = cuda_ms(lambda: sq.silu_quantize_with_amax_plain(p0, sq.silu_row_amax_plain(p0)), iters=10)
    b1, b1_by = bound_ms(nbytes(p0, amax), 6.0 * m * part, "fp32")
    b2, b2_by = bound_ms(nbytes(p0, amax, q_ref, s_ref), 12.0 * m * part, "fp32")
    print(f"silu_quant split [{label}]: {tp} slices of gu{tuple(p0.shape)} (whole I {inter}) pass 1 ms={ms1:.4f} "
          f"(bound {b1:.5f}, {b1_by}) pass 2 ms={ms2:.4f} (bound {b2:.5f}, {b2_by}) one-pass kernel on a slice "
          f"ms={one_ms:.4f} plain split ms={plain_ms:.4f}; split equal to the one-pass kernel on the whole row "
          f"{split_equal_whole}, pass 1 equal to plain {amax_equal_plain}, pass 2 equal to plain "
          f"{pass2_equal_plain}, one pass on a slice equal to plain {one_pass_equal}", flush=True)
    if not (split_equal_whole and amax_equal_plain and pass2_equal_plain and one_pass_equal):
        raise AssertionError(f"silu_quant split mode disagrees [{label}]")
    return dict(shape=label, max_abs_err=err, ms=ms1 + ms2, pass1_ms=ms1, pass2_ms=ms2, one_pass_ms=one_ms,
                plain_ms=plain_ms, bound_ms=b1 + b2, bound_by=b2_by, library_ms=None,
                bit_equal_to_plain=pass2_equal_plain and amax_equal_plain, split_equal_whole=split_equal_whole,
                one_pass_bit_equal=one_pass_equal)


def quantize_split_case(x, tp: int, label: str) -> dict:
    """Kernel A's row quantize in its split mode on the ``tp`` column slices
    of one whole row-parallel input ``x`` (m, K), the TP group's ranks
    emulated in one process: pass 1 on each slice, the max of their amaxes,
    pass 2 on each slice. The slices' xq side by side and their scales must
    equal ``quantize_rows`` of the whole row (the arithmetic of the TPU
    kernel's body) bit for bit, and each pass its plain version. Returns the
    case and rank 0's (xq, xs) for the prequantized GEMM."""
    m, k = x.shape
    part = k // tp
    pieces = [x[:, r * part:(r + 1) * part].contiguous() for r in range(tp)]
    amaxes = [i8m.row_amax(p) for p in pieces]
    amax = torch.stack(amaxes).amax(dim=0)
    outs = [i8m.quantize_rows_with_amax(p, amax) for p in pieces]
    xq_whole, xs_whole = i8m.quantize_rows(x)
    torch.cuda.synchronize()
    xq_split = torch.cat([o[0] for o in outs], dim=1)
    split_equal_whole = bool(torch.equal(xq_split, xq_whole) and all(torch.equal(o[1], xs_whole) for o in outs))
    amax_equal_plain = all(torch.equal(a, i8m.row_amax_plain(p)) for a, p in zip(amaxes, pieces))
    q_ref, s_ref = i8m.quantize_rows_with_amax_plain(pieces[0], amax)
    pass2_equal_plain = bool(torch.equal(outs[0][0], q_ref) and torch.equal(outs[0][1], s_ref))
    err = float((xq_split.int() - xq_whole.int()).abs().max())
    p0 = pieces[0]
    ms1 = cuda_ms(lambda: i8m.row_amax(p0))
    ms2 = cuda_ms(lambda: i8m.quantize_rows_with_amax(p0, amax))
    plain_ms = cuda_ms(lambda: i8m.quantize_rows_with_amax_plain(p0, i8m.row_amax_plain(p0)), iters=10)
    b1, b1_by = bound_ms(nbytes(p0, amax), 2.0 * m * part, "fp32")
    b2, b2_by = bound_ms(nbytes(p0, amax, q_ref, s_ref), 4.0 * m * part, "fp32")
    print(f"row quantize split [{label}]: {tp} slices of x{tuple(p0.shape)} (whole K {k}) pass 1 ms={ms1:.4f} "
          f"(bound {b1:.5f}, {b1_by}) pass 2 ms={ms2:.4f} (bound {b2:.5f}, {b2_by}) plain split ms={plain_ms:.4f}; "
          f"split equal to quantize_rows of the whole row {split_equal_whole}, pass 1 equal to plain "
          f"{amax_equal_plain}, pass 2 equal to plain {pass2_equal_plain}", flush=True)
    if not (split_equal_whole and amax_equal_plain and pass2_equal_plain):
        raise AssertionError(f"row quantize split mode disagrees [{label}]")
    return dict(shape=label, max_abs_err=err, ms=ms1 + ms2, pass1_ms=ms1, pass2_ms=ms2, plain_ms=plain_ms,
                bound_ms=b1 + b2, bound_by=b2_by, library_ms=None,
                bit_equal_to_plain=pass2_equal_plain and amax_equal_plain,
                split_equal_whole=split_equal_whole), outs[0]


def tp_text_cfg(preset, tp: int):
    """``preset()`` with one TP rank's text heads: what the decode kernels
    see of a TP-local model (3B / 2 and 7B / 4: one kv head)."""
    cfg = preset()
    tc = cfg.text
    heads = tc.num_attention_heads // tp  # hidden_size follows, so head_dim (hidden / heads) stays
    return dataclasses.replace(cfg, text=dataclasses.replace(
        tc, num_attention_heads=heads, num_key_value_heads=tc.num_key_value_heads // tp,
        hidden_size=heads * tc.head_dim))


# the dense decode kernels at one kv head (a TP rank's cache): (kind, rows, width) -- #4 at path a's
# rows, #4' at the continuous engine's 72 lanes (64 slots, path f's) and path m3's 8, #5 at path f's
# rows, #6 at path m3's 8
TP_DECODE_CASES = (("bf16", 20, 640), ("int8", 72, 640), ("int8", 8, 640), ("int4", 128, 768),
                   ("int4_i8", 8, 768))


def tp_decode_cases(dev) -> dict:
    """#4, #4', #5 and #6 on one kv head with G = 8 (3B / 2) and G = 7 (7B /
    4), each against its plain version; the plan (``decode_plan``) printed:
    with one kv head a call has a half or a quarter of the (row, kv head)
    pairs, which the cluster split spreads over the idle SMs."""
    out = {kind: [] for kind, _, _ in TP_DECODE_CASES}
    for size, (preset, tp) in TP_SHAPES.items():
        cfg = tp_text_cfg(preset, tp)
        g = cfg.text.num_attention_heads
        for kind, rows, width in TP_DECODE_CASES:
            label = f"tp_{size}_one_kv_head_g{g}_{rows}_rows_width_{width}"
            if kind == "bf16":
                out[kind] += check_decode(dev, cfg, rows, width, 512, label=label)
            else:
                out[kind] += check_decode_quant(dev, cfg, kind, rows, width, 512, label=label)
        torch.cuda.empty_cache()
    return out


TP_INT4_MS = (8, 136)  # path m3's dense rows; the continuous engine's 136 lanes at 128 slots


def tp_int4_cases(dev) -> dict:
    """The int4 MLP kernels at a TP rank's shapes (3B / 2: local I 5,504;
    7B / 4: 4,736), group 128: #13 against its plain version at the local
    N; #14's split entry on each rank's columns of one whole row (the ranks
    emulated in one process: kernel A's row-amax pass on each, the max of
    the amaxes, then #14 quantizing with it against the rank's down shard,
    zero-padded to 5,632 / 4,864 rows) against its plain version, and the
    ranks' fp32 partials summed against the one-pass #14 on the whole row."""
    out = {"gateup": [], "down_split": []}
    sms = pa.device_sms(dev.index)
    gen = torch.Generator(device=dev).manual_seed(37)
    for size, (preset, tp) in TP_SHAPES.items():
        tc = preset().text
        e, inter = tc.hidden_size, tc.intermediate_size
        part = inter // tp
        gu_w = torch.randn((2 * part, e), device=dev, generator=gen) * 0.02
        gu4 = i4.Int4Weight.from_weight(gu_w, 128, whole_i=inter)
        gu8 = quantize_weight(gu_w, 1)["qvalue"]  # the W8A8 shard: the yardstick
        del gu_w
        dn_w = torch.randn((e, inter), device=dev, generator=gen) * 0.02
        whole4 = i4.Int4Weight.from_weight(dn_w, 128)
        shards = [i4.Int4Weight.from_weight(dn_w[:, r * part:(r + 1) * part], 128, whole_i=inter)
                  for r in range(tp)]
        dn8 = quantize_weight(dn_w[:, :part], 1, None)["qvalue"]  # rank 0's W8A8 shard: the yardstick
        del dn_w
        for m in TP_INT4_MS:
            rng = np.random.default_rng(40 + m)
            x = randn_bf16(rng, dev, m, e)
            label = f"tp_{size}_local_i_{part}"
            xq = quantize_activation(x)[0]

            def gateup_lib():
                acc = int8_matmul(xq, gu8.t())
                return F.silu(acc[:, :part].float()) * acc[:, part:].float()

            _, gu_case = _int4_case(
                f"gate_up_{label}", m, lambda: i4._gateup(x, gu4),
                lambda: i4.w4_gateup_silu_plain(x, gu4.q4, gu4.gscale), gateup_lib,
                lambda o: nbytes(x, gu4.q4, gu4.gscale, o), 2.0 * m * e * 2 * part,
                i4.w4_plan(m, e, part, True, sms))
            print(f"int4 gate_up+silu [{label}_m{m}]: E={e} local I={part} (whole {inter}) group 128 "
                  f"max_abs_err={gu_case['max_abs_err']:.3e} (of max |out|: {gu_case['rel_err']:.2e}, tol "
                  f"{INT4_REL_TOL}) bit_identical_twice={gu_case['bit_identical_twice']} ms={gu_case['ms']:.4f} "
                  f"device_us={gu_case['device_us']:.2f} plain_ms={gu_case['plain_ms']:.4f} int_mm_int8_shard_ms="
                  f"{gu_case['library_ms']:.4f} bound_ms={gu_case['bound_ms']:.5f} ({gu_case['bound_by']}) "
                  f"plan={json.dumps(gu_case['plan'])}",
                  flush=True)
            if not (gu_case["rel_err"] <= INT4_REL_TOL and gu_case["bit_identical_twice"]):
                raise AssertionError(f"int4 gate_up kernel disagrees at a TP-local shape [{label}_m{m}]")
            out["gateup"].append(gu_case)
            h = randn_bf16(rng, dev, m, inter)
            pieces = [h[:, r * part:(r + 1) * part].contiguous() for r in range(tp)]
            amax = torch.stack([i8m.row_amax(p) for p in pieces]).amax(dim=0)
            partials = [i4.w4_matmul_split(p, w, amax) for p, w in zip(pieces, shards)]
            plains = [i4.w4_matmul_split_plain(p, amax, w.q4, w.gscale) for p, w in zip(pieces, shards)]
            again = i4.w4_matmul_split(pieces[0], shards[0], amax)
            one_pass = i4._down(h, whole4, torch.float32)  # the kernel, whatever the rule says of m
            torch.cuda.synchronize()
            summed = torch.stack(partials).sum(dim=0)
            err = max((a - b).abs().max().item() for a, b in zip(partials, plains))
            rel = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(partials, plains))
            sum_rel = (summed - one_pass).abs().max().item() / one_pass.abs().max().item()
            twice = bool(torch.equal(partials[0], again))
            p0, w0 = pieces[0], shards[0]
            ms = cuda_ms(lambda: i4.w4_matmul_split(p0, w0, amax))
            dev_us = device_us(lambda: i4.w4_matmul_split(p0, w0, amax))
            plain_ms = cuda_ms(lambda: i4.w4_matmul_split_plain(p0, amax, w0.q4, w0.gscale), iters=5, warmup=1)
            xq0 = quantize_activation(p0)[0]
            lib_ms = cuda_ms(lambda: int8_matmul(xq0, dn8.t()))
            kp = 2 * w0.q4.shape[1]
            # the rank's k = I / tp columns only: the zero group that pads the copy to kp is a packing
            # choice, no work of the function (k / 2 bytes of q4 and k / group scale rows a column)
            k = w0.k
            need = nbytes(p0, amax, partials[0]) + e * k // 2 + (k // w0.group) * e * w0.gscale.element_size()
            b_ms, b_by = bound_ms(need, 2.0 * m * k * e, "int8")
            plan = i4.w4_plan(m, kp, e, False, sms).describe()
            case = dict(shape=f"down_split_{label}_padded_{kp}_m{m}", max_abs_err=err, rel_err=rel,
                        summed_rel_err=sum_rel, bit_identical_twice=twice, ms=ms, device_us=dev_us,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, plan=plan)
            print(f"int4 down split [{label}_m{m}]: {tp} ranks' columns of h({m}, {inter}), each {part} "
                  f"padded to {kp}, -> fp32 partials (m, {e}): max_abs_err={err:.3e} against the plain split "
                  f"(of max |out|: {rel:.2e}, tol {INT4_F32_REL_TOL}); the partials summed against the one-pass "
                  f"kernel on the whole row {sum_rel:.2e} of max |out| (tol {INT4_REL_TOL}); "
                  f"bit_identical_twice={twice} ms={ms:.4f} device_us={dev_us:.2f} (row amax + #14) "
                  f"plain_ms={plain_ms:.4f} int_mm_int8_shard_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
                  f"plan={json.dumps(plan)}", flush=True)
            if not (rel <= INT4_F32_REL_TOL and sum_rel <= INT4_REL_TOL and twice):
                raise AssertionError(f"int4 down split entry disagrees [{label}_m{m}]")
            out["down_split"].append(case)
        del gu4, gu8, whole4, shards, dn8
        torch.cuda.empty_cache()
    return out


def tp_kernel_cases(dev) -> dict:
    """Every kernel a TP rank runs, at the shapes a rank of a TP group gives
    it (3B at tp 2, 7B at tp 4): #1-#3 on text rows of one kv head and the
    vision forms at 16 / tp heads, #9 at one kv head, kernel A at the eight
    local linears (o and down also as the row-parallel products run: the
    row quantize's split mode, then the prequantized entry), #12's split
    mode at the local I; the dense decode kernels #4, #4', #5, #6 at one
    kv head; #13 at the local I and #14's split entry on its padded shard."""
    out = {"flash": [], "prep": [], "dq": [], "dkv": [], "w8a8": [], "paged": [], "silu": [], "quant_split": []}
    cfg3 = qwen25_vl_3b()
    synth = synthetic_training_cases(cfg3)  # (name, heads, segment ids, causal): text, vision full, windows
    cases = []
    for size, (preset, tp) in TP_SHAPES.items():
        cfg = preset()
        tc, vc = cfg.text, cfg.vision
        heads = [(tc.num_attention_heads // tp, tc.num_key_value_heads // tp, tc.head_dim)] + \
            [(vc.num_heads // tp, vc.num_heads // tp, vc.head_dim)] * 2
        cases += [(f"tp_{size}_{name.split('_', 1)[1]}", h, seg, causal)
                  for (name, _, seg, causal), h in zip(synth, heads)]
    f, p, q, k = check_flash_training(dev, cases)
    out["flash"], out["prep"], out["dq"], out["dkv"] = f, p, q, k
    gen = torch.Generator(device=dev).manual_seed(19)
    for size, (preset, tp) in TP_SHAPES.items():
        for name, (kk, n) in tp_linears(preset(), tp).items():
            w = torch.randint(-127, 128, (n, kk), generator=gen, device=dev, dtype=torch.int8)
            ws = torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-4
            for m in TP_MS:
                x = torch.randn((m, kk), generator=gen, device=dev).to(torch.bfloat16)
                out["w8a8"].append(w8a8_case(x, w, ws, torch.bfloat16, f"tp_{size}_{name}_m{m}"))
                if name in ("o", "down"):  # x is rank 0's K columns of a whole row
                    whole = torch.cat([x] + [torch.randn((m, kk), generator=gen, device=dev).to(torch.bfloat16)
                                             for _ in range(tp - 1)], dim=1)
                    case, (xq, xs) = quantize_split_case(whole, tp, f"tp_{size}_{name}_m{m}")
                    out["quant_split"].append(case)
                    out["w8a8"].append(w8a8_prequant_case(xq, xs, w, ws, f"tp_{size}_{name}_prequantized_m{m}"))
            del w, ws
        torch.cuda.empty_cache()
    out["decode"] = tp_decode_cases(dev)
    out["int4"] = tp_int4_cases(dev)
    out["paged"] = [paged_tp_case(dev, 8, "tp_3b_129_lanes_page_1024_one_kv_head_g8"),
                    paged_tp_case(dev, 7, "tp_7b_129_lanes_page_1024_one_kv_head_g7")]
    rng = np.random.default_rng(23)
    for size, (preset, tp) in TP_SHAPES.items():
        inter = preset().text.intermediate_size
        out["silu"].append(silu_split_case(randn_bf16(rng, dev, 4096, 2 * inter), tp,
                                           f"tp_{size}_rows_4096_local_i_{inter // tp}"))
    torch.cuda.empty_cache()
    return out


def path_m1_rank(rank: int, store: str, out: str) -> int:
    """(m1) in a process of its own (``path_m_rank``): rank ``rank`` of a TP group of two on
    ``cuda:0`` over gloo. The 4-layer 3B model (the whole vision tower) on one
    8,192-token packed row with one 256-token image: packed log-probs of the
    unsharded model and of this rank's TP shard of it, first in fp32 through
    the plain attention (the decomposition itself), then in bf16 through the
    kernels (launches counted, plain versions forbidden)."""
    import torch.distributed as dist

    from spatialthinker_torch.models.qwen2_5_vl import init_params
    from spatialthinker_torch.models.qwen2_5_vl import text as text_mod, vision as vision_mod
    from spatialthinker_torch.parallel import tensor as tensor_mod
    from spatialthinker_torch.parallel.tensor import TPSpec, shard_for_rank
    from spatialthinker_torch.trainer.train_step import compute_packed_log_probs

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    tp = TPSpec(dist.group.WORLD)
    partials = {"fp32": 0, "other": 0}  # the dtypes of the row-parallel partials the TP forward sums

    def recording(reduce):
        def call(x, group, out_dtype=None):
            if out_dtype is not None:  # a row-parallel product (the vocab lookup passes none)
                partials["fp32" if x.dtype == torch.float32 else "other"] += 1
            return reduce(x, group, out_dtype)
        return call
    cfg = qwen25_vl_3b()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=SP_MODEL_LAYERS))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(23), device=dev, dtype=torch.bfloat16)
    batch, vision = _sp_model_batch(cfg, dev, seed=29)
    mask = batch.loss_mask.bool()
    logp = {}
    with torch.no_grad():
        with plain_attention():
            fp32 = copy.deepcopy(model).float()
            logp["whole_fp32"] = fp32(compute_packed_log_probs, batch, vision)[0]
            fp32 = gt.tp_local(fp32, tp)
            logp["tp_fp32"] = fp32(compute_packed_log_probs, batch, vision)[0]
            del fp32
            torch.cuda.empty_cache()
        with forbid_plain_versions():
            logp["whole_bf16"] = model(compute_packed_log_probs, batch, vision)[0]
            local_model = gt.tp_local(model, tp)
            # the planted faults' weights: rank 0's query / key / value heads of text layer 0
            # and rank 0's vocab rows, which rank 1 takes in the controls below
            whole = model.state_dict()
            faults = {"heads": shard_for_rank({k: v for k, v in whole.items()
                                               if k.startswith("text.layers.0.self_attn.qkv_proj.")}, 2, 0),
                      "vocab": shard_for_rank({k: v for k, v in whole.items()
                                               if k in ("text.embed_tokens.weight", "text.lm_head.weight")}, 2, 0)}
            del model, whole
            torch.cuda.empty_cache()
            dist.barrier()
            reset_counts()
            saved_reduce = text_mod.reduce_from_tp, vision_mod.reduce_from_tp
            text_mod.reduce_from_tp, vision_mod.reduce_from_tp = (recording(f) for f in saved_reduce)
            t0 = time.perf_counter()
            try:
                logp["tp_bf16"] = local_model(compute_packed_log_probs, batch, vision)[0]
                torch.cuda.synchronize()
            finally:
                text_mod.reduce_from_tp, vision_mod.reduce_from_tp = saved_reduce
            tp_s = time.perf_counter() - t0
            launches = read_counts()
            # negative controls of the bf16 limit (launches not counted): (1) every partial
            # rounded to bf16 before the group's sum; (2) rank 1 holding rank 0's heads of
            # text layer 0; (3) rank 1 holding rank 0's vocab rows
            saved_sum = tensor_mod._sum_fp32
            tensor_mod._sum_fp32 = lambda x, group, out_dtype=None: saved_sum(x.to(torch.bfloat16), group, out_dtype)
            try:
                logp["fault_bf16_partials"] = local_model(compute_packed_log_probs, batch, vision)[0]
            finally:
                tensor_mod._sum_fp32 = saved_sum
            params = dict(local_model.named_parameters())
            for name, planted in faults.items():
                kept = {k: params[k].detach().clone() for k in planted}
                if rank == 1:
                    for k, v in planted.items():
                        params[k].data.copy_(v)
                logp[f"fault_{name}"] = local_model(compute_packed_log_probs, batch, vision)[0]
                for k, v in kept.items():
                    params[k].data.copy_(v)
            torch.cuda.synchronize()

    def diff(a, b):
        return float((logp[a] - logp[b])[mask].abs().max())

    res = dict(rank=rank, fp32_diff=diff("tp_fp32", "whole_fp32"), bf16_diff=diff("tp_bf16", "whole_bf16"),
               tp_bf16_drift=diff("tp_bf16", "whole_fp32"), whole_bf16_drift=diff("whole_bf16", "whole_fp32"),
               finite=bool(torch.isfinite(logp["tp_bf16"]).all()), mean_logp=float(logp["tp_bf16"][mask].mean()),
               seconds=tp_s, launches=launches, partials=partials, process_s=time.perf_counter() - PROCESS_T0,
               shard_gb=sum(p.numel() * p.element_size() for p in local_model.parameters()) / 1e9)
    res["ratio"] = res["tp_bf16_drift"] / res["whole_bf16_drift"]
    res["fault_ratios"] = {k[len("fault_"):]: diff(k, "whole_fp32") / res["whole_bf16_drift"]
                           for k in logp if k.startswith("fault_")}
    res["ok"] = (res["fp32_diff"] <= TP_FP32_LOGP_ATOL and res["ratio"] <= TP_BF16_DRIFT_RATIO
                 and partials["fp32"] > 0 and partials["other"] == 0
                 and all(res["fault_ratios"][k] > TP_BF16_DRIFT_RATIO for k in TP_FAULTS_SEEN))
    Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def path_m2_rank(rank: int, store: str, work_dir: str, out: str) -> int:
    """(m2) after (m1) in the same process: rank ``rank`` of two on ``cuda:0`` over gloo,
    the trainer at ``model_size=2`` without sp and ``tensor_parallel_size=2``
    on path (e)'s dotlist, at ``TP_M2_LAYERS`` text layers and
    ``TRAIN_VISION_DEPTH`` vision blocks (``cut_depth``), full widths: ONE
    step of ``fit()`` (the paged rollout
    at W8A8 + int4 pools + int4_i8dot on one engine a TP group, old and ref
    log-probs, the packed update)."""
    import hashlib

    import torch.distributed as dist

    from spatialthinker_torch.models.qwen2_5_vl import init_params

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()  # (m1) ran in this process before
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    config = trainer_config(work_dir, extra=[
        "worker.actor.sharding.fsdp_size=1", "worker.actor.sharding.model_size=2",
        "worker.rollout.tensor_parallel_size=2", "trainer.n_chips=2", "trainer.max_steps=1",
        "trainer.val_before_train=false", f"worker.rollout.kv_pages_override={TP_M2_PAGES}",
        # few samples: every forward's activations cross host memory through gloo (at 6 text
        # layers and the whole vision tower 128 samples took 505 s, 16 took 74.6 s on an H100,
        # NVIDIA H100 80GB HBM3, 700.00 W)
        f"data.rollout_batch_size={TP_M2_PROMPTS}", f"worker.rollout.n={TP_M2_N}",
        f"trainer.experiment_name=path_m2_rank{rank}"])
    cfg = cut_depth(qwen25_vl_3b(), TP_M2_LAYERS)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(config.trainer.seed), device=dev,
                        dtype=torch.bfloat16)
    tok = load_tokenizer(config.worker.actor.model.tokenizer_path, model.cfg)
    train_ds = RLHFDataset.from_rows(scene_rows(config.data.rollout_batch_size, seed=21), tok, config.data,
                                     model.cfg)
    t0 = time.perf_counter()
    print(f"m2 rank {rank}: model and rows ready", flush=True)
    trainer = build_trainer(config, tok, model, train_ds)
    print(f"m2 rank {rank}: trainer built in {time.perf_counter() - t0:.2f} s", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 1e9
    tokens = []
    generate = trainer.generate_sequences

    def recording(batch, sampling, generator=None):
        rolled = generate(batch, sampling, generator)
        tokens.append(hashlib.sha256(np.ascontiguousarray(rolled.tensors["responses"]).tobytes()).hexdigest())
        return rolled

    trainer.generate_sequences = recording
    silu_rows = []  # the rows of each call of #12's split mode (the prefill's m)
    split = sq.fused_silu_quantize_split

    def silu_split(gu, combine):
        silu_rows.append(int(gu.shape[0]))
        return split(gu, combine)

    sq.fused_silu_quantize_split = silu_split
    p_sums = checksums(p for p in trainer.model.parameters())
    ref_sums = checksums(p for p in trainer.ref_model.parameters())
    dist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    with forbid_plain_versions():
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    print(f"m2 rank {rank}: fit {fit_s:.2f} s", flush=True)
    launches = read_counts()
    log = Path(work_dir) / f"{config.trainer.experiment_name}_metrics.jsonl"
    rec = ({r["step"]: r for r in map(json.loads, log.read_text().splitlines())}.get(1, {})
           if log.exists() else {})
    if rank != 0:  # rank 0 logs; every rank computed the same record
        rec = {}
    moved = sum(a != b for a, b in zip(p_sums, checksums(p for p in trainer.model.parameters())))
    trainer.generate_sequences, sq.fused_silu_quantize_split = generate, split
    m3 = path_m3_cases(trainer, train_ds)
    Path(out).write_text(json.dumps({
        "m3": m3,
        "rank": rank, "record": {k: v for k, v in rec.items() if k != "time"}, "fit_s": fit_s, "build_s": build_s,
        "moved": moved, "ref_untouched": checksums(p for p in trainer.ref_model.parameters()) == ref_sums,
        "tokens": tokens, "launches": launches, "resident_gb": resident_gb,
        "silu_split_rows": sorted(set(silu_rows)),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "rollout_copy_gb": trainer.rollout_copy_bytes / 1e9, "pool_pages": trainer._paged_pool_cache,
        "tp": [trainer.tp.rank, trainer.tp.size], "backend": dist.get_backend(), "world": dist.get_world_size(),
        "policy_shard_gb": sum(p.numel() * p.element_size() for p in trainer.model.parameters()) / 1e9}))
    dist.destroy_process_group()
    return 0


def path_m3_cases(trainer, train_ds) -> dict:
    """(m3), on (m2)'s trainer after its step: ``generate_sequences`` on
    ``TP_M3_PROMPTS`` prompts x n ``TP_M3_N`` with each of ``TP_M3_CASES``'s
    knobs (one engine a TP group: the dense engine with the w4a8 copy, int4
    KV and int8 dots; the continuous engine over an int8 cache), then the
    trainer's own log-probs of the tokens (``knob_rollout``, plain versions
    forbidden): tokens, launches, seconds, probs_diff."""
    import hashlib

    batch = next(iter(DataLoader(train_ds, TP_M3_PROMPTS, shuffle=False)))
    trainer.sampling = trainer.sampling.override(n=TP_M3_N)
    out = {}
    for label, knobs, _, limit in TP_M3_CASES:
        with kept_continuous_result() as kept:
            rolled, counts, gen_s, diff = knob_rollout(trainer, batch, knobs)
        resp = np.ascontiguousarray(rolled.tensors["responses"])
        out[label] = dict(tokens=hashlib.sha256(resp.tobytes()).hexdigest(), rows=int(resp.shape[0]),
                          launches=counts, seconds=gen_s, probs_diff=diff, limit=limit,
                          finite=bool(np.isfinite(rolled.tensors["rollout_log_probs"]).all()),
                          refills=kept["result"].stats["refills"] if "result" in kept else None)
        del rolled
    out["w4_mlp"] = m3_w4_mlp_check(trainer)
    return out


@torch.no_grad()
def m3_w4_mlp_check(trainer) -> dict:
    """(m3)'s w4a8 MLP on the card: ``TP_M3_MLP_ROWS`` rows (the same on
    both ranks) through layer 0's MLP of this rank's w4a8 rollout copy as
    the model runs it (``w4_swiglu`` under TP: #13 on the shard, each row's
    amax maxed over the group, #14's split entry; the fp32 partials summed
    over the group) against the one-pass #14 of the unsharded copy (the
    same weights gathered) on the ranks' h gathered whole: equal but for
    the order of the fp32 group sums. The same with every rank quantizing
    with its own amax (the group's max planted as the identity on both
    ranks) must land outside the limit. Also #13's h against the unsharded
    gate_up copy's slice."""
    from spatialthinker_torch.ops.ulysses import all_gather_seq
    from spatialthinker_torch.parallel.sharding import tp_rollout_copy
    from spatialthinker_torch.parallel.tensor import all_reduce_sum, gather_leaf

    tp, tc = trainer.tp, trainer.model_cfg.text
    copy = tp_rollout_copy(trainer.model, trainer.rollout_tp)
    src = copy.text.layers[0].mlp
    gu_whole, dn_whole = tq.w4_decode_copies(
        gather_leaf("text.layers.0.mlp.gate_up_proj.weight", src.gate_up_proj.weight, tp),
        gather_leaf("text.layers.0.mlp.down_proj.weight", src.down_proj.weight, tp), tc)
    mlp = tq.quantize_model(copy, mode="w4a8").text.layers[0].mlp
    x = randn_bf16(np.random.default_rng(43), src.down_proj.weight.device, TP_M3_MLP_ROWS, tc.hidden_size)

    def summed():
        return all_reduce_sum(i4.w4_swiglu(x, mlp.gate_up_w4, mlp.down_w4, torch.float32, tp=tp), tp)

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()

    reset_counts()
    sound = summed()
    launches = read_counts()
    h = i4._gateup(x, mlp.gate_up_w4)
    part = h.shape[1]
    gate_rel = rel(h, i4._gateup(x, gu_whole)[:, tp.rank * part:(tp.rank + 1) * part])
    want = i4._down(all_gather_seq(h, tp.group, dim=1), dn_whole, torch.float32)
    real = i4.all_reduce_max
    i4.all_reduce_max = lambda a, group: a
    try:
        planted = summed()
    finally:
        i4.all_reduce_max = real
    return dict(rows=TP_M3_MLP_ROWS, local_i=part, padded_k=2 * mlp.down_w4.q4.shape[1], gate_rel=gate_rel,
                sound_rel=rel(sound, want), planted_rel=rel(planted, want),
                split_launches=launches["int4_down_split"], one_pass_launches=launches["int4_down"])


def path_m_rank(rank: int, work: Path) -> int:
    """(m1), then (m2) with (m3) on its trainer, in one process a rank (one
    start-up for both)."""
    path_m1_rank(rank, str(work / "m1_store"), str(work / f"m1_{rank}.json"))
    gc.collect()
    torch.cuda.empty_cache()
    return path_m2_rank(rank, str(work / "m2_store"), str(work), str(work / f"m2_{rank}.json"))


def path_m(card: str, work_dir: str) -> dict:
    """Path m: (m1) the TP model at tp = 2 against the unsharded model and
    (m2) the trainer at ``model_size=2`` / ``tensor_parallel_size=2``, one
    after the other in two processes on ``cuda:0`` over gloo (NCCL refuses
    two ranks on one device), the kernels already built by this process."""
    t_start = time.perf_counter()
    work = Path(work_dir)
    _run_ranks([["--path-m", r, work] for r in range(2)], PATH_M_TIMEOUT_S)
    m1 = [json.loads((work / f"m1_{r}.json").read_text()) for r in range(2)]
    for r in m1:
        print(f"path m1 rank {r['rank']} (gloo, tp 2 on one card): 3B width, {SP_MODEL_LAYERS} text layers + the "
              f"whole vision tower, one {sum(SP_ROW)}-token packed row with one image: tp 2 vs the unsharded "
              f"model's log-probs, fp32 (plain attention) max abs {r['fp32_diff']:.3e} (limit {TP_FP32_LOGP_ATOL}), "
              f"bf16 (kernels) max abs {r['bf16_diff']:.3e}; from the fp32 model: tp bf16 {r['tp_bf16_drift']:.3e}, "
              f"unsharded bf16 {r['whole_bf16_drift']:.3e} (ratio {r['ratio']:.4f}, limit {TP_BF16_DRIFT_RATIO}; "
              f"planted faults' ratios {json.dumps(r['fault_ratios'])}, those of {list(TP_FAULTS_SEEN)} must exceed "
              f"it); row-parallel partials summed {r['partials']}; mean "
              f"{r['mean_logp']:.3f}, the tp bf16 forward {r['seconds']:.3f} s, shard {r['shard_gb']:.3f} GB "
              f"[{card}]; launches {dict((k, v) for k, v in r['launches'].items() if v)}", flush=True)
    m2 = [json.loads((work / f"m2_{r}.json").read_text()) for r in range(2)]
    rec = m2[0]["record"]
    timing = {k.split("/", 1)[1]: v for k, v in rec.items() if k.startswith("timing_s/")}
    for r in m2:
        print(f"path m2 rank {r['rank']} (tp rank {r['tp'][0]} of {r['tp'][1]}, {r['world']} ranks over {r['backend']} on one card; two "
              f"processes share the card, the collectives cross host memory): fit {r['fit_s']:.2f} s, trainer "
              f"built in {r['build_s']:.2f} s ({TP_M2_PROMPTS} prompts x n {TP_M2_N}, {TP_M2_LAYERS} text layers, "
              f"{TRAIN_VISION_DEPTH} vision blocks: a correctness check, not a timing), #12's split mode at m "
              f"{r['silu_split_rows']}, policy shard {r['policy_shard_gb']:.3f} GB, rollout copy "
              f"{r['rollout_copy_gb']:.3f} GB, resident {r['resident_gb']:.2f} GB, peak {r['peak_gb']:.2f} GB, "
              f"pool {r['pool_pages']} pages [{card}]; launches {r['launches']}", flush=True)
    print(f"path m2 step: " + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(timing.items()))
          + f"; throughput {rec.get('perf/throughput', float('nan')):.1f} tok/s, probs_diff_mean "
          f"{rec.get('rollout/probs_diff_mean', float('nan')):.4f}, actor/grad_norm "
          f"{rec.get('actor/grad_norm', float('nan')):.3e}, kv peak_pages {rec.get('rollout/kv_peak_pages', -1):.0f} "
          f"[{card}]", flush=True)
    for label, _, kernels, limit in TP_M3_CASES:
        for r in m2:
            c = r["m3"][label]
            print(f"path m3 {label} rank {r['rank']} (tp rank {r['tp'][0]} of {r['tp'][1]}, one engine a TP group; "
                  f"{TP_M3_PROMPTS} prompts x n {TP_M3_N} = {c['rows']} rows, (m2)'s trainer): {c['seconds']:.2f} s, "
                  f"probs_diff_mean {c['probs_diff']:.4f} (limit {limit}), tokens {c['tokens'][:16]} [{card}]; "
                  f"launches {dict((k, v) for k, v in c['launches'].items() if v)}", flush=True)
    for r in m2:
        c = r["m3"]["w4_mlp"]
        print(f"path m3 w4a8 MLP rank {r['rank']}: layer 0 at {c['rows']} rows, local I {c['local_i']} padded to "
              f"{c['padded_k']}: the TP MLP's summed fp32 partials against the unsharded copy's one-pass #14 "
              f"{c['sound_rel']:.2e} of max |out| (limit {INT4_F32_REL_TOL}); each rank quantizing with its own "
              f"amax {c['planted_rel']:.2e} (must exceed it); #13's h against the unsharded copy's slice "
              f"{c['gate_rel']:.2e} (limit {INT4_REL_TOL}); split launches {c['split_launches']}, one-pass "
              f"{c['one_pass_launches']}; continuous refills {r['m3']['continuous_int8']['refills']} [{card}]",
              flush=True)
    mlp_m3 = [r["m3"]["w4_mlp"] for r in m2]
    m3 = {label: [r["m3"][label] for r in m2] for label, _, _, _ in TP_M3_CASES}
    checks = {
        "m3: the TP w4a8 MLP equals the unsharded copy's on both ranks": all(
            c["sound_rel"] <= INT4_F32_REL_TOL and c["gate_rel"] <= INT4_REL_TOL and c["split_launches"] > 0
            and c["one_pass_launches"] == 0 for c in mlp_m3),
        "m3: a rank quantizing with its own amax caught": all(c["planted_rel"] > INT4_F32_REL_TOL for c in mlp_m3),
        "m3: the continuous engine refilled lanes mid-decode on both ranks": all(
            c["refills"] >= 2 for c in m3["continuous_int8"]),
        "m3: both ranks sampled the same tokens": all(c[0]["tokens"] == c[1]["tokens"] for c in m3.values()),
        "m3: rollout/probs_diff_mean within the limits": all(
            c["finite"] and c["probs_diff"] <= c["limit"] for cs in m3.values() for c in cs),
        "m3: #13, #14's split entry and #6 (dense w4a8), #4' (continuous int8) on both ranks": all(
            c["launches"][k] > 0 for label, _, kernels, _ in TP_M3_CASES for c in m3[label] for k in kernels),
        "m3: the one-pass #14 not (TP splits I), no torch._int_mm": all(
            c["launches"]["int4_down"] == 0 and c["launches"]["int_mm"] == 0 for cs in m3.values() for c in cs),
        "m1: tp 2 log-probs within the limits on both ranks": all(r["ok"] and r["finite"] for r in m1),
        "m1: the planted faults beyond the bf16 limit": all(
            r["fault_ratios"][k] > TP_BF16_DRIFT_RATIO for r in m1 for k in TP_FAULTS_SEEN),
        "m1: every row-parallel partial summed in fp32": all(
            r["partials"]["fp32"] > 0 and r["partials"]["other"] == 0 for r in m1),
        "m1: the flash forward launched on both ranks": all(r["launches"]["flash_fwd"] > 0 for r in m1),
        "m2: one step record with finite metrics": bool(rec) and all(
            np.isfinite(v) for v in rec.values() if isinstance(v, (int, float))),
        "m2: rollout/probs_diff_mean within the limit": rec.get("rollout/probs_diff_mean", np.inf) <= PROBS_DIFF_LIMIT,
        "m2: parameters moved on both ranks": all(r["moved"] > 0 for r in m2),
        "m2: reference copies untouched": all(r["ref_untouched"] for r in m2),
        "m2: both ranks sampled the same tokens": bool(m2[0]["tokens"]) and m2[0]["tokens"] == m2[1]["tokens"],
        "m2: every TP kernel launched on both ranks": all(r["launches"][k] > 0 for r in m2 for k in TP_KERNELS),
        "m2: the one-pass silu junction not (TP splits I)": all(r["launches"]["silu_quant"] == 0 for r in m2),
        "m2: #12's split mode above the junction's threshold": all(
            max(r["silu_split_rows"], default=0) > tq.FUSED_SILU_MIN_M for r in m2),
        "m2: no dense decode kernel, no torch._int_mm": all(
            r["launches"]["decode_attention"] == 0 and r["launches"]["int_mm"] == 0 for r in m2),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path m checks failed: {failed}")
    seconds = time.perf_counter() - t_start
    print(f"path m: {seconds:.1f} s (m1 {m1[0]['process_s']:.1f} s of rank 0's process)", flush=True)
    return {"m1": m1, "m2": m2, "seconds": seconds}



RANK_ENTRIES = {"--path-l1": lambda a: path_l1_rank(a[0], a[1]),
                "--path-l2": lambda a: path_l2_rank(int(a[0]), a[1], a[2]),
                "--nccl-probe": lambda a: nccl_probe_rank(int(a[0]), a[1], a[2]),
                "--path-m": lambda a: path_m_rank(int(a[0]), Path(a[1]))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] and sys.argv[1] in RANK_ENTRIES:  # a process of path l or m
        import faulthandler

        # a rank that hangs in a collective shows where before it is stopped
        faulthandler.dump_traceback_later(PATH_M_TIMEOUT_S - 60, exit=False)
        return RANK_ENTRIES[sys.argv[1]](sys.argv[2:])
    only_l = sys.argv[1:] == ["--only-path-l"]  # the build and path l alone
    only_m = sys.argv[1:] == ["--only-path-m"]  # the build, the TP-local kernel cases and path m alone
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch._int_mm = counted_int_mm
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(card, flush=True)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    csrc.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({csrc.library_path().name})", flush=True)

    cfg = qwen25_vl_3b()
    if only_m:
        tp_cases = tp_kernel_cases(dev)
        with tempfile.TemporaryDirectory() as work_dir:
            m_res = path_m(card, work_dir)
        print(json.dumps({"tp_kernel_cases": tp_cases, "path_m": m_res,
                          "seconds": time.perf_counter() - t_start}), flush=True)
        print(card, flush=True)
        return 0
    if only_l:
        with tempfile.TemporaryDirectory() as work_dir:
            l_res = path_l(card, work_dir)
        print(json.dumps({"path_l": l_res, "seconds": time.perf_counter() - t_start}), flush=True)
        print(card, flush=True)
        return 0

    phases, lap_t = {}, [t_start]  # seconds of each phase below, for the time budget

    def lap(name: str) -> None:
        now = time.perf_counter()
        phases[name], lap_t[0] = now - lap_t[0], now
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)

    lap("build")
    # ---- the decode kernels the rollout knobs reach, against their plain versions ----
    quant_rows = 16 * 8  # path f: 16 prompts x n 8 through the dense engine
    int8_cases = check_decode_quant(dev, cfg, "int8", quant_rows, 640, 512)
    int4_dense_cases = check_decode_quant(dev, cfg, "int4", quant_rows, 768, 512)
    int4_i8_dense_cases = check_decode_quant(dev, cfg, "int4_i8", quant_rows, 768, 512)
    paged_int4_cases = [check_paged(dev, cfg, "int4", PAGED["slots"] + 1, 512, PAGED["page_size"],
                                    PAGED["total_pages"]), check_paged_shipped(dev, "int4")]
    # the int4 MLP kernels at path g's lanes, path f's rows and a small batch; the fallback rule
    int4_gu_cases, int4_dn_cases = [], []
    for m in INT4_MS:
        gu_case, dn_cases = check_int4(dev, cfg, m)
        int4_gu_cases.append(gu_case)
        int4_dn_cases.extend(dn_cases)
    int4_fallback = check_int4_fallback(dev, cfg)
    w8a8_cases = check_w8a8(dev, cfg)
    tp_cases = tp_kernel_cases(dev)  # at the shapes a rank of a TP group gives them (path m)
    dequant_cases = prefill_dequant_cases(dev, cfg)
    torch.cuda.empty_cache()
    lap("kernel cases")

    # ---- the serving and update kernels, paths a-d ----
    r = earlier_paths(dev, card, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    lap("paths a-d")
    print(f"after paths a-d: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated", flush=True)

    # ---- paths e and f: the trainer; then the checkpoint round trip ----
    with tempfile.TemporaryDirectory() as work_dir:
        trainer, train_ds, trainer_res = trainer_path(dev, card, work_dir)
        knob_res = knob_paths(dev, card, trainer, train_ds, r["probs_diff"])
        control_res = w4_controls(card, trainer, train_ds)
        g_res = continuous_w4a8_path(dev, card, trainer, train_ds)
        del trainer, train_ds
        gc.collect()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        ckpt_res = checkpoint_round_trip(dev, card, cfg, work_dir)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"after paths e-g and the checkpoint round trip: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "still allocated", flush=True)
    lap("paths e-g and the checkpoint")

    # ---- paths i and j: the critic through the trainer, then the eval harness on its policy ----
    with tempfile.TemporaryDirectory() as work_dir:
        gae_trainer, i_res = gae_path(dev, card, work_dir)
        j_res = eval_path(dev, card, gae_trainer, work_dir)
        del gae_trainer
        gc.collect()
        torch.cuda.empty_cache()
    lap("paths i-j")

    # ---- path k: the shipped 7B script through the trainer, state on the host ----
    with tempfile.TemporaryDirectory() as work_dir:
        k_res = sevenb_path(dev, card, work_dir)
    gc.collect()
    torch.cuda.empty_cache()
    lap("path k")

    # ---- path l: the distributed branch and sequence parallelism, in processes of their own ----
    with tempfile.TemporaryDirectory() as work_dir:
        l_res = path_l(card, work_dir)
    lap("path l")

    # ---- path m: Megatron tensor parallelism, two ranks of a TP group on one card ----
    with tempfile.TemporaryDirectory() as work_dir:
        m_res = path_m(card, work_dir)
    lap("path m")

    def entry(name, route, source, replaces, cases, n_launch, **extra):
        main_case = cases[0]
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": n_launch, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "cases": cases, **extra,
        }

    dense_l, paged_l, bf16_l, train_l = (r[k] for k in ("dense_launches", "paged_launches",
                                                       "bf16_launches", "train_launches"))
    trainer_l = trainer_res["launches"]
    decode_cu = "spatialthinker_torch/csrc/decode_attention.cu"
    paged_cu = "spatialthinker_torch/csrc/paged_attention.cu"
    i_flash, i_l, j_l = i_res.pop("flash"), i_res["launches"], j_res["launches"]
    k_kern, k_l = k_res.pop("kernels"), k_res["launches"]
    kernels = [
        entry("flash_fwd", "cuda", "spatialthinker_torch/csrc/flash_attention.cu",
              "spatialthinker_tpu/ops/flash_attention.py:45",
              r["flash_cases"] + i_flash["fwd"] + k_kern["fwd"] + tp_cases["flash"],
              paged_l["flash_fwd"],
              launches_dense_path=dense_l["flash_fwd"], launches_bf16_pool_path=bf16_l["flash_fwd"],
              launches_training_path=train_l["flash_fwd"], launches_trainer_path=trainer_l["flash_fwd"]),
        # the forward's range tables (part of #1's design: the TPU kernel skips blocks by the causal
        # diagonal only); no one PyTorch call computes them
        entry("flash_ranges", "cuda", "spatialthinker_torch/csrc/flash_attention.cu",
              "spatialthinker_tpu/ops/flash_attention.py:45", r["range_cases"], paged_l["flash_ranges"],
              launches_dense_path=dense_l["flash_ranges"], launches_bf16_pool_path=bf16_l["flash_ranges"],
              launches_training_path=train_l["flash_ranges"], launches_trainer_path=trainer_l["flash_ranges"]),
        # the backward's pre-pass (delta and the segment range tables) takes the place of
        # the XLA rowsum of _flash_bwd; no one PyTorch call computes it
        entry("flash_bwd_prep", "cuda", "spatialthinker_torch/csrc/flash_attention_bwd.cu",
              "spatialthinker_tpu/ops/flash_attention.py:343",
              r["prep_cases"] + i_flash["prep"] + k_kern["prep"] + tp_cases["prep"],
              train_l["flash_bwd_prep"],
              launches_trainer_path=trainer_l["flash_bwd_prep"]),
        entry("flash_bwd_dq", "cuda", "spatialthinker_torch/csrc/flash_attention_bwd.cu",
              "spatialthinker_tpu/ops/flash_attention.py:192",
              r["dq_cases"] + i_flash["dq"] + k_kern["dq"] + tp_cases["dq"],
              train_l["flash_bwd_dq"],
              launches_trainer_path=trainer_l["flash_bwd_dq"]),
        entry("flash_bwd_dkv", "cuda", "spatialthinker_torch/csrc/flash_attention_bwd.cu",
              "spatialthinker_tpu/ops/flash_attention.py:255",
              r["dkv_cases"] + i_flash["dkv"] + k_kern["dkv"] + tp_cases["dkv"],
              train_l["flash_bwd_dkv"],
              launches_trainer_path=trainer_l["flash_bwd_dkv"]),
        entry("decode_attention", "cuda", decode_cu, "spatialthinker_tpu/ops/decode_attention.py:138",
              r["decode_cases"] + tp_cases["decode"]["bf16"], dense_l["decode_attention"]),
        entry("decode_attention_int8", "cuda", decode_cu, "spatialthinker_tpu/ops/decode_attention.py:138",
              int8_cases + knob_res["continuous_int8"]["decode_cases"] + tp_cases["decode"]["int8"],
              knob_res["dense_int8"]["launches"]["decode_attention_int8"],
              launches_continuous_int8=knob_res["continuous_int8"]["launches"]["decode_attention_int8"]),
        entry("decode_attention_int4", "cuda", decode_cu, "spatialthinker_tpu/ops/decode_attention.py:192",
              int4_dense_cases + tp_cases["decode"]["int4"],
              knob_res["dense_int4"]["launches"]["decode_attention_int4"]),
        entry("decode_attention_int4_i8", "cuda", decode_cu, "spatialthinker_tpu/ops/decode_attention.py:257",
              int4_i8_dense_cases + g_res["decode_cases"] + tp_cases["decode"]["int4_i8"],
              knob_res["dense_int4_i8dot"]["launches"]["decode_attention_int4_i8"],
              launches_path_g=g_res["launches"]["decode_attention_int4_i8"],
              launches_dense_w4a8=knob_res["dense_w4a8"]["launches"]["decode_attention_int4_i8"]),
        entry("paged_attention_pool", "cuda", paged_cu, "spatialthinker_tpu/ops/paged_attention.py:113",
              r["pool_cases"], bf16_l["paged_attention_pool"]),
        entry("paged_attention_int4", "cuda", paged_cu, "spatialthinker_tpu/ops/paged_attention.py:225",
              paged_int4_cases, knob_res["paged_int4"]["launches"]["paged_attention_int4"]),
        entry("paged_attention_int4_i8", "cuda", paged_cu, "spatialthinker_tpu/ops/paged_attention.py:338",
              r["int4_cases"] + k_kern["paged"] + tp_cases["paged"], paged_l["paged_attention_int4_i8"],
              launches_training_path=train_l["paged_attention_int4_i8"],
              launches_trainer_path=trainer_l["paged_attention_int4_i8"]),
        entry("silu_quant", "cuda", "spatialthinker_torch/csrc/silu_quant.cu",
              "spatialthinker_tpu/ops/int8_matmul.py:128", r["silu_cases"] + g_res["silu_cases"] + k_kern["silu"],
              paged_l["silu_quant"],
              launches_training_path=train_l["silu_quant"], launches_trainer_path=trainer_l["silu_quant"],
              launches_path_g=g_res["launches"]["silu_quant"]),
        # library_ms of the int4 kernels: torch._int_mm on the INT8 copy of the weights (yardstick only)
        entry("int4_gateup_silu", "cuda", "spatialthinker_torch/csrc/int4_mlp.cu",
              "spatialthinker_tpu/ops/int4_mlp.py:150", int4_gu_cases + tp_cases["int4"]["gateup"],
              g_res["launches"]["int4_gateup"],
              launches_dense_w4a8=knob_res["dense_w4a8"]["launches"]["int4_gateup"],
              library="torch._int_mm, int8 weights, yardstick only"),
        entry("int4_down", "cuda", "spatialthinker_torch/csrc/int4_mlp.cu",
              "spatialthinker_tpu/ops/int4_mlp.py:168", int4_dn_cases, g_res["launches"]["int4_down"],
              launches_dense_w4a8=knob_res["dense_w4a8"]["launches"]["int4_down"],
              library="torch._int_mm, int8 weights, yardstick only", fallback=int4_fallback),
        # #14's split entry (a row-parallel down shard under tensor parallelism: the row amax of
        # the whole I, fp32 partials); launches are path m3's dense w4a8 case, rank 0
        entry("int4_down_split", "cuda", "spatialthinker_torch/csrc/int4_mlp.cu",
              "spatialthinker_tpu/ops/int4_mlp.py:168", tp_cases["int4"]["down_split"],
              m_res["m2"][0]["m3"]["dense_w4a8"]["launches"]["int4_down_split"],
              library="torch._int_mm, the int8 shard, yardstick only"),
        # library_ms: torch._int_mm alone on the pre-quantized x (the dot without quantize or epilogue)
        entry("w8a8_matmul", "cuda", "spatialthinker_torch/csrc/int8_matmul.cu",
              "spatialthinker_tpu/ops/int8_matmul.py:46",
              r["w8a8_cases"] + g_res["w8a8_cases"] + w8a8_cases + k_kern["w8a8"] + tp_cases["w8a8"],
              paged_l["w8a8"], replaces_also="spatialthinker_tpu/ops/int8_matmul.py:65",
              library="torch._int_mm on the pre-quantized x",
              launches_prequantized_path_b=paged_l["w8a8_prequantized"],
              launches_path_h=r["h_launches"]["w8a8"], launches_training_path=train_l["w8a8"],
              launches_trainer_path=trainer_l["w8a8"], launches_path_g=g_res["launches"]["w8a8"],
              launches_knob_cases={k: v["w8a8_launches"] for k, v in knob_res.items()},
              int_mm_on_main_paths=sum(x["int_mm"] for x in (paged_l, r["h_launches"], train_l, trainer_l,
                                                             g_res["launches"]))),
        entry("paged_staged_block", "cuda", paged_cu, "spatialthinker_tpu/ops/paged_attention.py:59",
              r["staged_cases"], r["h_launches"]["paged_staged"]),
        # #12's split mode (tensor parallelism: the row scale over the whole I): launches are
        # path m2's, rank 0, both passes (each rank's in launches_path_m)
        entry("silu_quant_split", "cuda", "spatialthinker_torch/csrc/silu_quant.cu",
              "spatialthinker_tpu/ops/int8_matmul.py:128", tp_cases["silu"],
              m_res["m2"][0]["launches"]["silu_amax"] + m_res["m2"][0]["launches"]["silu_with_amax"]),
        # kernel A's row quantize in its split mode (a row-parallel input under tensor parallelism:
        # the scale of the whole K); launches are path m2's, rank 0, both passes
        entry("w8a8_quantize_split", "cuda", "spatialthinker_torch/csrc/int8_matmul.cu",
              "spatialthinker_tpu/ops/int8_matmul.py:52", tp_cases["quant_split"],
              m_res["m2"][0]["launches"]["quant_amax"] + m_res["m2"][0]["launches"]["quant_with_amax"],
              replaces_also="spatialthinker_tpu/ops/int8_matmul.py:70"),
    ]
    count_keys = {"int4_gateup_silu": "int4_gateup", "w8a8_matmul": "w8a8", "paged_staged_block": "paged_staged"}
    l1_l = l_res["l1"]["launches"]
    count_keys["silu_quant_split"] = ("silu_amax", "silu_with_amax")
    count_keys["w8a8_quantize_split"] = ("quant_amax", "quant_with_amax")
    for k in kernels:
        key = count_keys.get(k["name"], k["name"])
        # per rank of path m2 (the trainer at tp 2) and of m1 (the model's forward)
        pick = (lambda c: c[key[0]] + c[key[1]]) if isinstance(key, tuple) else (lambda c: c[key])
        k["launches_path_m"] = {"m2": [pick(r["launches"]) for r in m_res["m2"]],
                                "m1": [pick(r["launches"]) for r in m_res["m1"]],
                                "m3": {label: [pick(r["m3"][label]["launches"]) for r in m_res["m2"]]
                                       for label, _, _, _ in TP_M3_CASES}}
        if isinstance(key, tuple):
            continue
        k["launches_gae_path"], k["launches_eval_path"] = i_l[key], j_l[key]
        k["launches_7b_path"] = k_l[key]
        k["launches_path_l1"] = l1_l[key]
        if key in FLASH_COUNTS:  # per rank of path l2: the attention calls, then the model's
            k["launches_path_l2"] = {
                name: [r["attention"][name]["launches"][key] for r in l_res["l2"]]
                for name in l_res["l2"][0]["attention"]} | {
                f"model_{name}": [r["model"][name]["launches"][key] for r in l_res["l2"]]
                for name in ("ring", "ulysses")}
    print(json.dumps({"kernels": kernels, "paths": {
        "dense": {"decode_tok_s": r["decode_tok_s"], "prefill_s": r["prefill_s"], "peak_gb": r["peak_gb"]},
        "paged_int4": {"decode_tok_s": r["decode_tok_s_paged"], "prefill_s": r["st"]["refill_s"],
                       "peak_gb": r["paged_peak_gb"], "probs_diff": r["probs_diff"],
                       "first_token_agreement": r["first_agree"], "stats": r["st"]},
        "paged_bf16": {"rows_equal_dense": r["rows_equal"], "drift": r["drift_paged"],
                       "dense_drift": r["drift_dense"], "seconds": r["bf16_s"]},
        "paged_int4_fused_ring": {"decode_tok_s": r["decode_tok_s_fused"], "prefill_s": r["st_h"]["refill_s"],
                                  "peak_gb": r["h_peak_gb"], "probs_diff": r["probs_diff_h"],
                                  "stats": r["st_h"], "unfused_decode_tok_s": r["decode_tok_s_paged"]},
        "training": {"steps": r["train"]["steps"], "grad_norm_rel": r["train"]["grad_norm_rel"],
                     "grad_cosine": r["train"]["grad_cosine"],
                     "packed_logp_diff": r["train"]["packed_logp_diff"], "knobs": TRAIN},
        "trainer": trainer_res, "knobs": knob_res, "w4_controls": control_res, "continuous_w4a8": g_res,
        "checkpoint": ckpt_res, "gae": i_res, "eval": j_res, "sevenb": k_res,
        "distributed": {"l1": {k: v for k, v in l_res["l1"].items() if k != "launches"},
                        "l2": [{k: v for k, v in r.items()} for r in l_res["l2"]],
                        "nccl_two_ranks_one_device": l_res["nccl_two_ranks_one_device"],
                        "seconds": l_res["seconds"]},
        "prefill_dequant": dequant_cases,
        "phase_seconds": phases,
        "tensor_parallel": {"m1": m_res["m1"], "m2": [{k: v for k, v in r.items() if k != "launches"}
                                                       for r in m_res["m2"]], "seconds": m_res["seconds"]},
    }, "seconds": time.perf_counter() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
