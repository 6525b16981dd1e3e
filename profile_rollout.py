#!/usr/bin/env python3
"""Where the time of the port's rollout goes, on one NVIDIA GPU.

    python3 profile_rollout.py [--engine dense|w4a8|paged|train]

``--engine dense`` (the default) builds the same 3B model, requests and
sampled call (n=5, T=1.0) as ``chip_smoke.py``, then times a 1-token call (prefill + fanout + first
sample) and a 17-token call (the same + 16 decode steps), first unprofiled
(two runs each) and then once each under ``torch.profiler``. Prints the
top device kernels of both profiled calls and, for the 16 decode steps
(difference of the two calls): the profiled wall time, device kernel time,
kernels per step and the busy share (device time / profiled wall), plus the
device time per step over the unprofiled wall per step as an estimate of the
busy share without the profiler's own host cost.

``--engine w4a8`` does the same on the w4a8 copy of the model
(``quantize_model(mode="w4a8")``: W8A8 linears, int4 MLP copies) at path
(g)'s decode rows, 17 prompts x n 8 = 136, over an int4 cache with int8
dots, and prints the int4 MLP kernels' device time (#13 and #14 with their
prologues) and the int8-dot decode attention's (#6) per decode step; then
#6 alone on the inputs of the last decode step's calls (recorded from one
more 17-token call): µs of a call queued back to back over the 36 layers in
turn, as recorded, with ``time_decode.py``'s ``path_g`` kv_seg pattern and
with seeded random values, so the kernel's time in the step and out of it
are read on the same inputs.

``--engine paged`` runs ``chip_smoke.py``'s shipped paged path (W8A8 weights,
int4 pools, int8 dots, 16 requests x 8 samples through 64 slots) and puts
``torch.profiler`` around ONE decode chunk of 16 steps (the third; the
second and fourth are timed unprofiled): top device kernels, kernels per
step, device time per step by kind of kernel (kernel A's GEMM with its
split-K combine, kernel A's quantize prologue, the paged attention, the rest),
busy share as profiled and device time over the unprofiled wall per step,
and the paged kernel's (#9's) device ms and launches per step on a line of
its own;
and around ONE refill prefill (the second; 8 image prompts, W8A8 at m =
1,024 rows a chunk): its wall, device time and the same kinds. It does so
with the staging ring merged after the pool kernel (the default), then with
the ring fused into it (``generate_paged(fuse_staged=True)``); ``--ring
merged`` or ``--ring fused`` runs one of the two.

``--tree DIR`` imports the package (and ``chip_smoke.py``'s configuration)
from another checkout, e.g. the parent's ``git archive`` unpacked, so two
trees are profiled on one card: run the parent and the change in turns.

``--engine train`` profiles the actor update of ``chip_smoke.py``'s training
path: 16 image prompts with 64 response tokens each are packed into rows, and
``torch.profiler`` goes around ONE micro-batch (4 packed rows) forward +
backward through ``make_packed_grad_fn`` (per-layer checkpointing, the flash
forward and backward kernels, chunked log-probs) and around ONE AdamW step
over every parameter; a third window holds the chunked log-prob forward +
backward alone at the same rows. Prints device time by kind of kernel
(attention forward of the vision tower and of the text layers apart, the
forward's range tables, the backward's pre-pass, dQ, dK/dV, GEMMs,
everything else), the busy share of
each window and the top device kernels. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time


def _tree_from_argv():
    """``--tree DIR`` is read before the package is imported, so that the
    package and ``chip_smoke`` come from that checkout."""
    for i, arg in enumerate(sys.argv):
        if arg == "--tree" and i + 1 < len(sys.argv):
            return sys.argv[i + 1]
        if arg.startswith("--tree="):
            return arg.split("=", 1)[1]
    return None


if _tree_from_argv():
    sys.path.insert(0, _tree_from_argv())

import numpy as np  # noqa: E402
import torch
from torch.profiler import ProfilerActivity, profile

import spatialthinker_torch.rollout.paged as paged_engine
from chip_smoke import (
    ACTOR, MAX_NEW_TOKENS, PAGED, PAGED_REQUESTS, QUESTIONS, TRAIN, prompt_batch, requests, smi_line,
)
from spatialthinker_torch.eval.providers import TorchProvider
from spatialthinker_torch.models.qwen2_5_vl import init_params, qwen25_vl_3b
from spatialthinker_torch.ops.quant import quantize_model
from spatialthinker_torch.rollout.engine import generate
from spatialthinker_torch.models.qwen2_5_vl.model import vision_to_device
from spatialthinker_torch.ops.logprobs import log_probs_from_hidden
from spatialthinker_torch.rollout.sampling import SamplingParams
from spatialthinker_torch.trainer.grpo_trainer import (
    compute_log_probs_batched, packed_micro_batches, rollout_batch_from_result, to_device,
)
from spatialthinker_torch.trainer.train_step import (
    apply_optimizer_step, make_optimizer, make_packed_grad_fn,
)
from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

N_SAMPLES = 5
W4A8_PROMPTS, W4A8_SAMPLES = 17, 8  # 136 rows: path (g)'s decode lanes
DECODE_STEPS = 16
PROFILED_CHUNK = 2  # of the paged run's decode chunks (0 warms up; 1 and 3 are timed unprofiled)
PROFILED_REFILL = 1  # of its refill prefills (the first warms up)


PAGED_KINDS = (
    # kernel A: the GEMM with its split-K combine (one kernel) and the quantize prologue;
    # ``int8_gemm_kernel`` is the name of the GEMM before the Hopper redesign
    ("kernel A GEMM (w8a8_gemm_kernel / int8_gemm_kernel)", ("w8a8_gemm_kernel", "int8_gemm_kernel")),
    ("kernel A prologue (quantize_rows_kernel)", ("quantize_rows_kernel",)),
    ("paged attention (paged_kernel)", ("paged_kernel",)),
    ("flash forward (flash_fwd_kernel, flash_ranges_kernel)", ("flash_fwd_kernel", "flash_ranges_kernel")),
    ("silu junction (silu_quant_kernel)", ("silu_quant",)),
    ("GEMMs (library matmuls)", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "gemv")),
)
OTHER = "everything else (elementwise, reductions, copies)"


def by_kind(kernels, kinds) -> dict:
    """{kind: [device ms, launches]} of profiler kernel events."""
    out = {name: [0.0, 0] for name, _ in kinds}
    out[OTHER] = [0.0, 0]
    for e in kernels:
        low = e.name.lower()
        kind = next((name for name, keys in kinds if any(k in low for k in keys)), OTHER)
        out[kind][0] += e.device_time / 1e3
        out[kind][1] += 1
    return out


def profile_paged_chunk(model, qmodel, cfg, dev, card, fuse_staged: bool) -> None:
    provider = TorchProvider(model, cfg, QwenSyntheticTokenizer(cfg), max_new_tokens=MAX_NEW_TOKENS,
                             max_prompt_length=1024, prompt_bucket=512)
    host = provider.prepare_host(*requests(PAGED_REQUESTS, seed=3))
    steps = PAGED["decode_chunk_size"]
    real, real_prefill = paged_engine.decode_chunk_paged, paged_engine.prefill_paged
    walls, profiled, refills = [], {}, []

    def timed_chunk(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(walls) == PROFILED_CHUNK:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = real(*args, **kwargs)
                torch.cuda.synchronize()
            profiled["prof"] = prof
        else:
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    def timed_refill(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(refills) == PROFILED_REFILL:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = real_prefill(*args, **kwargs)
                torch.cuda.synchronize()
            profiled["refill"] = prof
        else:
            out = real_prefill(*args, **kwargs)
            torch.cuda.synchronize()
        refills.append(time.perf_counter() - t0)
        return out

    paged_engine.decode_chunk_paged, paged_engine.prefill_paged = timed_chunk, timed_refill
    try:
        result = paged_engine.generate_paged(
            qmodel, host["input_ids"], host["segment_ids"], host["position_ids"], host["gen_pos_start"],
            max_new_tokens=MAX_NEW_TOKENS, sampling=SamplingParams(temperature=1.0),
            generator=torch.Generator(device=dev).manual_seed(2), kv_cache_dtype=torch.uint8,
            int4_i8dot=True, patches_list=host["patches_list"], grids_list=host["grids_list"],
            fuse_staged=fuse_staged, **PAGED,
        )
    finally:
        paged_engine.decode_chunk_paged, paged_engine.prefill_paged = real, real_prefill
    prof = profiled["prof"]
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_s = sum(e.device_time for e in kernels) / 1e6
    wall = walls[PROFILED_CHUNK]
    unprof = statistics.median([walls[PROFILED_CHUNK - 1], walls[PROFILED_CHUNK + 1]])
    ring = "fused into the pool kernel" if fuse_staged else "merged after the pool kernel"
    print(f"paged run, staging ring {ring}: stats {result.stats}; chunk walls s "
          f"{[round(w, 4) for w in walls]}; refill walls s {[round(w, 4) for w in refills]}", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=18,
                                    max_name_column_width=60), flush=True)
    print(f"paged decode chunk of {steps} steps at {PAGED['slots']} slots, ring {ring}: profiled wall "
          f"{wall:.4f} s, "
          f"device {device_s:.4f} s, busy share {device_s / wall:.3f}, kernels per step "
          f"{len(kernels) / steps:.0f}; per step: device {device_s / steps * 1e3:.3f} ms, unprofiled wall "
          f"{unprof / steps * 1e3:.3f} ms, device / unprofiled wall {device_s / unprof:.3f}  [{card}]",
          flush=True)
    kinds = by_kind(kernels, PAGED_KINDS)
    for kind, (ms, n) in kinds.items():
        print(f"    per decode step, {kind}: {ms / steps:.3f} ms in {n / steps:.1f} launches "
              f"({ms / max(device_s * 1e3, 1e-9):.1%})", flush=True)
    gemm, prologue = kinds[PAGED_KINDS[0][0]], kinds[PAGED_KINDS[1][0]]
    print(f"kernel A per decode step, ring {ring}: {(gemm[0] + prologue[0]) / steps:.3f} ms of "
          f"{device_s / steps * 1e3:.3f} ms device (GEMM {gemm[0] / steps:.3f} ms in {gemm[1] / steps:.0f} "
          f"launches, {gemm[0] / max(gemm[1], 1) * 1e3:.2f} us each; prologue {prologue[0] / steps:.3f} ms in "
          f"{prologue[1] / steps:.0f})  [{card}]", flush=True)
    pk = kinds[PAGED_KINDS[2][0]]
    print(f"paged kernel #9 per decode step, ring {ring}: {pk[0] / steps:.3f} ms of {device_s / steps * 1e3:.3f} ms "
          f"device in {pk[1] / steps:.0f} launches, {pk[0] / max(pk[1], 1) * 1e3:.2f} us each  [{card}]", flush=True)
    if "refill" in profiled:
        rk = [e for e in profiled["refill"].events() if e.device_type.name == "CUDA"]
        r_dev = sum(e.device_time for e in rk) / 1e3
        r_wall = refills[PROFILED_REFILL] * 1e3
        rkinds = by_kind(rk, PAGED_KINDS)
        for kind, (ms, n) in rkinds.items():
            print(f"    refill, {kind}: {ms:.2f} ms in {n} launches ({ms / max(r_dev, 1e-9):.1%})", flush=True)
        ga, pa_ = rkinds[PAGED_KINDS[0][0]], rkinds[PAGED_KINDS[1][0]]
        print(f"kernel A per refill, ring {ring}: {ga[0] + pa_[0]:.2f} ms of {r_dev:.2f} ms device "
              f"(GEMM {ga[0]:.2f} ms in {ga[1]} launches, prologue {pa_[0]:.2f} ms in {pa_[1]}); refill "
              f"profiled wall {r_wall:.1f} ms, busy share {r_dev / r_wall:.3f}  [{card}]", flush=True)


KERNEL_KINDS = (
    ("attention forward, vision D = 80 (flash_fwd_kernel<80>)", ("flash_fwd_kernel<80",)),
    ("attention forward, text D = 128 (flash_fwd_kernel<128>)", ("flash_fwd_kernel<128",)),
    ("attention forward range tables (flash_ranges_kernel)", ("flash_ranges_kernel",)),
    ("attention backward pre-pass (flash_bwd_prep_kernel)", ("flash_bwd_prep_kernel",)),
    ("attention backward dQ (flash_bwd_dq_kernel)", ("flash_bwd_dq_kernel",)),
    ("attention backward dK/dV (flash_bwd_dkv_kernel, flash_bwd_dkv_reduce_kernel)", ("flash_bwd_dkv",)),
    ("GEMMs (library matmuls)", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "gemv")),
)


def _window(fn, label: str, card: str, rows: int = 14) -> float:
    """Run ``fn`` unprofiled (wall), then under the profiler; print device time
    by kind of kernel, the busy share and the top kernels. Returns device ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    by_kind = {name: [0.0, 0] for name, _ in KERNEL_KINDS}
    by_kind["everything else (elementwise, reductions, copies)"] = [0.0, 0]
    for e in kernels:
        low = e.name.lower()
        kind = next((name for name, keys in KERNEL_KINDS if any(k in low for k in keys)),
                    "everything else (elementwise, reductions, copies)")
        by_kind[kind][0] += e.device_time / 1e3
        by_kind[kind][1] += 1
    print(f"{label}: unprofiled wall {unprofiled * 1e3:.1f} ms, profiled wall {wall * 1e3:.1f} ms, "
          f"device {device_ms:.1f} ms in {len(kernels)} kernels, busy share as profiled "
          f"{device_ms / (wall * 1e3):.3f}, device / unprofiled wall {device_ms / (unprofiled * 1e3):.3f}  "
          f"[{card}]", flush=True)
    for kind, (ms, n) in by_kind.items():
        print(f"    {kind}: {ms:.2f} ms in {n} launches ({ms / max(device_ms, 1e-9):.1%})", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows,
                                    max_name_column_width=60), flush=True)
    return device_ms


def profile_train_step(model, cfg, dev, card) -> None:
    provider = TorchProvider(model, cfg, QwenSyntheticTokenizer(cfg), max_new_tokens=MAX_NEW_TOKENS,
                             max_prompt_length=1024, prompt_bucket=512)
    prompts = prompt_batch(provider.prepare_host(*requests(PAGED_REQUESTS, seed=3)))
    rng = np.random.default_rng(4)
    n = len(prompts)
    responses = rng.integers(1000, 100000, size=(n, MAX_NEW_TOKENS)).astype(np.int32)
    mask = np.ones_like(responses)
    rolled = rollout_batch_from_result(prompts, responses, mask, np.zeros(responses.shape, np.float32))
    logp = compute_log_probs_batched(model, rolled, micro_batch_size=TRAIN["experience_micro"],
                                     temperature=ACTOR["temperature"], device=dev)
    rolled.tensors.update(old_log_probs=logp, ref_log_probs=logp,
                          advantages=rng.normal(size=logp.shape).astype(np.float32))
    ptb_all, vis_all = packed_micro_batches(rolled, cfg.vision, TRAIN["micro_rows"])
    ptb = to_device(type(ptb_all)(*(x[:1] for x in ptb_all)), dev)   # the first micro-batch
    vis = vision_to_device(type(vis_all)(*(x[:1] for x in vis_all)), dev)
    live = ptb.segment_ids != 0
    print(f"micro-batch: packed rows {tuple(ptb.input_ids.shape[1:])} of "
          f"{ptb_all.input_ids.shape[0] * ptb_all.input_ids.shape[1]}, "
          f"{int(live.sum())} tokens (fill {float(live.float().mean()):.3f}), vision patch slots "
          f"{vis.patches.shape[1]}; knobs {ACTOR}", flush=True)

    grad_fn = make_packed_grad_fn(model, **ACTOR)
    optimizer = make_optimizer(TRAIN["lr"], strategy=TRAIN["strategy"])
    out = {}

    def forward_backward():
        out.clear()  # the previous accumulators go before the next ones come
        out["grads"], out["metrics"], out["finite"], out["factor"] = grad_fn(ptb, vis)

    def optimizer_step():
        apply_optimizer_step(optimizer, out["grads"], model, finite=out["finite"],
                             grad_scale=out["factor"])

    forward_backward()  # warm-up: kernel loads, allocator, the moments' first allocation
    optimizer_step()
    fb_ms = _window(forward_backward, "one micro-batch forward + backward", card, rows=18)
    opt_ms = _window(optimizer_step, f"one {TRAIN['strategy']} step over "
                     f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters", card, rows=8)
    out.clear()
    torch.cuda.empty_cache()

    hidden = torch.randn(ptb.input_ids.shape[1:] + (cfg.text.hidden_size,), device=dev,
                         dtype=torch.bfloat16).requires_grad_()
    head = model.text.embed_tokens.weight

    def log_prob_chunks():
        logp, _ = log_probs_from_hidden(hidden, ptb.labels[0], head, chunk_size=ACTOR["chunk_size"],
                                        temperature=ACTOR["temperature"])
        torch.autograd.grad(logp.sum(), (hidden, head))

    log_prob_chunks()
    lp_ms = _window(log_prob_chunks, "chunked log-probs alone, forward + backward", card, rows=8)
    print(f"train step summary: forward + backward {fb_ms:.1f} ms device, of which the chunked log-probs "
          f"measured alone {lp_ms:.1f} ms; optimizer step {opt_ms:.1f} ms device; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--engine", choices=("dense", "w4a8", "paged", "train"), default="dense")
    parser.add_argument("--ring", choices=("both", "merged", "fused"), default="both",
                        help="--engine paged: the staging ring forms to profile")
    parser.add_argument("--tree", default=None, help="checkout whose spatialthinker_torch is profiled")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_rollout: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(card, flush=True)
    cfg = qwen25_vl_3b()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    if args.engine == "paged":
        qmodel = quantize_model(model, mode="int8")
        forms = {"both": (False, True), "merged": (False,), "fused": (True,)}[args.ring]
        for fuse_staged in forms:
            profile_paged_chunk(model, qmodel, cfg, dev, card, fuse_staged)
        return 0
    if args.engine == "train":
        profile_train_step(model, cfg, dev, card)
        return 0
    provider = TorchProvider(model, cfg, QwenSyntheticTokenizer(cfg), max_new_tokens=MAX_NEW_TOKENS,
                             max_prompt_length=1024, prompt_bucket=512)
    w4a8 = args.engine == "w4a8"
    n_samples = W4A8_SAMPLES if w4a8 else N_SAMPLES
    prep = provider.prepare(*requests(W4A8_PROMPTS if w4a8 else len(QUESTIONS)))
    sampling = SamplingParams(temperature=1.0, top_p=1.0, top_k=-1, n=n_samples)
    gen = torch.Generator(device=dev).manual_seed(1)
    engine_model, engine_kw = model, {}
    if w4a8:
        engine_model = quantize_model(model, mode="w4a8")
        engine_kw = dict(kv_cache_dtype=torch.uint8, int4_i8dot=True)

    def call(tokens: int) -> float:
        t0 = time.perf_counter()
        generate(engine_model, **prep, max_new_tokens=tokens, sampling=sampling, generator=gen, n=n_samples,
                 **engine_kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call(8)  # warm-up: kernel loads, allocator
    short, long = 1, 1 + DECODE_STEPS
    walls = {short: [], long: []}
    for tokens in (short, long, short, long):
        walls[tokens].append(call(tokens))
    print(f"unprofiled wall s: {walls}  [{card}]", flush=True)

    prof_res, int4_res, dec_res = {}, {}, {}
    for tokens in (short, long):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = call(tokens)
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        device_s = sum(e.device_time for e in kernels) / 1e6
        prof_res[tokens] = (wall, device_s, len(kernels))
        int4 = [e for e in kernels if "int4_mlp_kernel" in e.name or "int4_quantize_rows" in e.name]
        int4_res[tokens] = (sum(e.device_time for e in int4) / 1e3, len(int4))
        # #6: the split kernel's int4 instance, or the first design's template in an older tree
        dec = [e for e in kernels if "decode_int4_kernel" in e.name or "decode_quant_kernel" in e.name]
        dec_res[tokens] = (sum(e.device_time for e in dec) / 1e3, len(dec))
        print(f"{tokens}-token call: profiled wall {wall:.4f} s, device kernel time {device_s:.4f} s, "
              f"{len(kernels)} kernels", flush=True)
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=14,
                                        max_name_column_width=60), flush=True)

    (w1, d1, n1), (w2, d2, n2) = prof_res[short], prof_res[long]
    step_device = (d2 - d1) / DECODE_STEPS
    step_wall_unprof = (statistics.median(walls[long]) - statistics.median(walls[short])) / DECODE_STEPS
    print(f"{DECODE_STEPS} decode steps: profiled wall {w2 - w1:.4f} s, device {d2 - d1:.4f} s, "
          f"busy share {(d2 - d1) / (w2 - w1):.3f}, kernels per step {(n2 - n1) / DECODE_STEPS:.0f}; "
          f"per step: device {step_device * 1e3:.3f} ms, unprofiled wall {step_wall_unprof * 1e3:.3f} ms, "
          f"device / unprofiled wall {step_device / step_wall_unprof:.3f}  [{card}]", flush=True)
    if w4a8:
        (ms1, n1), (ms2, n2) = int4_res[short], int4_res[long]
        print(f"int4 MLP kernels (#13 + #14 with their prologues) per decode step at "
              f"{W4A8_PROMPTS * W4A8_SAMPLES} rows: {(ms2 - ms1) / DECODE_STEPS:.4f} ms in "
              f"{(n2 - n1) / DECODE_STEPS:.0f} launches  [{card}]", flush=True)
        (ms1, n1), (ms2, n2) = dec_res[short], dec_res[long]
        print(f"int4 decode attention with int8 dots (#6) per decode step at {W4A8_PROMPTS * W4A8_SAMPLES} "
              f"rows: {(ms2 - ms1) / DECODE_STEPS:.4f} ms in {(n2 - n1) / DECODE_STEPS:.0f} launches  [{card}]",
              flush=True)
        decode_alone(call, card)
    return 0


def decode_alone(call, card) -> None:
    """#6 out of the step on the last decode call's recorded inputs: µs of a
    call among the 36 layers of the recorded cache called in turn (each call
    cold in L2, as in the step), queued back to back behind a sleeping kernel
    (device time with the gaps between launches); then the same with the
    recorded kv_seg swapped for ``time_decode.py``'s ``path_g`` pattern of as
    many rows, and with the recorded cache, scales and q swapped for seeded
    random ones (the recorded kv_seg kept), so a difference between the step's
    inputs and the timed draw shows which of the two it follows."""
    import spatialthinker_torch.models.qwen2_5_vl.text as text_mod
    from spatialthinker_torch.ops import decode_attention as da
    real, kept = text_mod.decode_attention, {}

    def keep(*args, **kwargs):
        kept["args"], kept["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    text_mod.decode_attention = keep
    try:
        call(1 + DECODE_STEPS)
    finally:
        text_mod.decode_attention = real
    q, kc, vc, seg, _, ks, vs = kept["args"]
    layers, rows = kc.shape[0], q.shape[0]

    def timed(q, kc, vc, seg, ks, vs) -> float:
        turn = [0]

        def one():
            turn[0] += 1
            return da.decode_attention(q, kc, vc, seg, turn[0] % layers, ks, vs, **kept["kwargs"])

        one()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms: longer than issuing the calls
        start.record()
        for _ in range(layers):
            one()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / layers

    rng = np.random.default_rng(41)  # time_decode.py's path_g pattern: a left-padded prompt + 32 cells, 8 empty
    drawn = np.zeros(tuple(seg.shape), np.int32)
    for i, prompt in enumerate(rng.integers(320, 513, size=rows - 8)):
        drawn[i, 512 - prompt: 512 + 32] = 1
    drawn = torch.from_numpy(drawn).to(seg.device)
    gen = torch.Generator(device=q.device).manual_seed(17)
    rk = torch.randint(0, 256, tuple(kc.shape), dtype=torch.uint8, device=q.device, generator=gen)
    rv = torch.randint(0, 256, tuple(vc.shape), dtype=torch.uint8, device=q.device, generator=gen)
    rks, rvs = ((torch.rand(tuple(ks.shape), device=q.device, generator=gen) * 0.09 + 0.01).to(torch.bfloat16)
                for _ in range(2))
    rq = torch.randn(tuple(q.shape), device=q.device, generator=gen).to(torch.bfloat16)
    print(f"#6 alone on the last step's inputs: q{tuple(q.shape)} cache{tuple(kc.shape)} "
          f"cells={int((seg != 0).sum())}, queued µs a call over the {layers} layers in turn: recorded "
          f"{timed(q, kc, vc, seg, ks, vs):.2f}; path_g's kv_seg pattern ({int(drawn.sum())} cells) "
          f"{timed(q, kc, vc, drawn, ks, vs):.2f}; random cache, scales and q with the recorded kv_seg "
          f"{timed(rq, rk, rv, seg, rks, rvs):.2f}  [{card}]", flush=True)

if __name__ == "__main__":
    sys.exit(main())
