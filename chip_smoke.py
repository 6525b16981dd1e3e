#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``spatialthinker_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc; exits non-zero without one. In order:

1. prints the card's ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``spatialthinker_torch/csrc`` (prints seconds);
3. holds each kernel against its plain PyTorch version on the card at the
   slice's own shapes (max abs error, median CUDA-event times of both);
4. drives the main path at full Qwen2.5-VL-3B width with seeded random bf16
   weights made on the device: 4 image+question requests through
   ``TorchProvider.generate`` (greedy, 64 new tokens), then one sampled
   ``engine.generate`` call at the shipped rollout defaults (n=5, T=1.0) on
   the same prompts; checks both kernels launched on that path and no plain
   attention ran, outputs are finite and log-probs <= 0, and the kernel-path
   prefill logits stay as close to an fp32 reference as the plain path's;
5. prints one JSON line of kernel results, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises and exits non-zero; no phase catches its own failure.
Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

import spatialthinker_torch.ops.decode_attention as da
import spatialthinker_torch.ops.flash_attention as fa
from spatialthinker_torch import csrc
from spatialthinker_torch.eval.providers import TorchProvider
from spatialthinker_torch.models.qwen2_5_vl import (
    init_params, logits_from_hidden, prefill_forward, qwen25_vl_3b, window_patch_len,
)
from spatialthinker_torch.models.qwen2_5_vl.text import KVCache
from spatialthinker_torch.rollout.engine import generate
from spatialthinker_torch.rollout.sampling import SamplingParams
from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

# bf16 kernel vs fp32-softmax plain version on the same bf16 inputs: both
# accumulate in fp32 and round the softmax weights and the output to bf16 at
# different points — a few bf16 ulps of an O(1) output.
OUT_ATOL = 3e-2
LSE_ATOL = 5e-3  # fp32 logsumexp, fast-math exp/log in the kernel
# Full 3B prefill, last-position logits: both bf16 paths (kernels, plain
# attention) drift from an fp32 plain-path reference by bf16 rounding through
# 36 text layers and 32 vision blocks. The kernel path must stay within twice
# the plain path's own drift.
KERNEL_DRIFT_RATIO = 2.0
# ... and the two bf16 paths may differ from each other by at most 5% of the
# largest |logit| (each drifts ~3% from fp32 at this depth on the H100).
LOGITS_REL_TOL = 0.05

MAX_NEW_TOKENS = 64
QUESTIONS = [
    "Is the red mug to the left of the laptop?",
    "How many chairs are around the table?",
    "Which object is closer to the camera, the lamp or the sofa?",
    "Is the bicycle in front of or behind the fence?",
]


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


@contextmanager
def plain_prefill_attention():
    """Route the model's prefill attention through the plain version on the
    card (for the kernel-vs-plain prefill comparison only)."""
    saved = fa.flash_fwd
    fa.flash_fwd = fa.flash_fwd_plain
    try:
        yield
    finally:
        fa.flash_fwd = saved


@contextmanager
def forbid_plain_attention():
    """Fail loudly if the main path reaches a plain attention version."""
    saved = fa.flash_fwd_plain, da.decode_attention_plain

    def refuse(*args, **kwargs):
        raise AssertionError("plain attention ran on the main path")

    fa.flash_fwd_plain = da.decode_attention_plain = refuse
    try:
        yield
    finally:
        fa.flash_fwd_plain, da.decode_attention_plain = saved


def requests(seed: int = 0):
    rng = np.random.default_rng(seed)
    images = [[(rng.random((480, 640, 3)) * 255).astype(np.uint8)] for _ in QUESTIONS]
    return list(QUESTIONS), images


def check_flash(dev, prep, cfg):
    """Flash kernel vs plain at the main path's shapes: text prefill (causal,
    left-padded), vision full attention and windows (D=80), and a
    causal_offset case."""
    rng = np.random.default_rng(1)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)

    tc, vc = cfg.text, cfg.vision
    seg_text = prep["prompt_segment_ids"].to(torch.int32).contiguous()
    b, p = seg_text.shape
    vis = prep["vision"]
    n = vis.seg_full.shape[0]
    wlen = window_patch_len(vc)
    seg_full = vis.seg_full.to(torch.int32).reshape(1, n).contiguous()
    seg_win = vis.seg_window.to(torch.int32).reshape(n // wlen, wlen).contiguous()
    ones_off = torch.ones((b, p + 128), dtype=torch.int32, device=dev)
    cases = [
        ("text_prefill", (b, p, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim),
         seg_text, seg_text, True, 0, p),
        ("vision_full", (1, n, vc.num_heads, vc.num_heads, vc.head_dim), seg_full, seg_full, False, 0, n),
        ("vision_window", (n // wlen, wlen, vc.num_heads, vc.num_heads, vc.head_dim),
         seg_win, seg_win, False, 0, wlen),
        ("causal_offset", (b, 128, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim),
         ones_off[:, p:].contiguous(), ones_off, True, p, p + 128),
    ]
    results = []
    for name, (bb, sq, hq, hkv, d), q_seg, kv_seg, causal, off, skv in cases:
        q, k, v = bf16(bb, sq, hq, d), bf16(bb, skv, hkv, d), bf16(bb, skv, hkv, d)
        kw = dict(causal=causal, scale=d**-0.5, causal_offset=off)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, q_seg, kv_seg, **kw)
        o, lse = fa.flash_fwd(q, k, v, q_seg, kv_seg, **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        dead_ok = bool(torch.all(o[q_seg == 0] == 0))
        plain_ms = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, q_seg, kv_seg, **kw), iters=10)
        ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, q_seg, kv_seg, **kw))
        print(f"flash {name}: q{tuple(q.shape)} kv{tuple(k.shape)} causal={causal} offset={off} "
              f"max_abs_err={err:.3e} lse_err={lse_err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}",
              flush=True)
        if not (err <= OUT_ATOL and lse_err <= LSE_ATOL and dead_ok):
            raise AssertionError(f"flash kernel disagrees with plain on {name}")
        results.append(dict(shape=name, max_abs_err=err, lse_err=lse_err, ms=ms, plain_ms=plain_ms))
        del q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return results


def check_decode(dev, cfg, rows: int, width: int, prompt_len: int):
    """Decode kernel vs plain at the sampled call's cache shape."""
    rng = np.random.default_rng(2)
    tc = cfg.text
    shape = (tc.num_hidden_layers, rows, tc.num_key_value_heads, width, tc.head_dim)
    kc = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    vc = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
    q = torch.from_numpy(
        rng.normal(size=(rows, tc.num_attention_heads, tc.head_dim)).astype(np.float32)
    ).to(dev, torch.bfloat16)
    seg = torch.zeros((rows, width), dtype=torch.int32, device=dev)
    seg[:, : prompt_len + MAX_NEW_TOKENS // 2] = 1
    seg[0, :100] = 0  # left padding
    layer = tc.num_hidden_layers - 1
    scale = tc.head_dim**-0.5
    ref = da.decode_attention_plain(q, kc, vc, seg, layer, scale)
    out = da.decode_attention(q, kc, vc, seg, layer)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    plain_ms = cuda_ms(lambda: da.decode_attention_plain(q, kc, vc, seg, layer, scale))
    ms = cuda_ms(lambda: da.decode_attention(q, kc, vc, seg, layer))
    print(f"decode: q{tuple(q.shape)} cache{tuple(kc.shape)} layer={layer} "
          f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    if not err <= OUT_ATOL:
        raise AssertionError("decode kernel disagrees with plain")
    return [dict(shape="sampled_call_cache", max_abs_err=err, ms=ms, plain_ms=plain_ms)]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    csrc.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({csrc.library_path().name})", flush=True)

    cfg = qwen25_vl_3b()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.2f} s", flush=True)

    prompts, images = requests()
    provider = TorchProvider(model, cfg, QwenSyntheticTokenizer(cfg), max_new_tokens=MAX_NEW_TOKENS,
                             temperature=0.0, max_prompt_length=1024, prompt_bucket=512)
    prep = provider.prepare(prompts, images)
    b, p = prep["input_ids"].shape
    print(f"requests: {len(prompts)} prompts, padded length {p}, "
          f"{int(prep['prompt_segment_ids'].sum())} prompt tokens, "
          f"{prep['vision'].patches.shape[0]} vision patch slots", flush=True)

    flash_cases = check_flash(dev, prep, cfg)
    n_samp = 5
    width = -(-(p + MAX_NEW_TOKENS) // 128) * 128
    decode_cases = check_decode(dev, cfg, len(prompts) * n_samp, width, p)

    # kernel path and plain path vs an fp32 reference: prefill last-position logits
    logits_k = prefill_logits(model, prep)
    with plain_prefill_attention():
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

    # ---- the main path: counts from zero, plain attention forbidden ----
    sampled = SamplingParams(temperature=1.0, top_p=1.0, top_k=-1, n=n_samp)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = 0
    da.decode_attention.launches = 0
    with forbid_plain_attention():
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
    launches = {"flash_fwd": fa.flash_fwd.launches, "decode_attention": da.decode_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    rows = len(prompts) * n_samp
    steps = int(result.response_mask.sum(-1).max()) - 1
    decode_tok_s = rows * steps / (sampled_s - prefill_s)
    print(f"greedy: {len(texts)} answers via TorchProvider in {greedy_s:.3f} s (host preparation "
          f"included)  [{card}]; first: {texts[0][:60]!r}", flush=True)
    print(f"sampled n={n_samp}: responses {tuple(result.responses.shape)} in {sampled_s:.3f} s; "
          f"prefill (R=1 call) {prefill_s:.3f} s; decode {decode_tok_s:.1f} tok/s over {steps} steps "
          f"x {rows} rows; peak allocated {peak_gb:.2f} GB  [{card}]", flush=True)
    print(f"main-path launches: {launches}", flush=True)

    logp = result.rollout_log_probs
    mask = result.response_mask
    checks = {
        "four answers": len(texts) == len(prompts) and all(isinstance(t, str) for t in texts),
        "sampled shape": tuple(result.responses.shape) == (rows, MAX_NEW_TOKENS),
        "log-probs finite": bool(torch.isfinite(logp).all()),
        "log-probs <= 0": bool((logp <= 0).all()),
        "sampled tokens in vocab": bool(((result.responses >= 0) & (result.responses < cfg.text.vocab_size)).all()),
        "every row has a token": bool((mask.sum(-1) >= 1).all()),
        "flash launched": launches["flash_fwd"] > 0,
        "decode launched": launches["decode_attention"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main-path checks failed: {failed}")

    def entry(name, source, replaces, cases, n_launch):
        main = cases[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launch, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "cases": cases,
        }

    print(json.dumps({"kernels": [
        entry("flash_fwd", "spatialthinker_torch/csrc/flash_attention.cu",
              "spatialthinker_tpu/ops/flash_attention.py:45", flash_cases, launches["flash_fwd"]),
        entry("decode_attention", "spatialthinker_torch/csrc/decode_attention.cu",
              "spatialthinker_tpu/ops/decode_attention.py:138", decode_cases,
              launches["decode_attention"]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
