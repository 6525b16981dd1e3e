#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``spatialthinker_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, nvcc and triton; exits non-zero without a device. In order:

1. prints the card's ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``spatialthinker_torch/csrc`` (prints seconds);
3. holds every kernel against its plain PyTorch version on the card at the
   shapes the paths below give it (max abs error against a stated limit,
   median CUDA-event times of both), computes each kernel's bound (the least
   time the card could take: bytes over the memory rate or operations over
   the peak rate, whichever is larger) and, for the flash and dense-decode
   kernels, times ``F.scaled_dot_product_attention`` with the equivalent
   mask as a yardstick (used nowhere in the port);
4. drives three paths at full Qwen2.5-VL-3B width with seeded random weights
   made on the device, each with the kernels' launch counts set to 0 just
   before and read just after, and with the plain versions forbidden:
   a. the dense engine (bf16): 4 image requests through
      ``TorchProvider.generate`` (greedy), then a sampled n=5 call;
   b. the shipped paged engine: ``quantize_model`` (W8A8), then
      ``generate_paged`` on 16 image requests x ``group_n`` 8 with int4 pools,
      ``int4_i8dot``, rows-mode + sequence-chunked prefill, shared prompt
      pages, a finite page pool and fewer slots than lanes (sampled, T=1);
   c. the paged engine with bf16 weights and bf16 pools (greedy);
5. checks what came out: finite log-probs <= 0 of the expected shapes; the
   kernel-path prefill logits as close to an fp32 reference as the plain
   path's; the int4 path's rollout log-probs against the bf16 model's
   teacher-forced log-probs of the same tokens (the reference's
   ``rollout/probs_diff``) and its greedy first tokens against the dense
   engine's; the bf16-pool paged path against the dense engine (equal first
   tokens, and no further from the teacher-forced bf16 model than the dense
   engine is, see ``ENGINE_DRIFT_RATIO``);
6. prints one JSON line of kernel results, the nvidia-smi line, and last
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
import torch.nn.functional as F

import spatialthinker_torch.ops.decode_attention as da
import spatialthinker_torch.ops.flash_attention as fa
import spatialthinker_torch.ops.paged_attention as pa
import spatialthinker_torch.ops.silu_quant as sq
from spatialthinker_torch import csrc
from spatialthinker_torch.eval.providers import TorchProvider
from spatialthinker_torch.models.qwen2_5_vl import (
    forward, init_params, logits_from_hidden, prefill_forward, qwen25_vl_3b, window_patch_len,
)
from spatialthinker_torch.models.qwen2_5_vl.text import KVCache
from spatialthinker_torch.ops.quant import quantize_model
from spatialthinker_torch.rollout.engine import generate
from spatialthinker_torch.rollout.paged import effective_prefill_chunk, generate_paged
from spatialthinker_torch.rollout.sampling import SamplingParams
from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

# bf16 kernel vs fp32-softmax plain version on the same bf16 inputs: both
# accumulate in fp32 and round the softmax weights and the output to bf16 at
# different points — a few bf16 ulps of an O(1) output.
OUT_ATOL = 3e-2
LSE_ATOL = 5e-3  # fp32 logsumexp, fast-math exp/log in the kernel
# Paged kernels repeat their plain versions' arithmetic page by page: stats
# within 2e-3; outputs of quantized pools are O(0.3) and an int8 softmax
# weight on a rounding tie may flip by one step (1/127 of its row max).
PAGED_STAT_ATOL = 2e-3
PAGED_OUT_ATOL = {"bf16": 3e-2, "int8": 1e-2, "int4_i8": 1e-2}
# silu -> int8: values at most one step apart (ties), scales 1e-5 relative
SILU_SCALE_RTOL = 1e-5
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


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    """Least milliseconds the card could take: every input read once and
    every output written once at the memory rate, or the operations at the
    peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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


PLAIN_VERSIONS = [
    (fa, "flash_fwd_plain"), (da, "decode_attention_plain"), (pa, "paged_attention_plain"),
    (pa, "paged_attention_int4_i8_plain"), (pa, "paged_attention_gathered"),
    (sq, "fused_silu_quantize_plain"),
]


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
    for fn in (fa.flash_fwd, da.decode_attention, pa._launch_pool_kernel,
               pa._launch_int4_i8_kernel, sq.fused_silu_quantize):
        fn.launches = 0


def read_counts() -> dict:
    return {
        "flash_fwd": fa.flash_fwd.launches, "decode_attention": da.decode_attention.launches,
        "paged_attention_pool": pa._launch_pool_kernel.launches,
        "paged_attention_int4_i8": pa._launch_int4_i8_kernel.launches,
        "silu_quant": sq.fused_silu_quantize.launches,
    }


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
    256 queries against the 512-cell prefix)."""
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
    results = []
    for name, (bb, sq_len, hq, hkv, d), q_seg, kv_seg, causal, off, skv in cases:
        q, k, v = (randn_bf16(rng, dev, bb, s, h, d) for s, h in ((sq_len, hq), (skv, hkv), (skv, hkv)))
        kw = dict(causal=causal, scale=d**-0.5, causal_offset=off)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, q_seg, kv_seg, **kw)
        o, lse = fa.flash_fwd(q, k, v, q_seg, kv_seg, **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        dead_ok = bool(torch.all(o[q_seg == 0] == 0))
        plain_ms = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, q_seg, kv_seg, **kw), iters=10)
        ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, q_seg, kv_seg, **kw))
        # the one PyTorch call for the same function: SDPA with the equivalent mask
        mask = fa.make_attention_mask(q_seg, kv_seg, causal, off)[:, None]
        pairs = int(mask.sum())
        g = hq // hkv
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                      (q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=d**-0.5),
                         iters=10)
        b_ms, b_by = bound_ms(nbytes(q, k, v, o, lse, q_seg, kv_seg), 4.0 * pairs * hq * d, "bf16")
        print(f"flash {name}: q{tuple(q.shape)} kv{tuple(k.shape)} causal={causal} offset={off} "
              f"max_abs_err={err:.3e} lse_err={lse_err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})", flush=True)
        if not (err <= OUT_ATOL and lse_err <= LSE_ATOL and dead_ok):
            raise AssertionError(f"flash kernel disagrees with plain on {name}")
        results.append(dict(shape=name, max_abs_err=err, lse_err=lse_err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        del q, k, v, o, lse, o_ref, lse_ref, mask, qt, kt, vt
        torch.cuda.empty_cache()
    return results


def check_decode(dev, cfg, rows: int, width: int, prompt_len: int):
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
    print(f"decode: q{tuple(q.shape)} cache{tuple(kc.shape)} layer={layer} max_abs_err={err:.3e} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})",
          flush=True)
    if not err <= OUT_ATOL:
        raise AssertionError("decode kernel disagrees with plain")
    return [dict(shape="sampled_call_cache", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)]


def check_paged(dev, cfg, kind: str, lanes: int, prompt_len: int, page: int, n_pages: int):
    """A paged kernel vs its plain version at the paged path's shapes: every
    lane of the engine (the trash lane has length 0) mid-generation, pages
    scattered over a pool of the path's size, the last layer."""
    rng = np.random.default_rng({"bf16": 3, "int8": 4, "int4_i8": 5}[kind])
    tc = cfg.text
    hq, hkv, d, n_layers = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim, tc.num_hidden_layers
    lengths = rng.integers(prompt_len - 90, prompt_len + MAX_NEW_TOKENS - 16, size=lanes)
    lengths[-1] = 0
    per_slot = -(-(prompt_len + MAX_NEW_TOKENS) // page) + 1
    table = np.zeros((lanes, per_slot), np.int32)
    for i, ell in enumerate(lengths):
        n = -(-int(ell) // page)
        table[i, :n] = rng.choice(np.arange(1, n_pages), size=n, replace=False)
    rows = page // 2 if kind == "int4_i8" else page
    shape = (n_layers, n_pages, hkv, rows, d)
    scales = (None, None)
    if kind == "bf16":
        k, v = randn_bf16(rng, dev, *shape), randn_bf16(rng, dev, *shape)
    else:
        dtype, lo, hi = (torch.uint8, 0, 256) if kind == "int4_i8" else (torch.int8, -127, 128)
        gen = torch.Generator(device=dev).manual_seed(7)
        k = torch.randint(lo, hi, shape, dtype=dtype, device=dev, generator=gen)
        v = torch.randint(lo, hi, shape, dtype=dtype, device=dev, generator=gen)
        s_lo, s_hi = (0.01, 0.1) if kind == "int4_i8" else (0.001, 0.02)
        scales = tuple(
            (torch.rand(shape[:3] + (page,), device=dev, generator=gen) * (s_hi - s_lo) + s_lo).to(torch.bfloat16)
            for _ in range(2)
        )
    q = randn_bf16(rng, dev, lanes, hq, d)
    layer = n_layers - 1
    args = (q, k, v, torch.from_numpy(table).to(dev), torch.from_numpy(lengths.astype(np.int32)).to(dev),
            layer, *scales)
    i8 = kind == "int4_i8"
    plain = pa.paged_attention_int4_i8_plain if i8 else pa.paged_attention_plain
    scale = d**-0.5
    o_ref, m_ref, l_ref = plain(*args, scale)
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=i8)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    stat_err = max((m - m_ref).abs().max().item(), ((l - l_ref).abs() / (1 + l_ref.abs())).max().item())
    dead_ok = bool(torch.all(o[-1] == 0) and torch.all(l[-1] == 0))
    plain_ms = cuda_ms(lambda: plain(*args, scale), iters=10)
    ms = cuda_ms(lambda: pa.paged_attention(*args, return_stats=True, int4_i8dot=i8))
    cells = int(lengths.sum())
    value_bytes = {"bf16": 2.0, "int8": 1.0, "int4_i8": 0.5}[kind]
    cell_bytes = 2 * hkv * (d * value_bytes + (0 if kind == "bf16" else 2))  # k and v (+ scales)
    b_ms, b_by = bound_ms(cells * cell_bytes + nbytes(q, o, m, l, args[3], args[4]),
                          4.0 * cells * hq * d, "int8" if i8 else "bf16")
    print(f"paged {kind}: q{tuple(q.shape)} pool{tuple(k.shape)} page={page} cells={cells} layer={layer} "
          f"max_abs_err={err:.3e} stat_err={stat_err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
    if not (err <= PAGED_OUT_ATOL[kind] and stat_err <= PAGED_STAT_ATOL and dead_ok):
        raise AssertionError(f"paged kernel ({kind}) disagrees with plain")
    return dict(shape=f"{kind}_pools_{lanes}_lanes", max_abs_err=err, stat_err=stat_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_silu(dev, cfg, m: int):
    """silu -> int8 junction kernel vs plain at the prefill's (rows x chunk, 2I)."""
    rng = np.random.default_rng(6)
    inter = cfg.text.intermediate_size
    gu = randn_bf16(rng, dev, m, 2 * inter)
    q_ref, s_ref = sq.fused_silu_quantize_plain(gu)
    q, s = sq.fused_silu_quantize(gu)
    torch.cuda.synchronize()
    diff = (q.int() - q_ref.int()).abs()
    err = float(diff.max())
    flips = float((diff != 0).float().mean())
    scale_err = ((s - s_ref).abs() / s_ref).max().item()
    plain_ms = cuda_ms(lambda: sq.fused_silu_quantize_plain(gu), iters=10)
    ms = cuda_ms(lambda: sq.fused_silu_quantize(gu))
    b_ms, b_by = bound_ms(nbytes(gu, q, s), 12.0 * m * inter, "fp32")
    print(f"silu_quant: gu{tuple(gu.shape)} max_abs_err={err:.0f} (int8 steps) differing={flips:.2e} "
          f"scale_rel_err={scale_err:.2e} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by})",
          flush=True)
    if not (err <= 1 and flips < 1e-2 and scale_err <= SILU_SCALE_RTOL):
        raise AssertionError("silu_quant kernel disagrees with plain")
    return [dict(shape=f"prefill_rows_{m}", max_abs_err=err, differing=flips, scale_rel_err=scale_err,
                 ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(card, flush=True)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    csrc.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({csrc.library_path().name})", flush=True)

    cfg = qwen25_vl_3b()
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
    flash_cases = check_flash(dev, prep, cfg)
    n_samp = 5
    width = -(-(p + MAX_NEW_TOKENS) // 128) * 128
    decode_cases = check_decode(dev, cfg, len(prompts) * n_samp, width, p)
    lanes = PAGED["slots"] + 1
    page, n_pages = PAGED["page_size"], PAGED["total_pages"]
    int4_cases = [check_paged(dev, cfg, "int4_i8", lanes, p, page, n_pages)]
    pool_cases = [check_paged(dev, cfg, "bf16", PAGED_REQUESTS + 1, p, page, n_pages),
                  check_paged(dev, cfg, "int8", lanes, p, page, n_pages)]
    rows_chunk = effective_prefill_chunk(p, PAGED["prefill_rows"], 0, PAGED["max_num_batched_tokens"])
    silu_cases = check_silu(dev, cfg, PAGED["prefill_rows"] * (rows_chunk or p))
    torch.cuda.empty_cache()

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
        "flash launched": dense_launches["flash_fwd"] > 0,
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
    chunk = effective_prefill_chunk(p16, PAGED["prefill_rows"], 0, PAGED["max_num_batched_tokens"])
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
        "flash launched": paged_launches["flash_fwd"] > 0,
        "int4 paged kernel launched": paged_launches["paged_attention_int4_i8"] > 0,
        "silu junction launched": paged_launches["silu_quant"] > 0,
        "no dense decode kernel": paged_launches["decode_attention"] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"paged-path checks failed: {failed}")

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
    if not (bf16_launches["paged_attention_pool"] > 0 and bf16_launches["flash_fwd"] > 0):
        raise AssertionError("the bf16-pool path did not launch its kernels")

    def entry(name, route, source, replaces, cases, n_launch, **extra):
        main_case = cases[0]
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": n_launch, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "cases": cases, **extra,
        }

    print(json.dumps({"kernels": [
        entry("flash_fwd", "cuda", "spatialthinker_torch/csrc/flash_attention.cu",
              "spatialthinker_tpu/ops/flash_attention.py:45", flash_cases, paged_launches["flash_fwd"],
              launches_dense_path=dense_launches["flash_fwd"],
              launches_bf16_pool_path=bf16_launches["flash_fwd"]),
        entry("decode_attention", "cuda", "spatialthinker_torch/csrc/decode_attention.cu",
              "spatialthinker_tpu/ops/decode_attention.py:138", decode_cases,
              dense_launches["decode_attention"]),
        entry("paged_attention_pool", "cuda", "spatialthinker_torch/csrc/paged_attention.cu",
              "spatialthinker_tpu/ops/paged_attention.py:113", pool_cases,
              bf16_launches["paged_attention_pool"]),
        entry("paged_attention_int4_i8", "cuda", "spatialthinker_torch/csrc/paged_attention.cu",
              "spatialthinker_tpu/ops/paged_attention.py:338", int4_cases,
              paged_launches["paged_attention_int4_i8"]),
        entry("silu_quant", "triton", "spatialthinker_torch/ops/silu_quant.py",
              "spatialthinker_tpu/ops/int8_matmul.py:128", silu_cases, paged_launches["silu_quant"]),
    ], "paths": {
        "dense": {"decode_tok_s": decode_tok_s, "prefill_s": prefill_s, "peak_gb": peak_gb},
        "paged_int4": {"decode_tok_s": decode_tok_s_paged, "prefill_s": st["refill_s"],
                       "peak_gb": paged_peak_gb, "probs_diff": probs_diff,
                       "first_token_agreement": first_agree, "stats": st},
        "paged_bf16": {"rows_equal_dense": rows_equal, "drift": drift_paged, "dense_drift": drift_dense,
                       "seconds": bf16_s},
    }, "seconds": time.perf_counter() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
