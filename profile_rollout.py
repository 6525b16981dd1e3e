#!/usr/bin/env python3
"""Where the time of the port's rollout goes, on one NVIDIA GPU.

    python3 profile_rollout.py [--engine dense|paged]

``--engine dense`` (the default) builds the same 3B model, requests and
sampled call (n=5, T=1.0) as ``chip_smoke.py``, then times a 1-token call (prefill + fanout + first
sample) and a 17-token call (the same + 16 decode steps), first unprofiled
(two runs each) and then once each under ``torch.profiler``. Prints the
top device kernels of both profiled calls and, for the 16 decode steps
(difference of the two calls): the profiled wall time, device kernel time,
kernels per step and the busy share (device time / profiled wall), plus the
device time per step over the unprofiled wall per step as an estimate of the
busy share without the profiler's own host cost.

``--engine paged`` runs ``chip_smoke.py``'s shipped paged path (W8A8 weights,
int4 pools, int8 dots, 16 requests x 8 samples through 64 slots) and puts
``torch.profiler`` around ONE decode chunk of 16 steps (the third; the
second and fourth are timed unprofiled): top device kernels, kernels per
step, device time per step, busy share as profiled and device time over the
unprofiled wall per step. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import spatialthinker_torch.rollout.paged as paged_engine
from chip_smoke import MAX_NEW_TOKENS, PAGED, PAGED_REQUESTS, QUESTIONS, requests, smi_line
from spatialthinker_torch.eval.providers import TorchProvider
from spatialthinker_torch.models.qwen2_5_vl import init_params, qwen25_vl_3b
from spatialthinker_torch.ops.quant import quantize_model
from spatialthinker_torch.rollout.engine import generate
from spatialthinker_torch.rollout.sampling import SamplingParams
from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

N_SAMPLES = 5
DECODE_STEPS = 16
PROFILED_CHUNK = 2  # of the paged run's decode chunks (0 warms up; 1 and 3 are timed unprofiled)


def profile_paged_chunk(model, cfg, dev, card) -> None:
    qmodel = quantize_model(model, mode="int8")
    provider = TorchProvider(model, cfg, QwenSyntheticTokenizer(cfg), max_new_tokens=MAX_NEW_TOKENS,
                             max_prompt_length=1024, prompt_bucket=512)
    host = provider.prepare_host(*requests(PAGED_REQUESTS, seed=3))
    steps = PAGED["decode_chunk_size"]
    real = paged_engine.decode_chunk_paged
    walls, profiled = [], {}

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

    paged_engine.decode_chunk_paged = timed_chunk
    try:
        result = paged_engine.generate_paged(
            qmodel, host["input_ids"], host["segment_ids"], host["position_ids"], host["gen_pos_start"],
            max_new_tokens=MAX_NEW_TOKENS, sampling=SamplingParams(temperature=1.0),
            generator=torch.Generator(device=dev).manual_seed(2), kv_cache_dtype=torch.uint8,
            int4_i8dot=True, patches_list=host["patches_list"], grids_list=host["grids_list"], **PAGED,
        )
    finally:
        paged_engine.decode_chunk_paged = real
    prof = profiled["prof"]
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_s = sum(e.device_time for e in kernels) / 1e6
    wall = walls[PROFILED_CHUNK]
    unprof = statistics.median([walls[PROFILED_CHUNK - 1], walls[PROFILED_CHUNK + 1]])
    print(f"paged run: stats {result.stats}; chunk walls s {[round(w, 4) for w in walls]}", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=18,
                                    max_name_column_width=60), flush=True)
    print(f"paged decode chunk of {steps} steps at {PAGED['slots']} slots: profiled wall {wall:.4f} s, "
          f"device {device_s:.4f} s, busy share {device_s / wall:.3f}, kernels per step "
          f"{len(kernels) / steps:.0f}; per step: device {device_s / steps * 1e3:.3f} ms, unprofiled wall "
          f"{unprof / steps * 1e3:.3f} ms, device / unprofiled wall {device_s / unprof:.3f}  [{card}]",
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--engine", choices=("dense", "paged"), default="dense")
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
        profile_paged_chunk(model, cfg, dev, card)
        return 0
    provider = TorchProvider(model, cfg, QwenSyntheticTokenizer(cfg), max_new_tokens=MAX_NEW_TOKENS,
                             max_prompt_length=1024, prompt_bucket=512)
    prep = provider.prepare(*requests(len(QUESTIONS)))
    sampling = SamplingParams(temperature=1.0, top_p=1.0, top_k=-1, n=N_SAMPLES)
    gen = torch.Generator(device=dev).manual_seed(1)

    def call(tokens: int) -> float:
        t0 = time.perf_counter()
        generate(model, **prep, max_new_tokens=tokens, sampling=sampling, generator=gen, n=N_SAMPLES)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call(8)  # warm-up: kernel loads, allocator
    short, long = 1, 1 + DECODE_STEPS
    walls = {short: [], long: []}
    for tokens in (short, long, short, long):
        walls[tokens].append(call(tokens))
    print(f"unprofiled wall s: {walls}  [{card}]", flush=True)

    prof_res = {}
    for tokens in (short, long):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = call(tokens)
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        device_s = sum(e.device_time for e in kernels) / 1e6
        prof_res[tokens] = (wall, device_s, len(kernels))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
