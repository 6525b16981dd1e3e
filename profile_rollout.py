#!/usr/bin/env python3
"""Where the time of the port's sampled rollout call goes, on one NVIDIA GPU.

    python3 profile_rollout.py

Builds the same 3B model, requests and sampled call (n=5, T=1.0) as
``chip_smoke.py``, then times a 1-token call (prefill + fanout + first
sample) and a 17-token call (the same + 16 decode steps), first unprofiled
(two runs each) and then once each under ``torch.profiler``. Prints the
top device kernels of both profiled calls and, for the 16 decode steps
(difference of the two calls): the profiled wall time, device kernel time,
kernels per step and the busy share (device time / profiled wall), plus the
device time per step over the unprofiled wall per step as an estimate of the
busy share without the profiler's own host cost. Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import MAX_NEW_TOKENS, requests, smi_line
from spatialthinker_torch.eval.providers import TorchProvider
from spatialthinker_torch.models.qwen2_5_vl import init_params, qwen25_vl_3b
from spatialthinker_torch.rollout.engine import generate
from spatialthinker_torch.rollout.sampling import SamplingParams
from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

N_SAMPLES = 5
DECODE_STEPS = 16


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_rollout: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(card, flush=True)
    cfg = qwen25_vl_3b()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    provider = TorchProvider(model, cfg, QwenSyntheticTokenizer(cfg), max_new_tokens=MAX_NEW_TOKENS,
                             max_prompt_length=1024, prompt_bucket=512)
    prep = provider.prepare(*requests())
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
