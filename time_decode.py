#!/usr/bin/env python3
"""Time the dense decode kernel #4 (bf16 and int8-scale modes) of a ``spatialthinker_torch`` tree on one NVIDIA GPU.

    python3 time_decode.py [--tree DIR] [--label NAME] [--sweep]

Four shapes, seeded, the 3B preset's 16 query heads over 2 kv heads, D 128:

- ``path_a``: the dense path's sampled call as ``chip_smoke.py``'s
  ``check_decode`` draws it: 20 rows, cache (36, 20, 2, 640, 128) bf16, the
  prompt's 512 cells and 32 generated ones valid, row 0 left-padded by 100;
  each call reads the next layer.
- ``shipped_dense``: ``scripts/spatialthinker_3b_grpo.sh``'s exact-parity
  revert (``rollout.name=jax``, bf16 KV) at its cap of 64 lanes: width 8,192,
  each row's first 6,144 + r cells valid, r uniform in [0, 2,048]; two layers
  of 470 MB each, alternated.
- ``dense_int8``: the int8 cache as ``check_decode_quant`` draws it: 128 rows,
  (36, 128, 2, 640, 128) int8 with bf16 scales, each row valid from a pad in
  [0, 120) to cell 544, the last row empty; each call the next layer.
- ``continuous_int8``: the continuous engine's int8 slot cache at its
  recorded call's shape: 72 lanes, width 640, 64 lanes each with a
  left-padded prompt of 320 to 512 cells and 32 generated cells, 8 lanes
  empty (about 28.7k valid cells); each call the next of 36 layers.

One JSON line per shape: the median CUDA-event ms of one call (host launch
time included), the profiler's device µs of a call, the µs of a call among
20 queued back to back behind a sleeping kernel (device time with the gaps
between launches), the host µs of a call (200 calls enqueued back to back,
least of five runs), the byte bound (each VALID cell's K and V (and scales)
read once, q, kv_seg and the output once, at 3.35 TB/s), the plan where the
tree has ``decode_plan``, SDPA's device µs in the same call
(``F.scaled_dot_product_attention`` on the layer with K and V repeated to
the 16 query heads and the validity mask; for int8 on the dequantized bf16
cache; a yardstick, used nowhere in the port), the device's SM count and the
card.

``--tree DIR`` imports the package from another checkout (an unpacked
``git archive`` of a parent commit), so two trees are compared in one run on
one card: run parent, change, change, parent. This tree only: ``--sweep``
also times other plans (cluster sizes up to the stripe's tiles, ring depths).
Exits 2 without a card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

HQ, HKV, D = 16, 2, 128
HBM_BYTES_PER_S = 3.35e12


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters=50, warmup=5) -> float:
    """Median CUDA-event ms of one call (the host's launch time included)."""
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


def device_us(torch, fn, calls=20) -> float:
    """The profiler's device µs of a call (every kernel the call launches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return sum(e.device_time for e in kernels) / calls


def queued_us(torch, fn, calls=20) -> float:
    """µs of a call among ``calls`` queued back to back behind a sleeping kernel."""
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


def host_us(torch, fn, calls=200, repeats=5) -> float:
    """Host µs of a call: the least of ``repeats`` enqueue loops of ``calls``."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(runs)


def _int8_cache(torch, dev, rows, width, layers, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (layers, rows, HKV, width, D)
    k = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)
    v = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)
    ks, vs = ((torch.rand(shape[:4], device=dev, generator=gen) * 0.019 + 0.001).to(torch.bfloat16)
              for _ in range(2))
    return k, v, ks, vs


def make_cases(torch, np, dev) -> dict:
    """The four shapes: dict name -> (q, k, v, kv_seg, ks, vs)."""
    def bf16(rng, *shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)

    cases = {}
    rng = np.random.default_rng(2)  # check_decode's draw
    kc, vc = bf16(rng, 36, 20, HKV, 640, D), bf16(rng, 36, 20, HKV, 640, D)
    q = bf16(rng, 20, HQ, D)
    seg = np.zeros((20, 640), np.int32)
    seg[:, :544] = 1
    seg[0, :100] = 0
    cases["path_a"] = (q, kc, vc, torch.from_numpy(seg).to(dev), None, None)

    rng = np.random.default_rng(21)
    kc, vc = bf16(rng, 2, 64, HKV, 8192, D), bf16(rng, 2, 64, HKV, 8192, D)
    seg = np.zeros((64, 8192), np.int32)
    for i, r in enumerate(rng.integers(0, 2049, size=64)):
        seg[i, : 6144 + r] = 1
    cases["shipped_dense"] = (bf16(rng, 64, HQ, D), kc, vc, torch.from_numpy(seg).to(dev), None, None)

    rng = np.random.default_rng(12)  # check_decode_quant's draw
    k, v, ks, vs = _int8_cache(torch, dev, 128, 640, 36, 15)
    q = bf16(rng, 128, HQ, D)
    seg = np.zeros((128, 640), np.int32)
    for i, pad in enumerate(rng.integers(0, 120, size=128)):
        seg[i, pad:544] = 1
    seg[-1] = 0
    cases["dense_int8"] = (q, k, v, torch.from_numpy(seg).to(dev), ks, vs)

    rng = np.random.default_rng(31)
    k, v, ks, vs = _int8_cache(torch, dev, 72, 640, 36, 16)
    seg = np.zeros((72, 640), np.int32)
    for i, prompt in enumerate(rng.integers(320, 513, size=64)):
        seg[i, 512 - prompt: 512 + 32] = 1
    cases["continuous_int8"] = (bf16(rng, 72, HQ, D), k, v, torch.from_numpy(seg).to(dev), ks, vs)
    return cases


def bound_bytes(case) -> int:
    """Bytes a call must move: each valid cell's K and V (and scales) once, q,
    kv_seg and the output once."""
    q, k, _, seg, ks, _ = case
    cells = int((seg != 0).sum())
    cell = 2 * HKV * (D * k.element_size() + (2 if ks is not None else 0))
    return cells * cell + 2 * q.numel() * q.element_size() + seg.numel() * 4


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=None, help="checkout whose spatialthinker_torch is timed")
    parser.add_argument("--label", default="tree")
    parser.add_argument("--sweep", action="store_true", help="time other plans of this tree too")
    args = parser.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from spatialthinker_torch.ops import decode_attention as da

    card = smi_line()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    has_plan = hasattr(da, "decode_plan")
    scale = D**-0.5

    def caller(case, plan=None):
        """A call of the kernel on the next layer of the cache each time."""
        q, k, v, seg, ks, vs = case
        state = [0]

        def call():
            layer = state[0] % k.shape[0]
            state[0] += 1
            if plan is None:
                return da.decode_attention(q, k, v, seg, layer, ks, vs)
            launch = da._launch_bf16_kernel if ks is None else da._launch_int8_kernel
            return launch(q, k, v, seg, layer, scale, ks, vs, plan=plan)
        return call

    def sdpa_us(case) -> float:
        q, k, v, seg, ks, vs = case
        g = HQ // HKV

        def expand(cache, scales):
            vals = cache[0]
            if scales is not None:
                vals = (vals.float() * scales[0].float()[..., None]).to(torch.bfloat16)
            return vals.repeat_interleave(g, dim=1)

        kt, vt = expand(k, ks), expand(v, vs)
        mask = (seg != 0)[:, None, None, :]
        qt = q[:, :, None, :]
        us = device_us(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale))
        del kt, vt
        torch.cuda.empty_cache()
        return us

    for name, case in make_cases(torch, np, dev).items():
        q, k, _, seg, ks, _ = case
        mode = 0 if ks is None else 1
        plan = da.decode_plan(q.shape[0], HKV, HQ // HKV, k.shape[3], mode, sms=sms) if has_plan else None
        n_bytes = bound_bytes(case)
        fn = caller(case)
        row = dict(label=args.label, shape=name, rows=q.shape[0], width=k.shape[3], cells=int((seg != 0).sum()),
                   ms=cuda_ms(torch, fn), device_us=device_us(torch, fn), queued_us=queued_us(torch, fn),
                   host_us=host_us(torch, fn), bound_us=n_bytes / HBM_BYTES_PER_S * 1e6, bound_bytes=n_bytes,
                   sdpa_device_us=sdpa_us(case), plan=None if plan is None else plan.__dict__, sms=sms, card=card)
        print(json.dumps(row), flush=True)
        if args.sweep and has_plan:
            tiles = -(-k.shape[3] // da.SPLIT_TILE)
            for cluster in range(1, min(da.SPLIT_MAX_CLUSTER, tiles) + 1):
                for stages in range(2, da.SPLIT_MAX_STAGES + 1):
                    alt = da.decode_plan(q.shape[0], HKV, HQ // HKV, k.shape[3], mode, sms=sms, cluster=cluster,
                                         stages=stages)
                    alt_fn = caller(case, alt)
                    print(json.dumps(dict(label=args.label, shape=name, sweep=True, cluster=cluster, stages=stages,
                                          smem=alt.smem, queued_us=min(queued_us(torch, alt_fn) for _ in range(2)),
                                          device_us=device_us(torch, alt_fn), card=card)), flush=True)
        del case
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
