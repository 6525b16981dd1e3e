#!/usr/bin/env python3
"""Time the dense decode kernels of a ``spatialthinker_torch`` tree on one NVIDIA GPU: #4 (bf16 and
int8-scale modes), #5 (int4, dots on the widened nibbles) and #6 (int4, int8 dots).

    python3 time_decode.py [--tree DIR] [--label NAME] [--sweep] [--only NAME ...]

Eight shapes, seeded, the 3B preset's 16 query heads over 2 kv heads, D 128:

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
- ``dense_int4`` (#5) and ``dense_int4_i8`` (#6): the int4 cache as
  ``check_decode_quant`` draws it: 128 rows, (36, 128, 2, 384, 128) uint8
  (width 768, three blocks of 128 byte rows) with bf16 scales in [0.01, 0.1],
  each row valid from a pad in [0, 120) to cell 544, the last row empty; each
  call the next layer.
- ``path_g`` (#6): the continuous engine's int4 slot cache at path (g)'s
  recorded call: 136 lanes, width 768, 128 lanes each with a left-padded
  prompt of 320 to 512 cells and 32 generated cells, 8 lanes empty; each call
  the next of 36 layers.
- ``shipped_int4`` (#6): ``rollout.name=jax`` with the int4 cache at the
  64-lane cap: width 8,192 (16 blocks of 256 byte rows), each row's first
  6,144 + r cells valid, r uniform in [0, 2,048]; two layers alternated.

One JSON line per shape: the median CUDA-event ms of one call (host launch
time included), the profiler's device µs of a call, the µs of a call among
20 queued back to back behind a sleeping kernel (device time with the gaps
between launches), the host µs of a call (200 calls enqueued back to back,
least of five runs), the byte bound (each VALID cell's K and V (and scales)
read once, q, kv_seg and the output once, at 3.35 TB/s), the plan where the
tree's ``decode_plan`` takes the mode, SDPA's device µs in the same call
(``F.scaled_dot_product_attention`` on the layer with K and V repeated to
the 16 query heads and the validity mask; for the quantized caches on the
dequantized bf16 cache; a yardstick, used nowhere in the port), the device's
SM count and the card.

``--tree DIR`` imports the package from another checkout (an unpacked
``git archive`` of a parent commit), so two trees are compared in one run on
one card: run parent, change, change, parent. This tree only: ``--sweep``
also times other plans (cluster sizes up to the stripe's tiles or blocks,
ring depths). ``--only`` times the named shapes alone. Exits 2 without a card.
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


def _int4_cache(torch, dev, rows, width, layers, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (layers, rows, HKV, width // 2, D)
    k = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    v = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    ks, vs = ((torch.rand((layers, rows, HKV, width), device=dev, generator=gen) * 0.09 + 0.01)
              .to(torch.bfloat16) for _ in range(2))
    return k, v, ks, vs


def make_cases(torch, np, dev, only=None) -> dict:
    """The eight shapes (or those named in ``only``): dict name -> (q, k, v,
    kv_seg, ks, vs, mode)."""
    def bf16(rng, *shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)

    cases = {}
    want = lambda name: only is None or name in only  # noqa: E731
    rng = np.random.default_rng(2)  # check_decode's draw
    kc, vc = bf16(rng, 36, 20, HKV, 640, D), bf16(rng, 36, 20, HKV, 640, D)
    q = bf16(rng, 20, HQ, D)
    seg = np.zeros((20, 640), np.int32)
    seg[:, :544] = 1
    seg[0, :100] = 0
    cases["path_a"] = (q, kc, vc, torch.from_numpy(seg).to(dev), None, None, 0)

    rng = np.random.default_rng(21)
    kc, vc = bf16(rng, 2, 64, HKV, 8192, D), bf16(rng, 2, 64, HKV, 8192, D)
    seg = np.zeros((64, 8192), np.int32)
    for i, r in enumerate(rng.integers(0, 2049, size=64)):
        seg[i, : 6144 + r] = 1
    cases["shipped_dense"] = (bf16(rng, 64, HQ, D), kc, vc, torch.from_numpy(seg).to(dev), None, None, 0)

    rng = np.random.default_rng(12)  # check_decode_quant's draw
    k, v, ks, vs = _int8_cache(torch, dev, 128, 640, 36, 15)
    q = bf16(rng, 128, HQ, D)
    seg = np.zeros((128, 640), np.int32)
    for i, pad in enumerate(rng.integers(0, 120, size=128)):
        seg[i, pad:544] = 1
    seg[-1] = 0
    cases["dense_int8"] = (q, k, v, torch.from_numpy(seg).to(dev), ks, vs, 1)

    rng = np.random.default_rng(31)
    k, v, ks, vs = _int8_cache(torch, dev, 72, 640, 36, 16)
    seg = np.zeros((72, 640), np.int32)
    for i, prompt in enumerate(rng.integers(320, 513, size=64)):
        seg[i, 512 - prompt: 512 + 32] = 1
    cases["continuous_int8"] = (bf16(rng, 72, HQ, D), k, v, torch.from_numpy(seg).to(dev), ks, vs, 1)

    for name, mode, seed in (("dense_int4", 2, 13), ("dense_int4_i8", 3, 14)):  # check_decode_quant's draws
        if not want(name):
            continue
        rng = np.random.default_rng(seed)
        k, v, ks, vs = _int4_cache(torch, dev, 128, 768, 36, 15)
        q = bf16(rng, 128, HQ, D)
        seg = np.zeros((128, 768), np.int32)
        for i, pad in enumerate(rng.integers(0, 120, size=128)):
            seg[i, pad:544] = 1
        seg[-1] = 0
        cases[name] = (q, k, v, torch.from_numpy(seg).to(dev), ks, vs, mode)

    if want("path_g"):
        rng = np.random.default_rng(41)
        k, v, ks, vs = _int4_cache(torch, dev, 136, 768, 36, 17)
        seg = np.zeros((136, 768), np.int32)
        for i, prompt in enumerate(rng.integers(320, 513, size=128)):
            seg[i, 512 - prompt: 512 + 32] = 1
        cases["path_g"] = (bf16(rng, 136, HQ, D), k, v, torch.from_numpy(seg).to(dev), ks, vs, 3)

    if want("shipped_int4"):
        rng = np.random.default_rng(42)
        k, v, ks, vs = _int4_cache(torch, dev, 64, 8192, 2, 18)
        seg = np.zeros((64, 8192), np.int32)
        for i, r in enumerate(rng.integers(0, 2049, size=64)):
            seg[i, : 6144 + r] = 1
        cases["shipped_int4"] = (bf16(rng, 64, HQ, D), k, v, torch.from_numpy(seg).to(dev), ks, vs, 3)
    return {name: case for name, case in cases.items() if want(name)}


def bound_bytes(case) -> int:
    """Bytes a call must move: each valid cell's K and V (and scales) once, q,
    kv_seg and the output once (an int4 value is half a byte)."""
    q, k, _, seg, ks, _, mode = case
    cells = int((seg != 0).sum())
    value = 0.5 if mode >= 2 else k.element_size()
    cell = 2 * HKV * (D * value + (2 if ks is not None else 0))
    return int(cells * cell) + 2 * q.numel() * q.element_size() + seg.numel() * 4


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=None, help="checkout whose spatialthinker_torch is timed")
    parser.add_argument("--label", default="tree")
    parser.add_argument("--sweep", action="store_true", help="time other plans of this tree too")
    parser.add_argument("--only", nargs="+", default=None, help="time these shapes alone")
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
    scale = D**-0.5

    def plan_of(case):
        """This tree's plan of the case, or None where its ``decode_plan``
        does not take the mode (an older tree)."""
        q, k, _, seg, _, _, mode = case
        planned = (0, 1, 2, 3) if hasattr(da, "BLOCK_TILES") else (0, 1) if hasattr(da, "decode_plan") else ()
        if mode not in planned:
            return None
        return da.decode_plan(q.shape[0], HKV, HQ // HKV, seg.shape[1], mode, sms=sms)

    def caller(case, plan=None):
        """A call of the kernel on the next layer of the cache each time."""
        q, k, v, seg, ks, vs, mode = case
        state = [0]
        launch = (da._launch_bf16_kernel, da._launch_int8_kernel, getattr(da, "_launch_int4_kernel", None),
                  getattr(da, "_launch_int4_i8_kernel", None))[mode]

        def call():
            layer = state[0] % k.shape[0]
            state[0] += 1
            if plan is None:
                return da.decode_attention(q, k, v, seg, layer, ks, vs, int4_i8dot=mode == 3)
            return launch(q, k, v, seg, layer, scale, ks, vs, plan=plan)
        return call

    def sdpa_us(case) -> float:
        q, k, v, seg, ks, vs, mode = case
        g = HQ // HKV

        def expand(cache, scales):
            vals = cache[0]
            if mode >= 2:  # int4: the stored nibbles minus the bias, low half then high half
                vals = torch.cat([(vals & 15).to(torch.int8) - 8, (vals >> 4).to(torch.int8) - 8], dim=2)
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

    for name, case in make_cases(torch, np, dev, args.only).items():
        q, k, _, seg, ks, _, mode = case
        plan = plan_of(case)
        n_bytes = bound_bytes(case)
        fn = caller(case)
        row = dict(label=args.label, shape=name, rows=q.shape[0], width=seg.shape[1], cells=int((seg != 0).sum()),
                   ms=cuda_ms(torch, fn), device_us=device_us(torch, fn), queued_us=queued_us(torch, fn),
                   host_us=host_us(torch, fn), bound_us=n_bytes / HBM_BYTES_PER_S * 1e6, bound_bytes=n_bytes,
                   sdpa_device_us=sdpa_us(case), plan=None if plan is None else plan.__dict__, sms=sms, card=card)
        print(json.dumps(row), flush=True)
        if args.sweep and plan is not None:
            tiles = -(-k.shape[3] // da.SPLIT_TILE)
            units = tiles if mode < 2 else -(-tiles // -(-plan.block_rows // da.SPLIT_TILE))
            least = -(-plan.block_rows // da.SPLIT_TILE) if mode == 3 else 2
            most = da.INT4_MAX_STAGES if mode == 3 else da.SPLIT_MAX_STAGES
            for cluster in range(1, min(da.SPLIT_MAX_CLUSTER, units) + 1):
                for stages in range(least, most + 1):
                    alt = da.decode_plan(q.shape[0], HKV, HQ // HKV, seg.shape[1], mode, sms=sms, cluster=cluster,
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
