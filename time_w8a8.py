#!/usr/bin/env python3
"""Time kernel A, the fused W8A8 matmul, of a ``spatialthinker_torch`` tree on one NVIDIA GPU.

    python3 time_w8a8.py [--tree DIR] [--label NAME] [--sweep] [--ms 65,129,136,1024,4096] [--host-breakdown]

With seeded random inputs (x bf16 N(0, 1), int8 weights uniform in
[-127, 127], fp32 scales) at the five linears of the 3B preset (qkv, o,
gate_up, down: bf16 out; the tied head: fp32 out) and m in (65, 129, 136,
1024, 4096) (the head at the decode m's 65, 129 and 136 only). Each call
reads the next of enough weight copies to exceed the 50 MB L2 twice over,
as a decode step's 36 layers do. Prints one JSON line per case: the median
CUDA-event ms of one call (``fused_w8a8_matmul``: prologue and GEMM; at
decode m the host's launch time shows in it), the profiler's device µs of a
call (every kernel the call launched) and its split into the GEMM and the
quantize prologue, the µs of a call among 20 queued back to back behind a
sleeping kernel (device time with the gaps between launches, as in a decode
step), the GEMM alone on rows quantized beforehand
(``w8a8_matmul_prequantized``), the same of ``torch._int_mm`` alone on the
pre-quantized x (a yardstick: no quantize, no epilogue), the bound (x, w, scales read once and the output written once at
3.35 TB/s, or 2 m N K operations at 1,979 int8 TOPS, whichever is larger),
the plan where the tree has ``w8a8_plan``, and the card. At m = 65 also the
host µs of a call: 200 calls enqueued back to back, the host clock around the
enqueueing (no synchronisation inside) over 200, beside the wall per call after a
synchronisation, the least of five runs.

``--tree DIR`` imports the package from another checkout (an unpacked
``git archive`` of a parent commit), so two trees are compared in one run on
one card: run parent, change, change, parent. ``--host-breakdown`` prints
only the host µs of the wrapper's pieces at the 3B qkv, m = 65. ``--sweep`` (this tree's plan
only) times other plans at the decode and prefill shapes (queued µs, the
best of two), the columns per CTA, the splits and the ring depth, and the
decode regime against the prefill one at m = 128 to 256. Exits 2 without a
card.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
L2_BYTES = 50e6


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=None, help="checkout whose spatialthinker_torch is timed")
    parser.add_argument("--label", default="tree")
    parser.add_argument("--sweep", action="store_true", help="time other plans of this tree too")
    parser.add_argument("--ms", default="65,129,136,1024,4096", help="rows m, comma-separated")
    parser.add_argument("--host-breakdown", action="store_true",
                        help="only the host µs of the wrapper's pieces at the 3B qkv, m = 65")
    args = parser.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from spatialthinker_torch.models.qwen2_5_vl.config import qwen25_vl_3b
    from spatialthinker_torch.ops import int8_matmul as i8m

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def cuda_ms(fn, iters=20, warmup=3):
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

    def device_us(fn, calls=20, split=False):
        """Profiler device µs of a call; with ``split`` also (GEMM, prologue)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        total = sum(e.device_time for e in kernels) / calls
        if not split:
            return total
        prologue = sum(e.device_time for e in kernels if "quantize_rows" in e.name) / calls
        return total, total - prologue, prologue

    def queued_us(fn, calls=20):
        """µs of a call among ``calls`` queued behind a sleeping kernel: the
        host's launch time hides behind the sleep, the gaps between launches
        stay."""
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

    def host_us(fn, calls=200, repeats=5):
        """(enqueue µs, wall µs) of a call: the host clock around ``calls``
        calls enqueued back to back, before and after a synchronisation; the
        least of ``repeats`` runs."""
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            runs.append(((t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6))
        return min(runs)

    if args.host_breakdown:
        print(json.dumps(dict(host_breakdown(i8m, torch, dev), label=args.label, card=card)), flush=True)
        return 0

    tc = qwen25_vl_3b().text
    hd = tc.head_dim
    linears = {  # name: (K, N, output dtype)
        "qkv": (tc.hidden_size, (tc.num_attention_heads + 2 * tc.num_key_value_heads) * hd, torch.bfloat16),
        "o": (tc.num_attention_heads * hd, tc.hidden_size, torch.bfloat16),
        "gate_up": (tc.hidden_size, 2 * tc.intermediate_size, torch.bfloat16),
        "down": (tc.intermediate_size, tc.hidden_size, torch.bfloat16),
        "head": (tc.hidden_size, tc.vocab_size, torch.float32),
    }
    ms_list = tuple(int(v) for v in args.ms.split(","))
    has_plan = hasattr(i8m, "w8a8_plan")

    for name, (k, n, out_dtype) in linears.items():
        copies = max(1, min(24, math.ceil(2 * L2_BYTES / (n * k))))
        ws_list = [torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
                   for _ in range(copies)]
        scales = torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-4
        for m in ms_list:
            if name == "head" and m > 256:
                continue
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            xq, _ = i8m.quantize_rows(x)
            turn = [0]

            def call():
                w = ws_list[turn[0] % copies]
                turn[0] += 1
                return i8m.fused_w8a8_matmul(x, w, scales, out_dtype)

            def int_mm():
                w = ws_list[turn[0] % copies]
                turn[0] += 1
                return i8m.int8_matmul(xq, w.t())

            xq_k, xs_k = i8m.quantize_rows(x)

            def prequantized():
                w = ws_list[turn[0] % copies]
                turn[0] += 1
                return i8m.w8a8_matmul_prequantized(xq_k, xs_k, w, scales, out_dtype)

            out = call()
            ref = i8m.fused_w8a8_matmul_plain(x, ws_list[0], scales, out_dtype)
            turn[0] = 0
            out = call()
            torch.cuda.synchronize()
            n_bytes = x.numel() * 2 + n * k + n * 4 + out.numel() * out.element_size()
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2.0 * m * n * k / INT8_OPS_PER_S
            dev_us, gemm_us, prologue_us = device_us(call, split=True)
            result = {"label": args.label, "linear": name, "m": m, "n": n, "k": k, "out": str(out_dtype)[6:],
                      "weight_copies": copies, "bit_equal": bool(torch.equal(out, ref)),
                      "ms": cuda_ms(call), "device_us": dev_us, "gemm_us": gemm_us, "prologue_us": prologue_us,
                      "queued_us": queued_us(call), "prequantized_device_us": device_us(prequantized),
                      "int_mm_ms": cuda_ms(int_mm), "int_mm_device_us": device_us(int_mm),
                      "int_mm_queued_us": queued_us(int_mm),
                      "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            if m == 65:
                result["host_us"], result["wall_us"] = host_us(call)
            if has_plan:
                result["plan"] = i8m.w8a8_plan(m, n, k).describe()
            result["card"] = card
            print(json.dumps(result), flush=True)
            if args.sweep and has_plan:
                sweep(i8m, queued_us, call, args.label, name, m, n, k, card)
            del x, xq, xq_k, xs_k, out, ref
        del ws_list
        torch.cuda.empty_cache()
    return 0


def host_breakdown(i8m, torch, dev) -> dict:
    """Host µs of a kernel A call at the 3B qkv, m = 65, and of its pieces
    (each the least of 5 loops of 200 calls): the input checks, one
    ``torch.empty``, the device context and the stream object the wrapper of
    the first design entered and read on every call, the raw stream handle,
    and, where the tree has a plan, the plan lookup and the C call alone with
    and without the prologue (two launches and one)."""
    k, n, m = 2048, 2560, 65
    x = torch.randn((m, k), device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8)
    ws = torch.rand((n,), device=dev) * 1e-3

    def host(fn, calls=200, repeats=5):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return best

    out = {
        "whole_call_us": host(lambda: i8m.fused_w8a8_matmul(x, w, ws)),
        "checks_us": host(lambda: i8m._check_cuda_inputs(x, w, ws, torch.bfloat16, (torch.bfloat16, torch.float32))),
        "one_empty_us": host(lambda: torch.empty((m, n), dtype=torch.bfloat16, device=dev)),
        "device_context_us": host(lambda: torch.cuda.device(dev).__enter__()),
        "stream_object_us": host(lambda: torch.cuda.current_stream().cuda_stream),
        "raw_stream_us": host(lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
    }
    if hasattr(i8m, "w8a8_plan"):
        from spatialthinker_torch import csrc

        plan = i8m.w8a8_plan(m, n, k)
        scratch = torch.empty((m * k + 4 * m,), dtype=torch.uint8, device=dev)
        dst = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        lib = csrc.library()
        args = [x.data_ptr(), 0, scratch.data_ptr(), scratch.data_ptr() + m * k, w.data_ptr(), ws.data_ptr(),
                dst.data_ptr(), 0, m, n, k, 1, plan.mb, plan.bn, plan.splits, plan.stages, i8m._stream(dev)]
        out["plan_us"] = host(lambda: i8m.w8a8_plan(m, n, k))
        out["c_call_us"] = host(lambda: lib.st_int8_matmul(*args))
        args[11] = 0
        out["c_call_no_prologue_us"] = host(lambda: lib.st_int8_matmul(*args))
    return out


def sweep(i8m, queued_us, call, label, name, m, n, k, card) -> None:
    """Other plans of this tree at one shape: columns per CTA, splits, ring
    depth; at m of 128 to 256 also the prefill regime (128-row tiles)."""
    real = i8m.w8a8_plan
    steps = -(-k // i8m.K_STEP)
    candidates = []
    regimes = ["decode", "prefill"] if 128 <= m <= 256 else [None]
    for regime in regimes:
        for bn in (64, 128, 256):
            for splits in (1, 2, 4, 8):
                if splits > steps or (splits > 1 and m > 256 and regime != "decode"):
                    continue
                for stages in (None, 2, 4, 6, 8):
                    try:
                        plan = real(m, n, k, bn=bn, splits=splits, stages=stages, regime=regime)
                    except ValueError:
                        continue
                    if plan not in candidates:
                        candidates.append(plan)
    chosen = real(m, n, k)
    rows = []
    try:
        for plan in candidates:
            i8m.w8a8_plan = lambda *a, _p=plan, **kw: _p
            rows.append((min(queued_us(call) for _ in range(2)), plan))
    finally:
        i8m.w8a8_plan = real
    rows.sort(key=lambda r: r[0])
    for us, plan in rows[:6]:
        print(json.dumps({"label": label, "sweep": name, "m": m, "queued_us": us, "chosen": plan == chosen,
                          "plan": plan.describe(), "card": card}), flush=True)
    chosen_us = next((us for us, plan in rows if plan == chosen), None)
    print(json.dumps({"label": label, "sweep": name, "m": m, "chosen_queued_us": chosen_us,
                      "best_queued_us": rows[0][0], "candidates": len(rows), "card": card}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
