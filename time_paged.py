#!/usr/bin/env python3
"""Time a paged kernel of a ``spatialthinker_torch`` tree on one NVIDIA GPU.

    python3 time_paged.py [--mode {int4_i8,int4,int8,bf16}] [--tree DIR] [--label NAME] [--sweep]

``--mode`` picks the kernel: ``int4_i8`` (the default) the int4 kernel with
int8 dots (#9), ``int4`` the int4 kernel with the dots on the widened nibbles
(#8), ``int8`` and ``bf16`` the kernel of int8 and bf16 pools (#7), each on
``paged_cases.py``'s pools of its format over the same tables and lengths.
``int4_i8`` times five shapes, the other modes four: ``path_b``,
``path_c_17`` (path (c)'s decode batch: ``path_b``'s draw with 16 lanes +
the trash lane), ``path_b_ring`` and ``shipped``; a tree without the mode's
plan (``paged_plan`` with no ``mode``) is timed with its own launch and no
plan printed. The shapes, the inputs of ``paged_cases.py`` (seeded, the 3B
preset's 16 query heads over 2 kv heads):

- ``path_b``: the shipped paged path's decode call as ``chip_smoke.py``'s
  ``check_paged`` draws it: 65 lanes (the last the trash lane, length 0),
  page 256, lengths uniform in [422, 559], 36 layers; each call reads the
  next layer, so the pages come from memory as in a decode step.
- ``shipped``: the shipped scale, 128 lanes + the trash lane, page 1024,
  lengths uniform in [6144, 8192], 16 groups of 8 lanes sharing their prompt
  pages (a one-layer pool of 286 pages).
- ``path_b_ring``: ``path_b`` with a 16-cell staging ring (``staged=``), its
  first 8 cells live in every lane but the trash lane.
- ``path_b_17``, ``shipped_9``: small decode batches, where the (slot, kv
  head) pairs leave SMs idle and the plan splits a slot's pages over a
  cluster: ``path_b``'s draw with 16 lanes + the trash lane (a
  ``decode_batch_size`` of 16), and one group of 8 lanes + the trash lane at
  the shipped scale. This tree also times them under the plan with one rank
  (``cluster_1`` rows), the split's alternative.

One JSON line per shape: the median CUDA-event ms of one call (host launch
time included), the profiler's device µs of a call, the µs of a call among
20 queued back to back behind a sleeping kernel (device time with the gaps
between launches, as in a decode step), the host µs of a call (200 calls
enqueued back to back, the host clock around the enqueueing over 200, the
least of five runs), the byte bound (every live cell's K, V and scales read
once, at ``shipped`` a page shared by several lanes counted once, and the
outputs written once, at 3.35 TB/s; the operations, 4 a value and head, at
1,979 int8 TOPS or 989 bf16 TFLOPS take far less), the plan where the tree
has ``paged_plan`` for the mode, the device's SM count, and the card.

``--tree DIR`` imports the package from another checkout (an unpacked
``git archive`` of a parent commit), so two trees are compared in one run on
one card: run parent, change, change, parent. This tree only: ``--sweep``
also times other plans (every cluster size up to the table's pages, and the
ring depths that fit); ``--fixed-cost`` the device µs of ``path_b`` and
``shipped`` with every length 0 and with one page a slot (what a CTA costs
before and for its first page); ``--phases`` builds a copy of the kernel
with ``clock64`` stamps of each CTA's thread 0 after its prologue and each
page's phases (K landed, scores' row max exchanged, weights' max exchanged,
V landed, p . v done) and at its end, into ``csrc/build/phases/`` (the
package's own library stays unstamped), and prints the median µs since
the CTA's start of each stamp by a CTA's page count, at 1,980 MHz (the
H100's SM clock under load). Exits 2 without a card.
"""

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time

from paged_cases import D, HKV, HQ, bound_bytes, make_path_b, make_shipped

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}
MODES = {"int4_i8": 2, "int4": 3, "int8": 1, "bf16": 0}  # the kernel's mode numbers
POOLS = {"int4_i8": "int4", "int4": "int4", "int8": "int8", "bf16": "bf16"}  # paged_cases kinds
STAMPS = {0: "prologue", 31: "end", **{1 + 5 * i + j: f"page {i} {p}" for i in range(5) for j, p in enumerate(
    ("K landed", "scores' max", "weights' max", "V landed", "p.v done"))}}  # stamp slot: what it marks
SM_MHZ = 1980  # the H100's SM clock under load (nvidia-smi reads the idle clock)


def stamped_source(src: str) -> str:
    """``csrc/paged_attention.cu`` with ``clock64`` stamps in the split kernel
    (slot k of a CTA's 32: 0 the prologue, 1 + 5 i + j page i's phase j, 31
    the end) and a C call that copies them out."""
    out, page_ends = [], 0
    for line in src.split("\n"):
        s = line.strip()
        if s.startswith("if (n_split > 1) cluster_sync();  // no CTA leaves"):
            out.append("  STAMP(31);")
        out.append(line)
        after = {
            "const int first_page": "  const long long t0 = clock64();\n  const int cta = (blockIdx.y * gridDim.z + "
                                    "blockIdx.z) * gridDim.x + blockIdx.x;",
            "__syncthreads();  // barriers initialised": "  STAMP(0);",
            "mbar_wait(bar0 + 8 * s, par);": "      if (i < 5) STAMP(1 + 5 * i);",
            "if (threadIdx.x == 0 && i >= 1 && i - 1 + stages < mine)": "      if (i < 5) STAMP(2 + 5 * i);",
            "if (threadIdx.x == 0 && i + stages < mine) issue_k": "      if (i < 5) STAMP(3 + 5 * i);",
            "mbar_wait(bar0 + 8 * (stages + s), par);": "      if (i < 5) STAMP(4 + 5 * i);",
        }
        for key, add in after.items():
            if s.startswith(key):
                out.append(add)
        if s == "finish_page();" and not page_ends:  # the whole-page walk's page end
            out.append("      if (i < 5) STAMP(5 + 5 * i);")
            page_ends += 1
    text = "\n".join(out)
    if text.count("STAMP(") != 7:
        raise RuntimeError("the split kernel's phases were not found: --phases needs this tree's kernel")
    return text.replace("namespace {\n", "namespace {\n__device__ long long g_stamps[1 << 16];\n"
                        "#define STAMP(k) do { if (threadIdx.x == 0) g_stamps[cta * 32 + (k)] = clock64() - t0; } "
                        "while (0)\n", 1) + (
        '\nextern "C" int st_paged_stamps(void* dst, int n) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, n * sizeof(long long)));\n}\n")


def phases(torch, np, dev, pa, case) -> dict:
    """Median µs since a CTA's start of each stamp, by the CTA's page count."""
    import ctypes
    from pathlib import Path

    from spatialthinker_torch import csrc
    out_dir = csrc.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "paged_stamped.cu").write_text(stamped_source((csrc.CSRC_DIR / "paged_attention.cu").read_text()))
    subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-I", str(csrc.CSRC_DIR), "-shared", "-o",
                    str(out_dir / "libstamped.so"), str(out_dir / "paged_stamped.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out_dir / "libstamped.so"))
    lib.st_paged_attention.argtypes = csrc._SIGNATURES["st_paged_attention"]
    lib.st_paged_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    q, k, v = case["q"], case["k"], case["v"]
    table, lengths = torch.from_numpy(case["table"]).to(dev), torch.from_numpy(case["lengths"]).to(dev)
    s_slots, hq, d = q.shape
    hkv, page = k.shape[2], case["page"]
    plan = pa.paged_plan(s_slots, hkv, hq // hkv, page, table.shape[1], sms=pa.device_sms(dev.index))
    o = torch.empty_like(q)
    m, l = torch.empty((2, s_slots, hq), device=dev)
    for call in range(5):  # the stamps of the last call
        rc = lib.st_paged_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), case["ks"].data_ptr(), case["vs"].data_ptr(),
            table.data_ptr(), lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), None, None, None,
            None, None, s_slots, hq, hkv, page, d, table.shape[1], k.shape[1], call % case["layers"], 2, 0,
            plan.cluster, plan.warps, plan.stages, plan.blocks_per_warp, d**-0.5,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"stamped kernel launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    stamps = np.zeros(plan.ctas * 32, np.int64)
    if lib.st_paged_stamps(stamps.ctypes.data, stamps.size):
        raise RuntimeError("reading the stamps failed")
    us = stamps.reshape(plan.ctas, 32) / SM_MHZ
    pages = np.minimum(-(-case["lengths"] // page), table.shape[1])
    by_pages = {}
    for cta in range(plan.ctas):  # stamp row (slot * Hkv + kv head) * cluster + rank
        by_pages.setdefault(int(pages[cta // plan.cluster // hkv]), []).append(cta)
    return dict(plan=plan.__dict__, by_page_count={
        n: {name: round(float(np.median(us[ctas, k])), 3) for k, name in sorted(STAMPS.items())
            if k < 1 + 5 * min(n, 5) or k == 31}
        for n, ctas in sorted(by_pages.items())})


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=None, help="checkout whose spatialthinker_torch is timed")
    parser.add_argument("--label", default="tree")
    parser.add_argument("--sweep", action="store_true", help="time other plans of this tree too")
    parser.add_argument("--fixed-cost", action="store_true", help="this tree: lengths 0 and one page a slot")
    parser.add_argument("--phases", action="store_true", help="this tree: a stamped copy of the kernel")
    parser.add_argument("--mode", choices=list(MODES), default="int4_i8", help="which paged kernel")
    args = parser.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from spatialthinker_torch.ops import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    mode, i8 = MODES[args.mode], args.mode == "int4_i8"
    has_plan = hasattr(pa, "paged_plan") and (i8 or "mode" in inspect.signature(pa.paged_plan).parameters)
    plan_kw = {} if i8 else dict(mode=mode)
    if (args.phases or args.fixed_cost) and not i8:
        parser.error("--phases and --fixed-cost time the int4_i8 kernel")

    def caller(case, plan=None):
        """A call of the kernel on the next layer of the pool each time."""
        table = torch.from_numpy(case["table"]).to(dev)
        lengths = torch.from_numpy(case["lengths"]).to(dev)
        state = [0]

        def call():
            layer = state[0] % case["layers"]
            state[0] += 1
            a = (case["q"], case["k"], case["v"], table, lengths, layer, case["ks"], case["vs"], D**-0.5,
                 case["staged"])
            if plan is not None:
                if i8:
                    return pa._launch_int4_i8_kernel(*a, plan=plan)
                if args.mode == "int4":
                    return pa._launch_int4_kernel(*a, plan=plan)
                return pa._launch_pool_kernel(*a, mode=mode, plan=plan)
            return pa.paged_attention(*a[:9], return_stats=True, int4_i8dot=i8, staged=case["staged"])
        return call

    def cuda_ms(fn, iters=50, warmup=5):
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

    def device_us(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        return sum(e.device_time for e in kernels) / calls

    def queued_us(fn, calls=20):
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

    if args.fixed_cost or args.phases:
        for name, case in (("path_b", make_path_b(torch, np, dev)), ("shipped", make_shipped(torch, np, dev))):
            if args.fixed_cost:
                for label, lens in (("lengths 0", np.zeros_like(case["lengths"])),
                                    ("one page a slot", np.minimum(case["lengths"], case["page"]))):
                    print(json.dumps(dict(label=args.label, shape=name, lengths=label,
                                          device_us=device_us(caller(dict(case, lengths=lens))), card=card)),
                          flush=True)
            if args.phases:
                print(json.dumps(dict(label=args.label, shape=name, card=card, **phases(torch, np, dev, pa, case))),
                      flush=True)
        return 0

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kind = POOLS[args.mode]
    if i8:
        cases = {"path_b": make_path_b(torch, np, dev), "shipped": make_shipped(torch, np, dev),
                 "path_b_ring": make_path_b(torch, np, dev, ring=16),
                 "path_b_17": make_path_b(torch, np, dev, lanes=17), "shipped_9": make_shipped(torch, np, dev, groups=1)}
    else:
        cases = {"path_b": make_path_b(torch, np, dev, kind=kind),
                 "path_c_17": make_path_b(torch, np, dev, lanes=17, kind=kind),
                 "path_b_ring": make_path_b(torch, np, dev, ring=16, kind=kind),
                 "shipped": make_shipped(torch, np, dev, kind=kind)}
    for name, case in cases.items():
        n_bytes = bound_bytes(case, distinct=name.startswith("shipped"))
        cells = int(case["lengths"].sum())
        ops = 4.0 * cells * HQ * D
        bound_us = max(n_bytes / HBM_BYTES_PER_S, ops / OPS_PER_S["int8" if i8 else "bf16"]) * 1e6
        plans = {"plan": None}
        if has_plan:
            ring = 0 if case["staged"] is None else case["staged"][0].shape[3]
            key = (len(case["lengths"]), HKV, HQ // HKV, case["page"], case["table"].shape[1], ring)
            plans["plan"] = pa.paged_plan(*key, sms=sms, **plan_kw)
            if plans["plan"].cluster > 1:
                plans["cluster_1"] = pa.paged_plan(*key, sms=sms, cluster=1, **plan_kw)
        for which, plan in plans.items():
            fn = caller(case, None if which == "plan" else plan)
            row = dict(label=args.label, mode=args.mode, shape=name, lanes=len(case["lengths"]), page=case["page"],
                       cells=cells, ms=cuda_ms(fn), device_us=device_us(fn), queued_us=queued_us(fn),
                       host_us=host_us(fn), bound_us=bound_us, bound_bytes=n_bytes,
                       plan=None if plan is None else plan.__dict__,
                       plan_is="the rule's" if which == "plan" else "one rank", sms=sms, card=card)
            print(json.dumps(row), flush=True)
        if args.sweep and has_plan:
            g, p_max = HQ // HKV, case["table"].shape[1]
            ring = 0 if case["staged"] is None else case["staged"][0].shape[3]
            for cluster in range(1, min(pa.SPLIT_MAX_CLUSTER, p_max) + 1):
                for stages in range(1, pa.SPLIT_MAX_STAGES + 1):
                    try:
                        alt = pa.paged_plan(len(case["lengths"]), HKV, g, case["page"], p_max, ring, sms=sms,
                                            cluster=cluster, stages=stages, **plan_kw)
                    except ValueError:
                        continue
                    alt_fn = caller(case, alt)
                    best = min(queued_us(alt_fn) for _ in range(2))
                    print(json.dumps(dict(label=args.label, mode=args.mode, shape=name, sweep=True, cluster=cluster,
                                          stages=stages,
                                          smem=alt.smem, queued_us=best, device_us=device_us(alt_fn), card=card)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
