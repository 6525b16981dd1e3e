#!/usr/bin/env python3
"""Time the int4 MLP kernels #13 (gate_up + silu) and #14 (down) of a ``spatialthinker_torch`` tree on one NVIDIA GPU.

    python3 time_int4_mlp.py [--tree DIR] [--label NAME] [--sweep]

The 3B preset's widths (E = 2,048, I = 11,008), group 128: seeded N(0, 0.02)
weights packed by ``Int4Weight.from_weight``, seeded N(0, 1) bf16 rows.

- ``gate_up_m136`` / ``down_m136``: path (g)'s 136 decode lanes (128 slots
  and the trash lane, to a multiple of 8);
- ``gate_up_m128`` / ``down_m128``: path (f)'s ``dense_w4a8``, 128 rows;
- ``gate_up_m8`` / ``down_m8``: a small batch;
- ``gate_up_m256`` and ``down_m200``: two row tiles each (the rule refuses
  down at m = 256).

Each call takes the next of enough copies of the weights to miss the 50 MB
L2. One JSON line per shape: the median CUDA-event ms of one call (host
launch time included), the profiler's device µs of a call (the prologue and
the main kernel), the µs of a call among 20 queued back to back behind a
sleeping kernel, the host µs of a call (200 calls enqueued back to back,
least of five runs), the byte bound (x, the nibbles and the scales read once,
the output written once, at 3.35 TB/s), the plan where the tree has
``w4_plan``, whether two calls are bit-identical, the largest error against
the plain version over the largest output, kernel A's device µs at the same
m on the INT8 copy of the same weights (``fused_w8a8_matmul``: the W8A8
linear the int4 copy replaces, the yardstick; used nowhere in the int4
path), the device's SM count and the card.

``--tree DIR`` imports the package from another checkout (an unpacked
``git archive`` of a parent commit), so two trees are compared in one run on
one card: run parent, change, change, parent. This tree only: ``--sweep``
also times other plans (consumer warps, cluster ranks, ring depths) at the
m = 136 and m = 8 shapes; ``--phases`` builds a copy of the kernel with
``clock64`` stamps into ``csrc/build/phases/`` (needs nvcc; the package's
library is untouched) and prints, at the m = 136 and m = 8 shapes, the
median µs since a CTA's start at which thread 0 passes each phase (the
prologue's end seen by ``griddepcontrol.wait``; per ring stage: landed and
computed) and the CTA's end, with the prologue's own duration.
Exits 2 without a card.
"""

import argparse
import json
import sys

from time_decode import HBM_BYTES_PER_S, cuda_ms, device_us, host_us, queued_us, smi_line

E, I, GROUP = 2048, 11008, 128
SHAPES = {  # name -> (gate_up?, m)
    "gate_up_m136": (True, 136), "down_m136": (False, 136),
    "gate_up_m128": (True, 128), "down_m128": (False, 128),
    "gate_up_m8": (True, 8), "down_m8": (False, 8),
    "gate_up_m256": (True, 256), "down_m200": (False, 200),
}
L2_MISS_BYTES = 200e6  # the copies a shape cycles through hold at least this much
SM_MHZ = 1980  # the H100's SM clock under load (nvidia-smi reads the idle clock)
STAMPED_STAGES = 8  # stages stamped a CTA
STAMPS = {1: "prologue done (griddepcontrol.wait)", 30: "end",
          **{2 + 2 * i + j: f"stage {i} {p}" for i in range(STAMPED_STAGES)
             for j, p in enumerate(("landed", "computed"))}}  # slot of a CTA's 32: what it marks


def stamped_source(src: str) -> str:
    """``csrc/int4_mlp.cu`` with ``clock64`` stamps by thread 0 of every CTA
    of the main kernel (slots as STAMPS) and the prologue's first CTA's
    start and end on the global timer, and a C call that copies them out."""
    marks = {
        "  const int gid = lane >> 2, tig = lane & 3;": ("after", "  const long long t0 = clock64();\n"
                                                        "  const int cta = blockIdx.y * gridDim.x + blockIdx.x;"),
        "    griddep_wait();\n    for (int i = 0; i < pre; ++i) W4_FEED_XQ": ("first", "    STAMP(1);\n"),
        "    mbar_wait(full0 + 8 * slot, (i / stages) & 1);": ("after", "    if (i < 8) STAMP(2 + 2 * i);"),
        "    if (lane == 0) {  // the last warp done with the slot refills it": ("before",
                                                                               "    if (i < 8) STAMP(3 + 2 * i);\n"),
        "    return;\n  }\n\n  // split K": ("before", "    STAMP(30);\n"),
        "  cluster_sync();  // no CTA leaves": ("before", "  STAMP(30);\n"),
        "  griddep_launch_dependents();  // the main kernel may start streaming weights now": (
            "after", "  if (blockIdx.x == 0 && threadIdx.x == 0) g_prologue[0] = gtimer();"),
        "    *reinterpret_cast<uint4*>(xq + staged_offset(row, 16 * c16, k, tile_rows, n_stages)) = q;\n  }": (
            "after", "  __syncthreads();\n  if (blockIdx.x == 0 && threadIdx.x == 0) g_prologue[1] = gtimer();"),
    }
    for key, (where, add) in marks.items():
        if key not in src:
            raise RuntimeError(f"the int4 kernel's phase {key.strip()!r} was not found: --phases needs this tree")
        if where == "after":
            src = src.replace(key, key + "\n" + add, 1)
        elif where == "before":
            src = src.replace(key, add + key, 1)
        else:  # inside the line, after its griddepcontrol.wait
            src = src.replace(key, key.replace("griddep_wait();\n", "griddep_wait();\n" + add), 1)
    head = ("namespace {\n__device__ long long g_stamps[1 << 16];\n__device__ unsigned long long g_prologue[2];\n"
            "__device__ __forceinline__ unsigned long long gtimer() {\n  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
            "#define STAMP(k) do { if (threadIdx.x == 0) g_stamps[cta * 32 + (k)] = clock64() - t0; } while (0)\n")
    return src.replace("namespace {\n", head, 1) + (
        '\nextern "C" int st_int4_stamps(void* dst, int n, void* prologue_ns) {\n'
        "  cudaError_t e = cudaMemcpyFromSymbol(dst, g_stamps, n * sizeof(long long));\n"
        "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(prologue_ns, g_prologue, 2 * sizeof(long long));\n"
        "  return static_cast<int>(e);\n}\n")


def phases(torch, np, i4, x, w, gateup, sms) -> dict:
    """Median µs since a CTA's start of each stamp over the CTAs of the last
    of five calls, and the prologue's duration."""
    import ctypes
    import subprocess

    from spatialthinker_torch import csrc
    out_dir = csrc.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libint4_stamped.so"
    if not lib_path.exists():
        (out_dir / "int4_stamped.cu").write_text(stamped_source((csrc.CSRC_DIR / "int4_mlp.cu").read_text()))
        done = subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-I", str(csrc.CSRC_DIR), "-shared", "-o",
                               str(lib_path), str(out_dir / "int4_stamped.cu")], capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on the stamped copy:\n{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.st_int4_mlp.argtypes = csrc._SIGNATURES["st_int4_mlp"]
    lib.st_int4_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    m, k = x.shape
    n_cols = w.q4.shape[0]
    plan = i4.w4_plan(m, k, n_cols // 2 if gateup else n_cols, gateup, sms, GROUP)
    out = torch.empty((m, n_cols // 2 if gateup else n_cols), dtype=torch.bfloat16, device=x.device)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8, device=x.device)
    for _ in range(5):
        rc = lib.st_int4_mlp(x.data_ptr(), scratch.data_ptr(), w.q4.data_ptr(), w.gscale.data_ptr(), out.data_ptr(),
                             m, k, n_cols, GROUP, int(gateup), 0, plan.warps, plan.ranks, plan.stages, plan.tile_rows,
                             torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"stamped kernel launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    stamps = np.zeros(plan.ctas * 32, np.int64)
    prologue = np.zeros(2, np.uint64)
    if lib.st_int4_stamps(stamps.ctypes.data, stamps.size, prologue.ctypes.data):
        raise RuntimeError("reading the stamps failed")
    us = stamps.reshape(plan.ctas, 32) / SM_MHZ
    n_st = -(-plan.n_stages // plan.ranks)
    shown = [slot for slot in sorted(STAMPS) if slot < 2 or slot == 30 or (slot - 2) // 2 < min(n_st, STAMPED_STAGES)]
    return dict(plan=plan.describe(), prologue_us=float(prologue[1] - prologue[0]) / 1e3,
                median_us={STAMPS[slot]: round(float(np.median(us[:, slot])), 3) for slot in shown},
                max_end_us=round(float(us[:, 30].max()), 3))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=None, help="checkout whose spatialthinker_torch is timed")
    parser.add_argument("--label", default="tree")
    parser.add_argument("--sweep", action="store_true", help="time other plans of this tree too")
    parser.add_argument("--phases", action="store_true", help="this tree: a stamped copy of the kernel")
    args = parser.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from spatialthinker_torch.ops import int4_mlp as i4
    from spatialthinker_torch.ops.int8_matmul import fused_w8a8_matmul

    card = smi_line()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    has_plan = hasattr(i4, "w4_plan")
    gen = torch.Generator(device=dev).manual_seed(41)
    weights = {}  # gate_up? -> (int4 copies, int8 copies (w, ws))
    for gateup, (n_cols, k) in ((True, (2 * I, E)), (False, (E, I))):
        w = torch.randn((n_cols, k), device=dev, generator=gen) * 0.02
        w4 = i4.Int4Weight.from_weight(w, GROUP)
        ws = w.abs().amax(dim=1).clamp(min=1e-8) / 127.0
        w8 = torch.round(w / ws[:, None]).clamp(-127, 127).to(torch.int8)
        del w
        n4 = max(2, -(-int(L2_MISS_BYTES) // (w4.q4.numel() + 4 * w4.gscale.numel())))
        n8 = max(2, -(-int(L2_MISS_BYTES) // w8.numel()))
        weights[gateup] = ([w4] + [i4.Int4Weight(w4.q4.roll(c, 0), w4.gscale.roll(c, 1)) for c in range(1, n4)],
                           [(w8, ws)] + [(w8.roll(c, 0), ws.roll(c, 0)) for c in range(1, n8)])

    def cycling(fn, copies):
        state = [0]

        def call():
            c = copies[state[0] % len(copies)]
            state[0] += 1
            return fn(c)
        return call

    def run(x, gateup):
        return (lambda w: i4.w4_gateup_silu(x, w)) if gateup else (lambda w: i4.w4_matmul(x, w))

    for name, (gateup, m) in SHAPES.items():
        k = E if gateup else I
        n = I if gateup else E
        rng = np.random.default_rng(m + k)
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev, torch.bfloat16)
        w4s, w8s = weights[gateup]
        fn = run(x, gateup)
        out, again = fn(w4s[0]), fn(w4s[0])
        ref = (i4.w4_gateup_silu_plain(x, w4s[0].q4, w4s[0].gscale) if gateup
               else i4.w4_matmul_plain(x, w4s[0].q4, w4s[0].gscale)).float()
        err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        n_bytes = x.numel() * 2 + w4s[0].q4.numel() + 4 * w4s[0].gscale.numel() + out.numel() * out.element_size()
        call = cycling(fn, w4s)
        kernel_a = cycling(lambda wc: fused_w8a8_matmul(x, wc[0], wc[1]), w8s)
        plan = i4.w4_plan(m, k, n, gateup, sms, GROUP).describe() if has_plan else None
        row = dict(label=args.label, shape=name, m=m, k=k, n=n, ms=cuda_ms(torch, call),
                   device_us=device_us(torch, call), queued_us=queued_us(torch, call), host_us=host_us(torch, call),
                   bound_us=n_bytes / HBM_BYTES_PER_S * 1e6, bound_bytes=n_bytes, plan=plan,
                   bit_identical_twice=bool(torch.equal(out, again)), rel_err=err,
                   kernel_a_device_us=device_us(torch, kernel_a), copies=len(w4s), sms=sms, card=card)
        print(json.dumps(row), flush=True)
        if args.sweep and has_plan and m in (136, 8):
            sweep(i4, torch, call, args.label, name, m, k, n, gateup, sms, card)
        if args.phases and m in (136, 8):
            print(json.dumps(dict(label=args.label, shape=name, phases=True, card=card,
                                  **phases(torch, np, i4, x, w4s[0], gateup, sms))), flush=True)
        del x, out, again, ref
        torch.cuda.empty_cache()
    return 0


def sweep(i4, torch, call, label, name, m, k, n, gateup, sms, card) -> None:
    """Queued and device µs of other plans of this tree at one shape."""
    real = i4.w4_plan
    try:
        for warps in range(2, i4.MAX_WARPS + 1):
            for ranks in (1, 2, 4, 8):
                for stages in range(2, i4.MAX_STAGES + 1):
                    try:
                        plan = real(m, k, n, gateup, sms, GROUP, warps=warps, ranks=ranks, stages=stages)
                    except ValueError:
                        continue
                    i4.w4_plan = lambda *a, _p=plan, **kw: _p
                    print(json.dumps(dict(label=label, shape=name, sweep=True, plan=plan.describe(),
                                          queued_us=min(queued_us(torch, call) for _ in range(2)),
                                          device_us=device_us(torch, call), card=card)), flush=True)
    finally:
        i4.w4_plan = real


if __name__ == "__main__":
    sys.exit(main())
