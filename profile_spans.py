#!/usr/bin/env python3
"""Where a training unit's host seconds and the card's idle seconds go, by
the program's own spans (``utils/spans.py``), on one NVIDIA GPU.

    python3 profile_spans.py [--workload qwen2_5_vl_3b.update_long] [--seed N] [--units 3]
                             [--out FILE]

Builds a cell of the benchmark as ``perfbench/train_phase.py`` does (the
configuration's dotlist, the seed's weights, the rollout and the reward
answered from the generator's units) and drives its ``REFERENCE_STEPS``
warm-up steps (every shape of the cell; nothing is compared with the
reference). Then ``--units`` units, each read from ``trainer.step_spans``:
seconds, self seconds and calls by span, the counters, ``pack_s`` (the
``*/pack`` spans), ``h2d_s`` (the ``*/h2d`` spans), the copies' GB/s and
each phase's ``distinct_patches / patches`` (the share of the samples'
patch rows its vision packs hold, each image once a pack).
Then one more unit under ``torch.profiler``: the card's busy and idle
seconds inside it, the idle seconds by the innermost ``st/`` span around
them, ``pack_idle_s`` (the idle seconds inside ``st/*/pack`` or
``st/*/h2d``), the longest idle gaps by span, and the ``st/`` events on the
device's rows (0: the spans are host ranges). Also the constructor's spans
(``trainer.init_spans``) and what one span costs: without a recorder, with
one and the profiler off, and with the profiler on.

Prints a summary, and with ``--out`` writes it all to FILE as JSON.
``--config`` and ``--mix`` take a configuration and a traffic file in the
benchmark's format in place of a cell's; with ``--device cpu`` (e.g.
``perfbench/tests/tiny.json`` and ``tiny_mix.json``) the script runs on the
CPU, where no device interval exists and the whole unit reads as idle.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import manifest, train_phase  # noqa: E402
from perfbench.trace import _ns  # noqa: E402
from spatialthinker_torch.utils.spans import Timer, span  # noqa: E402

UNIT = "profile_spans.unit"  # the traced unit's range
NONE = "(none)"  # idle time inside no span of the program
HOST = ("pack", "h2d")  # the spans of the host's packing and copies


def unit_record(timer: Timer) -> dict:
    """A step's record: seconds, self seconds and calls by span, counters,
    the packing's and the copies' seconds, the copies' GB/s, and by phase
    the patch rows its packs hold over the samples' (none where the
    program does not count them)."""
    paths = dict.fromkeys(s.path for s in timer.spans)
    spans = {p: {"s": timer.seconds(p), "self_s": timer.self_seconds(p), "calls": timer.calls(p)}
             for p in paths}
    pack_s = sum(v["s"] for p, v in spans.items() if p.rsplit("/", 1)[-1] == "pack")
    h2d_s = sum(v["s"] for p, v in spans.items() if p.rsplit("/", 1)[-1] == "h2d")
    h2d_bytes = sum(v for k, v in timer.counters.items() if k.endswith("/h2d/bytes"))
    held = {k[:-len("/distinct_patches")]: v for k, v in timer.counters.items() if k.endswith("/distinct_patches")}
    distinct_share = {p.split("/")[0]: v / timer.counters[f"{p}/patches"]
                      for p, v in held.items() if timer.counters.get(f"{p}/patches")}
    return {"step_s": timer.end - timer.start, "spans": spans, "counters": dict(timer.counters),
            "pack_s": pack_s, "h2d_s": h2d_s, "h2d_bytes": h2d_bytes,
            "h2d_gb_s": h2d_bytes / h2d_s / 1e9 if h2d_s > 0 else None, "distinct_share": distinct_share}


def busy_and_gaps(device: Sequence[Tuple[int, int]], w0: int, w1: int) -> Tuple[int, List[Tuple[int, int]]]:
    """Busy time of the union of ``device`` intervals inside [w0, w1], and
    the idle gaps between them."""
    busy, gaps, cursor = 0, [], w0
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e in device):
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    return busy, gaps


def innermost(ranges: Sequence[Tuple[int, int, str]], starts: Sequence[int], t: float) -> Optional[str]:
    """The name of the shortest range around ``t`` (``ranges`` sorted by start)."""
    inside = [r for r in ranges[:bisect.bisect_right(starts, t)] if r[1] >= t]
    return min(inside, key=lambda r: r[1] - r[0])[2] if inside else None


def idle_by_span(gaps: Sequence[Tuple[int, int]], ranges: Sequence[Tuple[int, int, str]]) -> Dict[str, int]:
    """Each gap cut at the ranges' ends, each piece given to the innermost
    range around it (``NONE`` outside every range)."""
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    out: Dict[str, int] = defaultdict(int)
    for a, b in gaps:
        near = [r for r in ranges[:bisect.bisect_left(starts, b)] if r[1] > a]
        near_starts = [r[0] for r in near]
        cuts = sorted({a, b} | {t for r in near for t in r[:2] if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            out[innermost(near, near_starts, (x + y) / 2) or NONE] += y - x
    return dict(out)


def is_host_work(path: str) -> bool:
    """A ``pack`` or ``h2d`` span, or one inside it."""
    return any(part in HOST for part in path.split("/"))


def traced_summary(prof, top: int = 10) -> Optional[dict]:
    """The traced unit: busy and idle seconds, idle seconds by span,
    ``pack_idle_s``, the longest gaps by span, ``st/`` events on the device."""
    device, ranges, unit, st_on_device = [], [], None, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = _ns(e, "start")
        end = s + _ns(e, "duration")
        on_device = e.device_type() == DeviceType.CUDA
        if name.startswith("st/"):
            if on_device:
                st_on_device += 1
            else:
                ranges.append((s, end, name[len("st/"):]))
        elif name == UNIT:
            if not on_device:
                unit = (s, end)
        elif on_device:
            device.append((s, end))
    if unit is None:
        return None
    busy, gaps = busy_and_gaps(device, *unit)
    ranges.sort()
    by_span = idle_by_span(gaps, ranges)
    starts = [r[0] for r in ranges]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = sum(b - a for a, b in gaps)
    pack_idle = sum(v for k, v in by_span.items() if k != NONE and is_host_work(k))
    return {
        "window_s": (unit[1] - unit[0]) * 1e-9, "busy_s": busy * 1e-9, "idle_s": idle * 1e-9,
        "pack_idle_s": pack_idle * 1e-9, "pack_idle_share": pack_idle / idle if idle else None,
        "idle_by_span_s": {k: v * 1e-9 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
        "longest_gaps": [[innermost(ranges, starts, (a + b) / 2) or NONE, (b - a) * 1e-9]
                         for a, b in longest],
        "n_gaps": len(gaps), "st_events_on_device": st_on_device,
    }


def span_cost(n: int = 20000) -> Dict[str, float]:
    """Seconds of one span: without a recorder, with one (profiler off), and
    with the profiler on (CPU activity)."""
    def per_span(k: int) -> float:
        t0 = time.perf_counter()
        for _ in range(k):
            with span("x"):
                pass
        return (time.perf_counter() - t0) / k

    out = {"no_recorder": per_span(n)}
    with Timer().active():
        out["profiler_off"] = per_span(n)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), Timer().active():
        out["profiler_on"] = per_span(n // 4)
    return out


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else torch.cuda.get_device_name(device)


def measure(cfg: dict, mix: dict, seed: int, units: int, device) -> dict:
    """The constructor's spans, ``units`` units' records after the warm-up,
    one traced unit's record and summary, and the cost of a span."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    trainer = train_phase.build_program(cfg, seed, device)
    build_s = time.perf_counter() - t0
    traffic = train_phase.Traffic(cfg, mix, seed, trainer)
    index = 0

    def step():
        nonlocal index
        trainer.global_step += 1
        trainer.train_step(traffic.prompt_batch(index))
        index += 1
        return unit_record(trainer.step_spans)

    warm = [step() for _ in range(train_phase.REFERENCE_STEPS)]
    window = [step() for _ in range(units)]
    sync()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    batch = traffic.prompt_batch(index)
    trainer.global_step += 1
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(UNIT):
            trainer.train_step(batch)
        sync()
    traced_wall_s = time.perf_counter() - t0
    return {
        "card": card_line(device), "seed": seed, "build_program_s": build_s,
        "init": unit_record(trainer.init_spans), "warm_up": [u["step_s"] for u in warm],
        "units": window, "traced": {"record": unit_record(trainer.step_spans), "wall_s": traced_wall_s,
                                    "summary": traced_summary(prof)},
        "span_cost_s": span_cost(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="qwen2_5_vl_3b.update_long")
    ap.add_argument("--config", help="a configuration file in the benchmark's format, for --workload's")
    ap.add_argument("--mix", help="a traffic file in the benchmark's format, for --workload's")
    ap.add_argument("--seed", type=int, default=3200000001)
    ap.add_argument("--units", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", help="a file for the whole record, as JSON")
    args = ap.parse_args(argv)

    bench = manifest.load(ROOT)
    wl = manifest.workload(bench, args.workload)
    cfg = (json.loads(Path(args.config).read_text()) if args.config
           else manifest.config(bench, wl["config"], ROOT))
    mix = json.loads(Path(args.mix).read_text()) if args.mix else manifest.traffic(wl["traffic"])
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    res = measure(cfg, mix, args.seed, args.units, device)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))

    print(f"{res['card']}; seed {res['seed']}; trainer built in {res['build_program_s']:.3f} s, constructor "
          + ", ".join(f"{p} {v['s']:.4f} s" for p, v in res["init"]["spans"].items()))
    for i, u in enumerate(res["units"] + [res["traced"]["record"]]):
        name = "traced" if i == len(res["units"]) else f"unit {i}"
        print(f"{name}: step {u['step_s']:.3f} s, pack_s {u['pack_s']:.3f} s, h2d_s {u['h2d_s']:.3f} s "
              f"({u['h2d_bytes'] / 1e9:.3f} GB, {u['h2d_gb_s'] or float('nan'):.2f} GB/s), "
              "distinct_patches / patches "
              + (", ".join(f"{p} {v:.4f}" for p, v in u["distinct_share"].items()) or "not counted") + "; "
              "by span (s / self s / calls): "
              + ", ".join(f"{p} {v['s']:.3f}/{v['self_s']:.3f}/{v['calls']}" for p, v in u["spans"].items()))
    s = res["traced"]["summary"]
    if s is not None:
        print(f"traced unit: window {s['window_s']:.3f} s, busy {s['busy_s']:.3f} s, idle {s['idle_s']:.3f} s, "
              f"pack_idle_s {s['pack_idle_s']:.3f} s "
              f"({100 * (s['pack_idle_share'] or 0):.1f}% of the idle), "
              f"st/ events on the device {s['st_events_on_device']}; idle by span: "
              + ", ".join(f"{k} {v:.3f}" for k, v in s["idle_by_span_s"].items() if v >= 1e-4))
        print("longest gaps: " + ", ".join(f"{k} {v:.3f}" for k, v in s["longest_gaps"]))
    print("one span: " + ", ".join(f"{k} {v * 1e6:.2f} us" for k, v in res["span_cost_s"].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
