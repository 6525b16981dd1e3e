"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: every number compared, beside its limit.
The same numbers end standard error. Exits non-zero, printing no result,
without a CUDA device (or with fewer than the cell asks for), or when
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the window
has closed. Builds and caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "spatialthinker_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class RunData:
    """What a metric's reader reads: the window's units and their
    ``train_step`` metrics, the window's seconds and tokens, the traced
    unit's summary and the configuration."""

    def __init__(self, result: dict, cfg: dict, mix: dict):
        self.__dict__.update(result)
        self.cfg, self.mix = cfg, mix


def report(bench: dict, workload: str, result: dict, cfg: dict, mix: dict, trace: bool,
           kind: str, count: int) -> dict:
    """The result's line of one run."""
    from perfbench import check, manifest

    data = RunData(result, cfg, mix)
    metrics = {}
    for m in manifest.metrics_for(bench, workload, trace):
        value = manifest.reader(m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = check.load_limits(ROOT / "perfbench", workload)
    numbers = result["numbers"]
    device = {"platform": "gpu", "kind": kind, "count": count, "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": check.verdict(numbers, limits), "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": device}
    if trace:
        summary = result["trace"] or {}
        device["busy_s"] = summary.get("busy_s", 0.0)
        device["window_s"] = summary.get("window_s", 0.0)
        line["breakdown"] = {"device_ops": summary.get("device_ops", []),
                             "idle_gaps": summary.get("idle_gaps", [])}
    line["checks"] = {k: {"value": v, "limit": None if limits is None else limits.get(k)}
                      for k, v in numbers.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "perfbench" / ".cache" / "triton"))
    import torch

    from perfbench import manifest

    bench = manifest.load(ROOT)
    wl = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"perfbench: the cell needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    cfg = manifest.config(bench, wl["config"], ROOT)
    mix = manifest.traffic(wl["traffic"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    result = manifest.runner(mix).run(cfg, mix, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that the benchmark may not load: {found}", file=sys.stderr)
        return 4

    line = report(bench, args.workload, result, cfg, mix, bool(args.trace),
                  torch.cuda.get_device_name(0), wl["chips"])
    print(f"perfbench: units {result['attempted']}, window {result['window_s']:.3f} s, followed steps "
          f"{[round(s, 3) for s in result['step_s']]} s, reference {result['reference_s']:.3f} s",
          file=sys.stderr)
    print(json.dumps(line), flush=True)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
