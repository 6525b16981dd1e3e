"""Readings that the limits of ``correct`` are set from (PERF.md gives them):
the program's numbers against the plain reference over the followed steps of
one seed, and with ``--control fp8`` the control's, the reference computed
one precision below the configuration's put in the program's place. No
measured window runs.

    python3 perfbench/calibrate.py --workload <name> --seed <n> [--control fp8] [--fault <name>]

``--fault`` plants one of ``faults.py``'s faults under the program first.
Prints one JSON line: the seed, both sets of numbers, the worst leaves and
the seconds taken.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.faults import FAULTS  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--control", action="append", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench import manifest

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 3
    bench = manifest.load(ROOT)
    wl = manifest.workload(bench, args.workload)
    cfg = manifest.config(bench, wl["config"], ROOT)
    mix = manifest.traffic(wl["traffic"])
    r = manifest.runner(mix).run(cfg, mix, args.seed, 0.0, False, torch.device("cuda", 0), T_START,
                                 window=False, controls=tuple(args.control),
                                 fault=FAULTS.get(args.fault))
    print(json.dumps({"seed": args.seed, "fault": args.fault, "numbers": r["numbers"],
                      "control": r["control_numbers"], "worst": r["worst"],
                      "control_worst": r["control_worst"],
                      "setup_s": r["setup_s"], "step_s": r["step_s"], "reference_s": r["reference_s"],
                      "memory_peak_bytes": r["memory_peak_bytes"], "card": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
