#!/usr/bin/env python3
"""Time the silu -> int8 junction #12 of a ``spatialthinker_torch`` tree on one NVIDIA GPU.

    python3 time_silu.py [--tree DIR] [--label NAME]

Three shapes of ``gu`` (M, 2I), bf16, seeded N(0, 1):

- ``silu_1024``: (1024, 22016), a refill chunk of the paged path's prefill
  at the 3B width (``chip_smoke.py``'s ``check_silu``);
- ``silu_4096``: (4096, 22016), path (g)'s recorded refill at the 3B width;
- ``silu_7b``: (1024, 37888), the 7B width (I = 18,944).

Each call takes the next of enough copies of ``gu`` to miss the 50 MB L2
(the bound counts every byte of ``gu`` from memory).
One JSON line per shape: the median CUDA-event ms of one call (host launch
time included), the profiler's device µs of a call, the µs of a call among
20 queued back to back behind a sleeping kernel, the host µs of a call (200
calls enqueued back to back, least of five runs), the byte bound (gu read
once, q and the scales written once, at 3.35 TB/s), the launch plan where
the tree has ``silu_plan``, whether the kernel equals the plain version bit
for bit on the first copy (q and the scales), and the card.

``--tree DIR`` imports the package from another checkout (an unpacked
``git archive`` of a parent commit), so two trees are compared in one run on
one card: run parent, change, change, parent. Exits 2 without a card.
"""

import argparse
import json
import sys

from time_decode import HBM_BYTES_PER_S, cuda_ms, device_us, host_us, queued_us, smi_line

SHAPES = {"silu_1024": (1024, 11008), "silu_4096": (4096, 11008), "silu_7b": (1024, 18944)}
L2_MISS_BYTES = 200e6  # the copies a shape cycles through hold at least this much


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=None, help="checkout whose spatialthinker_torch is timed")
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from spatialthinker_torch.ops import silu_quant as sq

    card = smi_line()
    dev = torch.device("cuda", 0)
    for name, (m, i) in SHAPES.items():
        rng = np.random.default_rng(m + i)
        gu0 = torch.from_numpy(rng.standard_normal((m, 2 * i), dtype=np.float32)).to(dev, torch.bfloat16)
        copies = [gu0] + [gu0.roll(c, dims=0) for c in range(1, max(2, -(-int(L2_MISS_BYTES) // (gu0.numel() * 2))))]
        state = [0]

        def call():
            gu = copies[state[0] % len(copies)]
            state[0] += 1
            return sq.fused_silu_quantize(gu)

        q, s = sq.fused_silu_quantize(gu0)
        q_ref, s_ref = sq.fused_silu_quantize_plain(gu0)
        n_bytes = gu0.numel() * 2 + m * i + m * 4
        plan = sq.silu_plan(i).__dict__ if hasattr(sq, "silu_plan") else None
        row = dict(label=args.label, shape=name, m=m, inter=i, ms=cuda_ms(torch, call),
                   device_us=device_us(torch, call), queued_us=queued_us(torch, call), host_us=host_us(torch, call),
                   bound_us=n_bytes / HBM_BYTES_PER_S * 1e6, bound_bytes=n_bytes, plan=plan,
                   bit_equal=bool(torch.equal(q, q_ref) and torch.equal(s, s_ref)), copies=len(copies), card=card)
        print(json.dumps(row), flush=True)
        del copies, gu0
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
