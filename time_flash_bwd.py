#!/usr/bin/env python3
"""Time the flash backward of a ``spatialthinker_torch`` tree on one NVIDIA GPU.

    python3 time_flash_bwd.py [--tree DIR] [--label NAME]

At the three attention forms of the packed actor update, with seeded random
bf16 inputs: packed text rows q(4, 1024, 16, 128) with 2 kv heads, causal,
2-3 samples a row; the vision pack of 8 images of 34 x 46 patches (1,564
each, uniform-window layout) in 16,384 slots as one sequence q(1, 16384, 16,
80); and the same pack as 256 windows of 64 patches. Prints one JSON line per
form: the median CUDA-event ms of ``flash_bwd`` as one call (whatever the
tree computes there: delta, pre-pass, kernels), of each kernel wrapper where
the tree has them, and of the backward of ``F.scaled_dot_product_attention``
with the equivalent mask (a yardstick). ``--tree`` imports the package from
another checkout (an unpacked ``git archive`` of a parent commit), so two
trees are compared in one run on one card: run parent, change, change,
parent. Exits 2 without a card.
"""

import argparse
import json
import statistics
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=None, help="checkout whose spatialthinker_torch is timed")
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from spatialthinker_torch.models.qwen2_5_vl.config import qwen25_vl_3b
    from spatialthinker_torch.models.qwen2_5_vl.host import pad_vision_inputs, prepare_vision_aux
    from spatialthinker_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)

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

    seg_text = np.zeros((4, 1024), np.int32)
    for row, cuts in enumerate(((400, 790, 1000), (520, 980), (330, 660, 940), (470, 900, 1024))):
        start = 0
        for i, end in enumerate(cuts):
            seg_text[row, start:end] = i + 1
            start = end
    vc = qwen25_vl_3b().vision
    aux = prepare_vision_aux([(1, 34, 46)] * 8, vc)
    _, _, seg_full, seg_win, _ = pad_vision_inputs(np.zeros((aux.num_patches, 1), np.float32), aux, 16384,
                                                   vc.spatial_merge_unit)
    forms = [
        ("text_rows", (16, 2, 128), seg_text, True),
        ("vision_full", (16, 16, 80), seg_full.reshape(1, -1), False),
        ("vision_windows", (16, 16, 80), seg_win.reshape(-1, 64), False),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (hq, hkv, d), seg_np, causal in forms:
        seg = torch.from_numpy(np.ascontiguousarray(seg_np, dtype=np.int32)).to(dev)
        b, s = seg.shape

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        q, do, k, v = randn(b, s, hq, d), randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        kw = dict(causal=causal, scale=d**-0.5)
        o, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
        result = {"label": args.label, "form": name, "q": list(q.shape), "kv": list(k.shape), "causal": causal,
                  "bwd_ms": cuda_ms(lambda: fa.flash_bwd(q, k, v, seg, seg, o, lse, do, **kw))}
        if hasattr(fa, "_launch_bwd_prep"):
            delta, q_rng, kv_rng = fa._launch_bwd_prep(do, o, seg, seg)
            kargs = (q, k, v, do, lse, delta, seg, seg, q_rng, kv_rng, causal, d**-0.5)
            result["prep_ms"] = cuda_ms(lambda: fa._launch_bwd_prep(do, o, seg, seg))
            result["dq_ms"] = cuda_ms(lambda: fa._launch_bwd_dq(*kargs))
            result["dkv_ms"] = cuda_ms(lambda: fa._launch_bwd_dkv(*kargs))
            result["live_tile_share"] = fa.live_tile_pairs(q_rng, kv_rng, causal).float().mean().item()
        mask = fa.make_attention_mask(seg, seg, causal)[:, None]
        g = hq // hkv
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in
                      (q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=d**-0.5)
        dot = do.transpose(1, 2).contiguous()
        result["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                                        iters=10)
        result["card"] = card
        print(json.dumps(result), flush=True)
        del q, do, k, v, o, lse, mask, qt, kt, vt, out, dot
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
