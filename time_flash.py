#!/usr/bin/env python3
"""Time the flash forward and backward of a ``spatialthinker_torch`` tree on one NVIDIA GPU.

    python3 time_flash.py [--tree DIR] [--label NAME]

With seeded random bf16 inputs and the segment-id layouts of the main path
(images of 34 x 46 patches, 1,920 slots each in the uniform-window layout
through ``pack_vision_batch``), the forward at eight shapes:

- text prefill q(4, 512, 16, 128), 2 kv heads, causal, left padded;
- the causal-offset chunk: the last 256 of those rows against all 512, offset 256;
- vision full q(1, 8192, 16, 80): five contiguous images of 1,564 patches;
- vision windows q(128, 64, 16, 80): four images in 8,192 slots as windows;
- update text rows q(4, 1024, 16, 128), 2 kv heads, causal, 2-3 samples a row;
- update vision full q(1, 16384, 16, 80): 8 images;
- update vision windows q(256, 64, 16, 80): the same pack as windows;
- a log-prob piece: the 16 images of 16 samples, q(1, 32768, 16, 80);

and the backward at the update's three forms. Prints one JSON line per form:
the median CUDA-event ms of ``flash_fwd`` as one call (the range tables and
the kernel where the tree has both), of ``flash_bwd`` as one call and its
kernels where the tree has them, the share of tile pairs each direction runs
where the tree has the rule, and ``F.scaled_dot_product_attention`` with the
equivalent mask, forward and backward (a yardstick; null where it does not
fit the card). ``--tree`` imports the package from another checkout (an
unpacked ``git archive`` of a parent commit), so two trees are compared in
one run on one card: run parent, change, change, parent. Exits 2 without a
card.
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
    from spatialthinker_torch.data.packing import pack_vision_batch
    from spatialthinker_torch.models.qwen2_5_vl.config import qwen25_vl_3b
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

    def library_ms(fn, iters=10):
        try:
            return cuda_ms(fn, iters=iters)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            return None

    vc = qwen25_vl_3b().vision

    def vision_pack(n_images):
        grids = [np.array([[1, 34, 46]])] * n_images
        vis = pack_vision_batch([np.zeros((34 * 46, 1), np.float32)] * n_images, grids, vc)
        return vis.seg_full.reshape(1, -1), vis.seg_window.reshape(-1, 64)

    seg_text = np.zeros((4, 1024), np.int32)
    for row, cuts in enumerate(((400, 790, 1000), (520, 980), (330, 660, 940), (470, 900, 1024))):
        start = 0
        for i, end in enumerate(cuts):
            seg_text[row, start:end] = i + 1
            start = end
    seg_prefill = np.ones((4, 512), np.int32)
    for row, pad in enumerate((0, 61, 127, 300)):
        seg_prefill[row, :pad] = 0
    seg_five = np.zeros((1, 8192), np.int32)
    for i in range(5):
        seg_five[0, i * 1564 : (i + 1) * 1564] = i + 1
    _, win4 = vision_pack(4)
    full8, win8 = vision_pack(8)
    full16, _ = vision_pack(16)
    text, vis = (16, 2, 128), (16, 16, 80)
    # name, (Hq, Hkv, D), q segment ids, kv segment ids, causal, causal_offset, with the backward
    forms = [
        ("text_prefill", text, seg_prefill, seg_prefill, True, 0, False),
        ("causal_offset_chunk", text, seg_prefill[:, 256:], seg_prefill, True, 256, False),
        ("vision_full_8192", vis, seg_five, seg_five, False, 0, False),
        ("vision_windows_128", vis, win4, win4, False, 0, False),
        ("update_text_rows", text, seg_text, seg_text, True, 0, True),
        ("update_vision_full", vis, full8, full8, False, 0, True),
        ("update_vision_windows", vis, win8, win8, False, 0, True),
        ("logprob_vision_full", vis, full16, full16, False, 0, False),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (hq, hkv, d), q_np, kv_np, causal, off, backward in forms:
        q_seg = torch.from_numpy(np.ascontiguousarray(q_np, dtype=np.int32)).to(dev)
        kv_seg = torch.from_numpy(np.ascontiguousarray(kv_np, dtype=np.int32)).to(dev)
        (b, sq), skv = q_seg.shape, kv_seg.shape[1]

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        q, do, k, v = randn(b, sq, hq, d), randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d)
        kw = dict(causal=causal, scale=d**-0.5)
        fwd_kw = dict(kw, causal_offset=off)
        o, lse = fa.flash_fwd(q, k, v, q_seg, kv_seg, **fwd_kw)
        result = {"label": args.label, "form": name, "q": list(q.shape), "kv": list(k.shape), "causal": causal,
                  "causal_offset": off,
                  "fwd_ms": cuda_ms(lambda: fa.flash_fwd(q, k, v, q_seg, kv_seg, **fwd_kw))}
        if hasattr(fa, "fwd_live_tiles"):
            q_rng, kv_rng = fa._launch_ranges(q_seg, kv_seg)
            result["ranges_ms"] = cuda_ms(lambda: fa._launch_ranges(q_seg, kv_seg))
            result["fwd_live_tile_share"] = fa.fwd_live_tiles(q_rng, kv_rng, causal, off, sq, skv).float().mean().item()
        mask = fa.make_attention_mask(q_seg, kv_seg, causal, off)[:, None]
        result["unmasked_pair_share"] = mask.float().mean().item()
        g = hq // hkv
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in
                      (q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
        with torch.no_grad():
            result["sdpa_fwd_ms"] = library_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=d**-0.5))
        if backward:
            result["bwd_ms"] = cuda_ms(lambda: fa.flash_bwd(q, k, v, q_seg, kv_seg, o, lse, do, **kw))
            if hasattr(fa, "_launch_bwd_prep"):
                delta, q_rng, kv_rng = fa._launch_bwd_prep(do, o, q_seg, kv_seg)
                kargs = (q, k, v, do, lse, delta, q_seg, kv_seg, q_rng, kv_rng, causal, d**-0.5)
                result["prep_ms"] = cuda_ms(lambda: fa._launch_bwd_prep(do, o, q_seg, kv_seg))
                result["dq_ms"] = cuda_ms(lambda: fa._launch_bwd_dq(*kargs))
                result["dkv_ms"] = cuda_ms(lambda: fa._launch_bwd_dkv(*kargs))
                result["bwd_live_tile_share"] = fa.live_tile_pairs(q_rng, kv_rng, causal).float().mean().item()
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=d**-0.5)
            dot = do.transpose(1, 2).contiguous()
            result["sdpa_bwd_ms"] = library_ms(
                lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
            del out, dot
        result["card"] = card
        print(json.dumps(result), flush=True)
        del q, do, k, v, o, lse, mask, qt, kt, vt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
