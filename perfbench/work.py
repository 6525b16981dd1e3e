"""The yardstick's arithmetic: the H100's peaks, the least time of a piece of
work, and the operations and bytes that a training unit needs, counted from
its sizes (per sample, per unique image), never from the program's launches.

``bound_s`` follows ``bound_ms`` of ``chip_smoke.py`` (every input byte read
once and every output byte written once at the memory rate, or the
operations at the peak rate, whichever is larger), and the peaks are the
same data-sheet numbers.

Counting rules (one forward of one sample of ``L`` tokens, ``R`` of them the
response): every token through every decoder layer; the head only where a
log-prob is needed, at the ``R`` response tokens; causal attention over the
sample's own tokens, L (L + 1) / 2 pairs (pairs that packing masks are not
counted); the vision tower once per unique image (the ``n`` samples of a
prompt share it), its window blocks over each window's own patches and its
full blocks over the image. A training unit needs five forwards' worth: the
old and the reference log-probs (one forward each) and the update (forward
and backward, the backward twice the forward). Recomputation is not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
BF16_BYTES = 2
FORWARDS_PER_UNIT = 5  # old, ref, update forward, update backward (2)


def bound_s(n_bytes: float, n_ops: float, kind: str = "bf16") -> float:
    """Least seconds the card could take for this work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind])


def _dims(model: dict):
    e, h, hkv = model["hidden_size"], model["num_attention_heads"], model["num_key_value_heads"]
    return e, h, hkv, e // h, model["intermediate_size"], model["vocab_size"], model["num_hidden_layers"]


def text_attention(model: dict, length: int) -> Tuple[float, float]:
    """(operations, bytes) of the causal attention of one sequence, one forward."""
    e, h, hkv, d, *_ = _dims(model)
    layers = model["num_hidden_layers"]
    ops = 4.0 * h * d * length * (length + 1) / 2
    n_bytes = BF16_BYTES * length * d * (2 * h + 2 * hkv)  # q, k, v read, o written
    return layers * ops, layers * n_bytes


def text_forward(model: dict, length: int, response: int) -> float:
    """Operations of one forward of one sequence: linears, head, attention."""
    e, h, hkv, d, inter, vocab, layers = _dims(model)
    per_token = 2.0 * (e * (h + 2 * hkv) * d + h * d * e + 3 * e * inter)
    return layers * per_token * length + 2.0 * e * vocab * response + text_attention(model, length)[0]


def image_windows(vc: dict, grid) -> list:
    """Patches of each attention window of one image."""
    t, gh, gw = (int(v) for v in grid)
    merge = vc["spatial_merge_size"]
    win = vc["window_size"] // merge // vc["patch_size"]
    lh, lw = gh // merge, gw // merge
    sizes = []
    for r in range(0, lh, win):
        for c in range(0, lw, win):
            sizes.append(min(win, lh - r) * min(win, lw - c) * merge * merge)
    return sizes * t


def vision_attention(vc: dict, grid) -> Tuple[float, float]:
    """(operations, bytes) of the attention of one image through the tower, one forward."""
    t, gh, gw = (int(v) for v in grid)
    n = t * gh * gw
    e = vc["hidden_size"]
    full = len(vc["fullatt_block_indexes"])
    windowed = vc["depth"] - full
    ops = 4.0 * e * (windowed * sum(s * s for s in image_windows(vc, grid)) + full * t * (gh * gw) ** 2)
    n_bytes = BF16_BYTES * 4 * n * e * vc["depth"]
    return ops, n_bytes


def vision_forward(vc: dict, grid) -> float:
    t, gh, gw = (int(v) for v in grid)
    n = t * gh * gw
    e, inter, out = vc["hidden_size"], vc["intermediate_size"], vc["out_hidden_size"]
    patch_in = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    merged = vc["spatial_merge_size"] ** 2 * e
    ops = 2.0 * n * patch_in * e
    ops += vc["depth"] * 2.0 * n * (4 * e * e + 3 * e * inter)
    ops += 2.0 * (n // vc["spatial_merge_size"] ** 2) * (merged * merged + merged * out)
    return ops + vision_attention(vc, grid)[0]


def unit_work(model: dict, unit) -> Dict[str, float]:
    """Model operations of one training unit, and the operations and bytes of
    its attention (the flash kernels' share of it)."""
    vc = model["vision_config"]
    fwd = att_ops = att_bytes = 0.0
    for s, resp in enumerate(unit.responses):
        length = len(unit.prompts[s // unit.n].ids) + len(resp)
        fwd += text_forward(model, length, len(resp))
        o, b = text_attention(model, length)
        att_ops, att_bytes = att_ops + o, att_bytes + b
    for p in unit.prompts:
        fwd += vision_forward(vc, p.grid[0])
        o, b = vision_attention(vc, p.grid[0])
        att_ops, att_bytes = att_ops + o, att_bytes + b
    k = FORWARDS_PER_UNIT
    return {"model_ops": k * fwd, "attention_ops": k * att_ops, "attention_bytes": k * att_bytes}
