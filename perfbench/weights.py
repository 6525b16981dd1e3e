"""Seeded random weights of a Qwen2.5-VL configuration, made by the benchmark.

The benchmark makes the weights itself and hands the same to both sides: the
program loads them as its state dict, and the plain reference makes them again
from the same seed once the program is gone. The names and shapes are those of
the port's state dict (``spatialthinker_torch/models/qwen2_5_vl``): per text
layer one fused ``qkv_proj`` whose output rows are, per kv head, that group's
q heads, then its k head, then its v head, and one ``gate_up_proj`` of [gate;
up]; the vision tower as in the published checkpoint. The table is written
out here from the configuration, not read from the program.

Every matrix and bias is N(0, 0.02) and every norm weight 1, as the
published initializer range gives. All random leaves are views into one flat
buffer on the device, in the dtype they are served in, filled by a few large
``normal_`` calls from one generator.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

INIT_STD = 0.02
CHUNK = 1 << 30  # elements drawn by one call


def leaf_table(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter, kind "norm" or "random", in
    the order the flat buffer is cut."""
    e = model["hidden_size"]
    h, hkv = model["num_attention_heads"], model["num_key_value_heads"]
    d = e // h
    inter, vocab = model["intermediate_size"], model["vocab_size"]
    vc = model["vision_config"]
    ve, vi = vc["hidden_size"], vc["intermediate_size"]
    patch_in = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    merged = vc["spatial_merge_size"] ** 2 * ve
    out: List[Tuple[str, Tuple[int, ...], str]] = [("text.embed_tokens.weight", (vocab, e), "random")]
    for i in range(model["num_hidden_layers"]):
        p = f"text.layers.{i}."
        out += [
            (p + "input_layernorm.weight", (e,), "norm"),
            (p + "self_attn.qkv_proj.weight", ((h + 2 * hkv) * d, e), "random"),
            (p + "self_attn.qkv_proj.bias", ((h + 2 * hkv) * d,), "random"),
            (p + "self_attn.o_proj.weight", (e, h * d), "random"),
            (p + "post_attention_layernorm.weight", (e,), "norm"),
            (p + "mlp.gate_up_proj.weight", (2 * inter, e), "random"),
            (p + "mlp.down_proj.weight", (e, inter), "random"),
        ]
    out.append(("text.norm.weight", (e,), "norm"))
    if not model["tie_word_embeddings"]:
        out.append(("text.lm_head.weight", (vocab, e), "random"))
    out.append(("vision.patch_embed.weight", (ve, patch_in), "random"))
    for i in range(vc["depth"]):
        p = f"vision.blocks.{i}."
        out += [
            (p + "norm1.weight", (ve,), "norm"),
            (p + "norm2.weight", (ve,), "norm"),
            (p + "qkv.weight", (3 * ve, ve), "random"),
            (p + "qkv.bias", (3 * ve,), "random"),
            (p + "proj.weight", (ve, ve), "random"),
            (p + "proj.bias", (ve,), "random"),
            (p + "mlp.gate_proj.weight", (vi, ve), "random"),
            (p + "mlp.gate_proj.bias", (vi,), "random"),
            (p + "mlp.up_proj.weight", (vi, ve), "random"),
            (p + "mlp.up_proj.bias", (vi,), "random"),
            (p + "mlp.down_proj.weight", (ve, vi), "random"),
            (p + "mlp.down_proj.bias", (ve,), "random"),
        ]
    out += [
        ("vision.merger.ln_q.weight", (ve,), "norm"),
        ("vision.merger.fc1.weight", (merged, merged), "random"),
        ("vision.merger.fc1.bias", (merged,), "random"),
        ("vision.merger.fc2.weight", (vc["out_hidden_size"], merged), "random"),
        ("vision.merger.fc2.bias", (vc["out_hidden_size"],), "random"),
    ]
    return out


def weight_seed(seed: int) -> int:
    """The generator seed of the weights of run seed ``seed``."""
    return int(np.random.SeedSequence([int(seed), 0x57E1]).generate_state(1, np.uint64)[0] >> 1)


@torch.no_grad()
def make_weights(model: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The state dict of run seed ``seed``: views into one flat buffer."""
    table = leaf_table(model)
    n_random = sum(int(np.prod(s)) for _, s, k in table if k == "random")
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    flat = torch.empty(n_random, device=device, dtype=dtype)
    for start in range(0, n_random, CHUNK):
        flat[start:start + CHUNK].normal_(0.0, INIT_STD, generator=gen)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in table:
        n = int(np.prod(shape))
        if kind == "norm":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            out[name] = flat[at:at + n].view(shape)
            at += n
    return out
