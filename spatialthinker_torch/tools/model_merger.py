"""A port checkpoint -> an HF model directory (``model.safetensors`` +
``config.json``) that ``transformers`` and the eval harness's HF provider load
(counterpart of ``spatialthinker_tpu/tools/model_merger.py``).

A checkpoint holds one state dict (``params.pt``, ``trainer/checkpoint.py``),
so there are no shards to merge: the export is the inverse of
``params_from_hf_state_dict``. It splits the fused per-kv-group
``qkv_proj`` rows into ``q_proj`` / ``k_proj`` / ``v_proj`` and ``gate_up_proj``
into ``gate_proj`` / ``up_proj``, and folds the patch embed back into its
Conv3d shape. ``safetensors`` is imported only when a file is written.

CLI::

    python3 -m spatialthinker_torch.tools.model_merger \\
        --checkpoint ckpt/global_step_75 --output ./hf_model [--preset 3b] [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Mapping, Optional

import torch

from ..models.qwen2_5_vl.config import Qwen25VLConfig, get_config
from ..models.qwen2_5_vl.model import Qwen25VL

TEXT, VISION = "model.language_model.", "model.visual."


def params_to_hf_state_dict(state: Mapping[str, torch.Tensor], cfg: Qwen25VLConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict -> an HF Qwen2.5-VL state dict (torch (out, in)
    Linear layout, per-layer names), values as they are (views where a
    reshape allows)."""
    tc, vc = cfg.text, cfg.vision
    h, hkv, d, e = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim, tc.hidden_size
    qper = h // hkv
    out: Dict[str, torch.Tensor] = {
        f"{TEXT}embed_tokens.weight": state["text.embed_tokens.weight"],
        f"{TEXT}norm.weight": state["text.norm.weight"],
    }
    if not tc.tie_word_embeddings:
        out["lm_head.weight"] = state["text.lm_head.weight"]
    for i in range(tc.num_hidden_layers):
        src, dst = f"text.layers.{i}.", f"{TEXT}layers.{i}."
        # per kv group the fused rows are [q heads of the group | k | v]
        w = state[src + "self_attn.qkv_proj.weight"].reshape(hkv, (qper + 2) * d, e)
        b = state[src + "self_attn.qkv_proj.bias"].reshape(hkv, (qper + 2) * d)
        for name, lo, hi in (("q", 0, qper * d), ("k", qper * d, (qper + 1) * d),
                             ("v", (qper + 1) * d, (qper + 2) * d)):
            out[dst + f"self_attn.{name}_proj.weight"] = w[:, lo:hi].reshape(-1, e)
            out[dst + f"self_attn.{name}_proj.bias"] = b[:, lo:hi].reshape(-1)
        out[dst + "self_attn.o_proj.weight"] = state[src + "self_attn.o_proj.weight"]
        gate, up = state[src + "mlp.gate_up_proj.weight"].chunk(2, dim=0)
        out[dst + "mlp.gate_proj.weight"] = gate
        out[dst + "mlp.up_proj.weight"] = up
        out[dst + "mlp.down_proj.weight"] = state[src + "mlp.down_proj.weight"]
        for name in ("input_layernorm.weight", "post_attention_layernorm.weight"):
            out[dst + name] = state[src + name]

    out[f"{VISION}patch_embed.proj.weight"] = state["vision.patch_embed.weight"].reshape(
        vc.hidden_size, vc.in_channels, vc.temporal_patch_size, vc.patch_size, vc.patch_size)
    for i in range(vc.depth):
        src, dst = f"vision.blocks.{i}.", f"{VISION}blocks.{i}."
        for name in ("norm1.weight", "norm2.weight"):
            out[dst + name] = state[src + name]
        for hf, ours in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.gate_proj", "mlp.gate_proj"),
                         ("mlp.up_proj", "mlp.up_proj"), ("mlp.down_proj", "mlp.down_proj")):
            out[dst + hf + ".weight"] = state[src + ours + ".weight"]
            out[dst + hf + ".bias"] = state[src + ours + ".bias"]
    out[f"{VISION}merger.ln_q.weight"] = state["vision.merger.ln_q.weight"]
    for hf, ours in (("mlp.0", "fc1"), ("mlp.2", "fc2")):
        out[f"{VISION}merger.{hf}.weight"] = state[f"vision.merger.{ours}.weight"]
        out[f"{VISION}merger.{hf}.bias"] = state[f"vision.merger.{ours}.bias"]
    return out


def hf_config_dict(cfg: Qwen25VLConfig) -> Dict[str, Any]:
    """The ``config.json`` of an HF Qwen2.5-VL model of these dimensions."""
    t, v = cfg.text, cfg.vision
    return {
        "architectures": ["Qwen2_5_VLForConditionalGeneration"],
        "model_type": "qwen2_5_vl",
        "tie_word_embeddings": t.tie_word_embeddings,
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_end_token_id": cfg.vision_end_token_id,
        "eos_token_id": cfg.eos_token_id,
        "text_config": {
            "model_type": "qwen2_5_vl_text",
            "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_hidden_layers,
            "num_attention_heads": t.num_attention_heads,
            "num_key_value_heads": t.num_key_value_heads,
            "rms_norm_eps": t.rms_norm_eps,
            "rope_theta": t.rope_theta,
            "max_position_embeddings": t.max_position_embeddings,
            "hidden_act": t.hidden_act,
            "tie_word_embeddings": t.tie_word_embeddings,
            "rope_scaling": {"type": "mrope", "mrope_section": list(t.mrope_section)},
        },
        "vision_config": {
            "model_type": "qwen2_5_vl",
            "depth": v.depth,
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_heads": v.num_heads,
            "in_channels": v.in_channels,
            "patch_size": v.patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "temporal_patch_size": v.temporal_patch_size,
            "tokens_per_second": v.tokens_per_second,
            "window_size": v.window_size,
            "out_hidden_size": v.out_hidden_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
            "hidden_act": v.hidden_act,
        },
    }


def check_state(state: Mapping[str, torch.Tensor], cfg: Qwen25VLConfig) -> None:
    """Raise unless ``state`` holds exactly the parameters of a ``Qwen25VL``
    of ``cfg`` at their shapes (the wrong ``--preset`` shows here, not as a
    reshape error)."""
    want = {k: tuple(v.shape) for k, v in Qwen25VL(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing, unexpected = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or unexpected:
        raise ValueError(f"checkpoint parameters do not match the preset: missing {missing[:3]}, "
                         f"unexpected {unexpected[:3]}")
    wrong = [(k, got[k], want[k]) for k in want if got[k] != want[k]]
    if wrong:
        raise ValueError(f"checkpoint shapes do not match the preset, e.g. {wrong[0]} (got, preset)")


def export_hf(state: Mapping[str, torch.Tensor], cfg: Qwen25VLConfig, output_dir: str,
              dtype: str = "bfloat16") -> None:
    """Write ``model.safetensors`` (every tensor in ``dtype``) and
    ``config.json`` into ``output_dir``."""
    from safetensors.torch import save_file

    check_state(state, cfg)
    os.makedirs(output_dir, exist_ok=True)
    to = getattr(torch, dtype)
    # one contiguous copy per tensor: the split views share storage, which the writer refuses
    hf = {k: v.detach().to(device="cpu", dtype=to, copy=True).contiguous()
          for k, v in params_to_hf_state_dict(state, cfg).items()}
    save_file(hf, os.path.join(output_dir, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)


def load_checkpoint_params(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """The policy's state dict from a checkpoint's ``global_step_N``
    directory (``params.pt``), on the CPU."""
    path = os.path.join(checkpoint_dir, "params.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no params.pt under {checkpoint_dir}: pass a global_step_N directory")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if set(state) == {"actor", "critic"}:
        raise ValueError(
            f"{checkpoint_dir} is a GAE checkpoint ({{'actor', 'critic'}}): the export takes a "
            "policy's parameters alone"
        )
    return state


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="export a checkpoint as an HF model directory")
    parser.add_argument("--checkpoint", required=True, help="global_step_N dir")
    parser.add_argument("--output", required=True)
    parser.add_argument("--preset", default="3b")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float16", "float32"])
    args = parser.parse_args(argv)

    cfg = get_config(args.preset)
    export_hf(load_checkpoint_params(args.checkpoint), cfg, args.output, dtype=args.dtype)
    print(f"exported HF model to {args.output}")


if __name__ == "__main__":
    main()
