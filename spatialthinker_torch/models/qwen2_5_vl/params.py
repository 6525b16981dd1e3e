"""Weights for the port's ``Qwen25VL`` module (counterpart of
``spatialthinker_tpu/models/qwen2_5_vl/params.py``).

- ``params_from_hf_state_dict``: an HF checkpoint's state dict (torch
  (out, in) Linear layout, per-layer names) -> the port's state dict.
- ``params_from_jax``: the JAX package's parameter pytree as numpy (stacked
  (L, ...) leaves, (in, out) weights, fused ``qkv_proj`` (L, Hkv, E, G) and
  ``gate_up_proj`` (L, 2, E, I)) -> the port's state dict. Tests carry the
  same weights across the two packages with it. A QUANTIZED rollout tree
  (``{"qvalue", "scale"}`` nodes, 2D (L, E, 2I) gate_up, quantized
  ``embed_tokens``) gives ``<module>.qvalue`` / ``<module>.scale`` entries
  instead of ``<module>.weight``, and ``build_model`` makes those modules
  ``QuantLinear`` / ``QuantEmbedding`` — both packages then start from the
  same int8 values. A w4a8 tree's int4 MLP copies (``gate_up_w4`` /
  ``down_w4``: ``q4`` (L, K/2, N), ``gscale`` (L, K/group, N)) give
  ``mlp.<name>.q4`` in the port's (N, K/2) layout and ``.gscale`` as it is,
  and ``build_model`` makes them ``Int4Weight`` modules.
- ``params_to_jax``: the way back for an unquantized tree -- a port state
  dict (parameters, gradients or optimizer moments keyed by parameter name)
  as numpy in the JAX tree's layout, so tests compare updated parameters leaf
  by leaf; ``optimizer_state_from_jax`` carries Adam moments (and a Kahan
  compensation tree) the other way, into ``trainer.optim.AdamW.state``.
- ``init_params``: random weights drawn directly on the device from a
  ``torch.Generator`` (normal * 0.02, zero biases, unit norms — the JAX
  package's init scheme).
- ``build_model``: a state dict -> a ``Qwen25VL`` on a device.
- ``load_params``: a local HF checkpoint directory (``config.json`` +
  ``*.safetensors``; the ``safetensors`` package is imported only here) -> a
  ``Qwen25VL`` on a device. ``trainer_state_from_jax``: a JAX trainer's
  parameters, Adam moments, count and step as numpy trees -> what a port
  trainer loads, so both trainers start a step from the same state.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import Qwen25VLConfig, TextConfig, VisionConfig
from .model import Qwen25VL
from .text import RMSNorm
from ...ops.int4_mlp import Int4Weight
from ...ops.quant import QuantEmbedding, QuantLinear

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))  # a copy: JAX-exported arrays are read-only


def _detect_text_prefix(keys) -> Dict[str, str]:
    if any(k.startswith("model.language_model.") for k in keys):
        return {"text": "model.language_model.", "vision": "model.visual."}
    return {"text": "model.", "vision": "visual."}


def params_from_hf_state_dict(state: Mapping[str, Any], cfg: Qwen25VLConfig) -> StateDict:
    """HF Qwen2.5-VL state dict (numpy or torch tensors) -> port state dict."""
    pref = _detect_text_prefix(state.keys())
    tp, vp = pref["text"], pref["vision"]
    tc = cfg.text
    hkv, d, e = tc.num_key_value_heads, tc.head_dim, tc.hidden_size
    qper = tc.num_attention_heads // hkv

    def raw(name):
        return _t(state[name])

    out: StateDict = {
        "text.embed_tokens.weight": raw(f"{tp}embed_tokens.weight"),
        "text.norm.weight": raw(f"{tp}norm.weight"),
    }
    for i in range(tc.num_hidden_layers):
        src, dst = f"{tp}layers.{i}.", f"text.layers.{i}."
        # per kv group: [q heads of the group | k | v] output rows
        w = torch.cat([
            raw(src + "self_attn.q_proj.weight").reshape(hkv, qper * d, e),
            raw(src + "self_attn.k_proj.weight").reshape(hkv, d, e),
            raw(src + "self_attn.v_proj.weight").reshape(hkv, d, e),
        ], dim=1)
        bias = torch.cat([
            raw(src + "self_attn.q_proj.bias").reshape(hkv, qper * d),
            raw(src + "self_attn.k_proj.bias").reshape(hkv, d),
            raw(src + "self_attn.v_proj.bias").reshape(hkv, d),
        ], dim=1)
        out[dst + "self_attn.qkv_proj.weight"] = w.reshape(-1, e)
        out[dst + "self_attn.qkv_proj.bias"] = bias.reshape(-1)
        out[dst + "self_attn.o_proj.weight"] = raw(src + "self_attn.o_proj.weight")
        out[dst + "mlp.gate_up_proj.weight"] = torch.cat(
            [raw(src + "mlp.gate_proj.weight"), raw(src + "mlp.up_proj.weight")], dim=0
        )
        out[dst + "mlp.down_proj.weight"] = raw(src + "mlp.down_proj.weight")
        out[dst + "input_layernorm.weight"] = raw(src + "input_layernorm.weight")
        out[dst + "post_attention_layernorm.weight"] = raw(src + "post_attention_layernorm.weight")
    if not tc.tie_word_embeddings:
        out["text.lm_head.weight"] = raw("lm_head.weight")

    patch_w = raw(f"{vp}patch_embed.proj.weight")  # (E, C, T, P, P) Conv3d
    out["vision.patch_embed.weight"] = patch_w.reshape(patch_w.shape[0], -1)
    for i in range(cfg.vision.depth):
        src, dst = f"{vp}blocks.{i}.", f"vision.blocks.{i}."
        for name in ("norm1.weight", "norm2.weight"):
            out[dst + name] = raw(src + name)
        for hf, ours in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                         ("mlp.gate_proj", "mlp.gate_proj"), ("mlp.up_proj", "mlp.up_proj"),
                         ("mlp.down_proj", "mlp.down_proj")):
            out[dst + ours + ".weight"] = raw(src + hf + ".weight")
            out[dst + ours + ".bias"] = raw(src + hf + ".bias")
    out["vision.merger.ln_q.weight"] = raw(f"{vp}merger.ln_q.weight")
    for hf, ours in (("mlp.0", "fc1"), ("mlp.2", "fc2")):
        out[f"vision.merger.{ours}.weight"] = raw(f"{vp}merger.{hf}.weight")
        out[f"vision.merger.{ours}.bias"] = raw(f"{vp}merger.{hf}.bias")
    return out


def _is_qnode(leaf) -> bool:
    return isinstance(leaf, Mapping) and "qvalue" in leaf


def params_from_jax(tree: Mapping[str, Any], cfg: Qwen25VLConfig) -> StateDict:
    """The JAX package's parameter pytree (numpy leaves), plain or quantized
    for rollout -> port state dict."""
    text, vis = tree["text"], tree["vision"]
    layers = text["layers"]
    out: StateDict = {"text.norm.weight": _t(text["norm"])}

    def put(prefix: str, leaf, index, to_out_in):
        """One matmul weight as the port's (out, in) matrix. ``to_out_in``
        maps the (indexed) JAX array to it; a quantized node's scale keeps
        its non-contracted dims in order, which flatten to the out rows."""
        pick = (lambda a: np.asarray(a)) if index is None else (lambda a: np.asarray(a[index]))
        if _is_qnode(leaf):
            out[prefix + ".qvalue"] = _t(to_out_in(pick(leaf["qvalue"])))
            out[prefix + ".scale"] = _t(pick(leaf["scale"]).reshape(-1))
        else:
            out[prefix + ".weight"] = _t(to_out_in(pick(leaf)))

    put("text.embed_tokens", text["embed_tokens"], None, lambda a: a)
    for i in range(cfg.text.num_hidden_layers):
        dst = f"text.layers.{i}."
        # (Hkv, E, G) -> (Hkv*G, E)
        put(dst + "self_attn.qkv_proj", layers["self_attn"]["qkv_proj"], i,
            lambda a: a.transpose(0, 2, 1).reshape(-1, a.shape[1]))
        out[dst + "self_attn.qkv_proj.bias"] = _t(np.asarray(layers["self_attn"]["qkv_bias"][i]).reshape(-1))
        put(dst + "self_attn.o_proj", layers["self_attn"]["o_proj"], i, lambda a: a.T)
        # plain (2, E, I) or the rollout tree's 2D (E, 2I), gate columns first -> (2I, E)
        put(dst + "mlp.gate_up_proj", layers["mlp"]["gate_up_proj"], i,
            lambda a: a.T if a.ndim == 2 else a.transpose(0, 2, 1).reshape(-1, a.shape[1]))
        put(dst + "mlp.down_proj", layers["mlp"]["down_proj"], i, lambda a: a.T)
        for name in ("gate_up_w4", "down_w4"):  # w4a8 tree: (K/2, N) -> the port's (N, K/2)
            if name in layers["mlp"]:
                out[dst + f"mlp.{name}.q4"] = _t(np.asarray(layers["mlp"][name]["q4"][i]).T)
                out[dst + f"mlp.{name}.gscale"] = _t(layers["mlp"][name]["gscale"][i])
        out[dst + "input_layernorm.weight"] = _t(layers["input_layernorm"][i])
        out[dst + "post_attention_layernorm.weight"] = _t(layers["post_attention_layernorm"][i])
    if not cfg.text.tie_word_embeddings:
        put("text.lm_head", text["lm_head"], None, lambda a: a.T)

    out["vision.patch_embed.weight"] = _t(np.asarray(vis["patch_embed"]).T)
    blocks = vis["blocks"]
    for i in range(cfg.vision.depth):
        dst = f"vision.blocks.{i}."
        out[dst + "norm1.weight"] = _t(blocks["norm1"][i])
        out[dst + "norm2.weight"] = _t(blocks["norm2"][i])
        out[dst + "qkv.weight"] = _t(np.asarray(blocks["qkv"][i]).T)
        out[dst + "qkv.bias"] = _t(blocks["qkv_bias"][i])
        out[dst + "proj.weight"] = _t(np.asarray(blocks["proj"][i]).T)
        out[dst + "proj.bias"] = _t(blocks["proj_bias"][i])
        for name in ("gate", "up", "down"):
            out[dst + f"mlp.{name}_proj.weight"] = _t(np.asarray(blocks["mlp"][f"{name}_proj"][i]).T)
            out[dst + f"mlp.{name}_proj.bias"] = _t(blocks["mlp"][f"{name}_bias"][i])
    merger = vis["merger"]
    out["vision.merger.ln_q.weight"] = _t(merger["ln_q"])
    for name in ("fc1", "fc2"):
        out[f"vision.merger.{name}.weight"] = _t(np.asarray(merger[name]).T)
        out[f"vision.merger.{name}.bias"] = _t(merger[f"{name}_bias"])
    return out


def params_to_jax(state: Mapping[str, torch.Tensor], cfg: Qwen25VLConfig) -> Dict[str, Any]:
    """Inverse of ``params_from_jax`` for an unquantized state dict: numpy
    fp32 leaves in the JAX package's layout (stacked (L, ...) layers, (in,
    out) weights, ``qkv_proj`` (L, Hkv, E, G), ``gate_up_proj`` (L, 2, E, I))."""
    tc, vc = cfg.text, cfg.vision
    hkv, e = tc.num_key_value_heads, tc.hidden_size

    def a(name: str) -> np.ndarray:
        return state[name].detach().float().cpu().numpy()

    def stack(n: int, fmt: str, fn=lambda x: x) -> np.ndarray:
        return np.stack([fn(a(fmt.format(i))) for i in range(n)])

    n = tc.num_hidden_layers
    t = "text.layers.{}."
    text: Dict[str, Any] = {
        "embed_tokens": a("text.embed_tokens.weight"),
        "norm": a("text.norm.weight"),
        "layers": {
            "self_attn": {
                "qkv_proj": stack(n, t + "self_attn.qkv_proj.weight",
                                  lambda w: w.reshape(hkv, -1, e).transpose(0, 2, 1)),
                "qkv_bias": stack(n, t + "self_attn.qkv_proj.bias", lambda x: x.reshape(hkv, -1)),
                "o_proj": stack(n, t + "self_attn.o_proj.weight", lambda w: w.T),
            },
            "mlp": {
                "gate_up_proj": stack(n, t + "mlp.gate_up_proj.weight",
                                      lambda w: w.reshape(2, -1, e).transpose(0, 2, 1)),
                "down_proj": stack(n, t + "mlp.down_proj.weight", lambda w: w.T),
            },
            "input_layernorm": stack(n, t + "input_layernorm.weight"),
            "post_attention_layernorm": stack(n, t + "post_attention_layernorm.weight"),
        },
    }
    if not tc.tie_word_embeddings:
        text["lm_head"] = a("text.lm_head.weight").T
    d, b = vc.depth, "vision.blocks.{}."
    vision = {
        "patch_embed": a("vision.patch_embed.weight").T,
        "blocks": {
            "norm1": stack(d, b + "norm1.weight"),
            "norm2": stack(d, b + "norm2.weight"),
            "qkv": stack(d, b + "qkv.weight", lambda w: w.T),
            "qkv_bias": stack(d, b + "qkv.bias"),
            "proj": stack(d, b + "proj.weight", lambda w: w.T),
            "proj_bias": stack(d, b + "proj.bias"),
            "mlp": {
                **{f"{k}_proj": stack(d, b + f"mlp.{k}_proj.weight", lambda w: w.T)
                   for k in ("gate", "up", "down")},
                **{f"{k}_bias": stack(d, b + f"mlp.{k}_proj.bias") for k in ("gate", "up", "down")},
            },
        },
        "merger": {
            "ln_q": a("vision.merger.ln_q.weight"),
            **{k: a(f"vision.merger.{k}.weight").T for k in ("fc1", "fc2")},
            **{f"{k}_bias": a(f"vision.merger.{k}.bias") for k in ("fc1", "fc2")},
        },
    }
    return {"text": text, "vision": vision}


def optimizer_state_from_jax(cfg: Qwen25VLConfig, *, count: int, mu, nu, compensation=None,
                             moment_dtype=torch.float32, param_dtype=torch.float32,
                             device="cpu") -> Dict[str, Any]:
    """Adam state of the JAX package (moment trees shaped like the parameter
    tree, numpy leaves; ``compensation`` the AnyPrecision Kahan tree or None)
    -> the ``state`` dict of ``trainer.optim.AdamW``."""
    def carry(tree, dtype):
        return {k: v.to(device=device, dtype=dtype) for k, v in params_from_jax(tree, cfg).items()}

    return {
        "count": int(count), "mu": carry(mu, moment_dtype), "nu": carry(nu, moment_dtype),
        "compensation": {} if compensation is None else carry(compensation, param_dtype),
    }


def default_device() -> torch.device:
    """Where an entry point runs when the caller names no device: the card.
    The CPU is used only when asked for."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def build_model(cfg: Qwen25VLConfig, state: Mapping[str, torch.Tensor], *,
                device=None, dtype=torch.bfloat16) -> Qwen25VL:
    """A ``Qwen25VL`` holding ``state`` (every parameter, strictly) on
    ``device`` (default: the current CUDA device)."""
    device = default_device() if device is None else device
    model = Qwen25VL(cfg, device="meta", dtype=dtype)
    loaded = {}
    for key, value in state.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "qvalue":
            parent, _, name = prefix.rpartition(".")
            holder = model.get_submodule(parent)
            qvalue = value.to(device=device, dtype=torch.int8)
            scale = state[prefix + ".scale"].to(device=device, dtype=torch.float32)
            if name == "embed_tokens":
                setattr(holder, name, QuantEmbedding(qvalue, scale))
            else:
                setattr(holder, name, QuantLinear(qvalue, scale, getattr(holder, name).bias))
            loaded[key], loaded[prefix + ".scale"] = qvalue, scale
        elif leaf == "q4":
            parent, _, name = prefix.rpartition(".")
            q4 = value.to(device=device, dtype=torch.uint8)
            gscale = state[prefix + ".gscale"].to(device=device, dtype=torch.float32)
            setattr(model.get_submodule(parent), name, Int4Weight(q4, gscale))
            loaded[key], loaded[prefix + ".gscale"] = q4, gscale
        elif not ((leaf == "scale" and prefix + ".qvalue" in state)
                  or (leaf == "gscale" and prefix + ".q4" in state)):
            loaded[key] = value.to(device=device, dtype=dtype)
    model.load_state_dict(loaded, strict=True, assign=True)
    return model.eval()


@torch.no_grad()
def init_params(cfg: Qwen25VLConfig, generator: torch.Generator, device=None,
                dtype=torch.bfloat16) -> Qwen25VL:
    """A ``Qwen25VL`` with random weights made on ``device`` (default: the
    current CUDA device; the generator must live on the same device)."""
    device = default_device() if device is None else device
    model = Qwen25VL(cfg, device="meta", dtype=dtype).to_empty(device=device)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, RMSNorm)}
    for name, p in model.named_parameters():
        if id(p) in norms:
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model.eval()


def config_from_hf_json(model_dir: str) -> Qwen25VLConfig:
    """The port's config from an HF ``config.json`` on disk."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    text_src = hf.get("text_config", hf)
    vis = hf["vision_config"]
    text = TextConfig(
        vocab_size=text_src["vocab_size"],
        hidden_size=text_src["hidden_size"],
        intermediate_size=text_src["intermediate_size"],
        num_hidden_layers=text_src["num_hidden_layers"],
        num_attention_heads=text_src["num_attention_heads"],
        num_key_value_heads=text_src["num_key_value_heads"],
        rms_norm_eps=text_src.get("rms_norm_eps", 1e-6),
        rope_theta=text_src.get("rope_theta", 1e6),
        mrope_section=tuple(text_src["rope_scaling"]["mrope_section"]),
        tie_word_embeddings=hf.get("tie_word_embeddings", text_src.get("tie_word_embeddings", False)),
    )
    vision = VisionConfig(
        depth=vis.get("depth", 32),
        hidden_size=vis.get("hidden_size", 1280),
        intermediate_size=vis.get("intermediate_size", 3420),
        num_heads=vis.get("num_heads", 16),
        in_channels=vis.get("in_channels", vis.get("in_chans", 3)),
        patch_size=vis.get("patch_size", 14),
        spatial_merge_size=vis.get("spatial_merge_size", 2),
        temporal_patch_size=vis.get("temporal_patch_size", 2),
        tokens_per_second=vis.get("tokens_per_second", 2),
        window_size=vis.get("window_size", 112),
        out_hidden_size=vis.get("out_hidden_size", text.hidden_size),
        fullatt_block_indexes=tuple(vis.get("fullatt_block_indexes", (7, 15, 23, 31))),
    )
    return Qwen25VLConfig(
        text=text,
        vision=vision,
        image_token_id=hf.get("image_token_id", 151655),
        video_token_id=hf.get("video_token_id", 151656),
        vision_start_token_id=hf.get("vision_start_token_id", 151652),
        vision_end_token_id=hf.get("vision_end_token_id", 151653),
        eos_token_id=hf.get("eos_token_id", 151645),
    )


def load_params(model_dir: str, *, device=None, dtype=torch.bfloat16) -> Qwen25VL:
    """A ``Qwen25VL`` from a local HF checkpoint directory, on ``device``
    (default: the current CUDA device)."""
    from safetensors.torch import load_file

    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    state: Dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_file(f))
    cfg = config_from_hf_json(model_dir)
    return build_model(cfg, params_from_hf_state_dict(state, cfg), device=device, dtype=dtype)


def trainer_state_from_jax(cfg: Qwen25VLConfig, *, params, mu, nu, count: int, step: int,
                           compensation=None, moment_dtype=torch.float32,
                           param_dtype=torch.float32) -> Dict[str, Any]:
    """A JAX trainer's state (parameter tree, Adam moment trees, optimizer
    count, global step; numpy leaves) -> ``{"params", "opt_state", "step"}``
    in the layout ``GRPOTrainer.load_checkpoint`` reads from a checkpoint."""
    return {
        "params": {k: v.to(param_dtype) for k, v in params_from_jax(params, cfg).items()},
        "opt_state": optimizer_state_from_jax(
            cfg, count=count, mu=mu, nu=nu, compensation=compensation,
            moment_dtype=moment_dtype, param_dtype=param_dtype),
        "step": int(step),
    }
