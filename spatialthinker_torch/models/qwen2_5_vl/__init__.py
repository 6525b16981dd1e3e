from .config import Qwen25VLConfig, TextConfig, VisionConfig, get_config, qwen25_vl_3b, qwen25_vl_7b, qwen25_vl_tiny
from .host import (
    VisionAux, VisionInputs, apply_patch_layout, get_mrope_position_ids, layout_patch_count,
    pad_vision_inputs, prepare_vision_aux, window_patch_len,
)
from .model import Qwen25VL, embed_inputs, fanout_rows, forward, merge_multimodal_embeds, prefill_forward, vision_to_device
from .params import build_model, init_params, load_params, params_from_hf_state_dict, params_from_jax
from .text import KVCache, forward_hidden, logits_from_hidden
from .vision import vision_forward

__all__ = [
    "Qwen25VLConfig", "TextConfig", "VisionConfig", "get_config",
    "qwen25_vl_3b", "qwen25_vl_7b", "qwen25_vl_tiny",
    "VisionAux", "VisionInputs", "apply_patch_layout", "get_mrope_position_ids",
    "layout_patch_count", "pad_vision_inputs", "prepare_vision_aux", "window_patch_len",
    "Qwen25VL", "embed_inputs", "fanout_rows", "forward", "merge_multimodal_embeds",
    "prefill_forward", "vision_to_device",
    "build_model", "init_params", "load_params", "params_from_hf_state_dict", "params_from_jax",
    "KVCache", "forward_hidden", "logits_from_hidden", "vision_forward",
]
