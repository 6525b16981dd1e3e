"""The port's Qwen2.5-VL (tiny config, fp32, CPU) against the JAX package's on
the same weights: the vision tower, the text stack, the full multimodal
forward and the logits; and the two weight loaders against each other.

Tolerance: fp32 on both sides, the same math in a different summation order
through a few layers: atol/rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.data.packing import pack_vision_batch as jax_pack
from spatialthinker_tpu.models.qwen2_5_vl import forward as jax_forward
from spatialthinker_tpu.models.qwen2_5_vl import forward_hidden as jax_forward_hidden
from spatialthinker_tpu.models.qwen2_5_vl import VisionInputs as JaxVisionInputs
from spatialthinker_tpu.models.qwen2_5_vl import get_mrope_position_ids
from spatialthinker_tpu.models.qwen2_5_vl import logits_from_hidden as jax_logits
from spatialthinker_tpu.models.qwen2_5_vl import params_from_hf_state_dict as jax_from_hf
from spatialthinker_tpu.models.qwen2_5_vl import vision_forward as jax_vision_forward
from spatialthinker_torch.models.qwen2_5_vl import (
    VisionInputs, forward, forward_hidden, logits_from_hidden, params_from_hf_state_dict,
    params_from_jax, vision_forward,
)
from tests.test_torch_parity import CFG, JAX_CFG, both_models, to_torch

TOL = dict(atol=1e-4, rtol=1e-4)
GRIDS = [(1, 8, 12), (1, 6, 6)]  # two images, one with padded edge windows


@pytest.fixture(scope="module")
def models():
    return both_models(seed=0)


def _vision_pack(seed=0):
    rng = np.random.default_rng(seed)
    vc = CFG.vision
    dim = vc.in_channels * vc.temporal_patch_size * vc.patch_size ** 2
    patches = [rng.normal(size=(t * h * w, dim)).astype(np.float32) for t, h, w in GRIDS]
    grids = [np.asarray([g]) for g in GRIDS]
    return jax_pack(patches, grids, JAX_CFG.vision, granularity=64)


def test_vision_forward_matches_jax(models):
    jax_params, model = models
    pack = _vision_pack()
    ref = jax_vision_forward(
        jax_params["vision"], JAX_CFG.vision, *(jnp.asarray(a) for a in pack if a is not None)
    )
    got = vision_forward(model.vision, *(to_torch(a) for a in pack if a is not None))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def _text_inputs(seed=1, b=2, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(8, 900, size=(b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[1, :5] = 0  # left padding
    ids[1, :5] = 0
    pos = np.ones((3, b, s), np.int32)
    pos[:, 0] = np.arange(s)
    pos[:, 1, 5:] = np.arange(s - 5)
    return ids, seg, pos


def test_text_forward_hidden_matches_jax(models):
    jax_params, model = models
    ids, seg, pos = _text_inputs()
    ref, _ = jax_forward_hidden(
        jax_params["text"], JAX_CFG.text, input_ids=jnp.asarray(ids),
        position_ids=jnp.asarray(pos), segment_ids=jnp.asarray(seg),
    )
    with torch.no_grad():
        got, _ = forward_hidden(
            model.text, input_ids=to_torch(ids).long(), position_ids=to_torch(pos),
            segment_ids=to_torch(seg),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_multimodal_forward_and_logits_match_jax(models):
    jax_params, model = models
    cfg = CFG
    merged = sum(t * h * w for t, h, w in GRIDS) // cfg.vision.spatial_merge_unit
    rng = np.random.default_rng(2)
    text = lambda n: list(rng.integers(8, 900, size=n))  # noqa: E731
    first = GRIDS[0][1] * GRIDS[0][2] // 4
    row = (text(3) + [cfg.vision_start_token_id] + [cfg.image_token_id] * first
           + [cfg.vision_end_token_id] + text(2) + [cfg.vision_start_token_id]
           + [cfg.image_token_id] * (merged - first) + [cfg.vision_end_token_id] + text(4))
    ids = np.asarray([row], np.int32)
    pos, _ = get_mrope_position_ids(
        ids[0], np.asarray(GRIDS), spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id, video_token_id=cfg.video_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
    )
    pos = pos[:, None, :].astype(np.int32)
    seg = np.ones_like(ids)
    pack = _vision_pack()
    ref_h, _ = jax_forward(
        jax_params, JAX_CFG, jnp.asarray(ids), jnp.asarray(pos), segment_ids=jnp.asarray(seg),
        vision=JaxVisionInputs(*(jnp.asarray(a) for a in pack if a is not None)),
    )
    ref_logits = jax_logits(jax_params["text"], ref_h, JAX_CFG.text)
    with torch.no_grad():
        h, _ = forward(
            model, to_torch(ids).long(), to_torch(pos), segment_ids=to_torch(seg),
            vision=VisionInputs(*(to_torch(a) for a in pack if a is not None)),
        )
        logits = logits_from_hidden(model.text, h)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    assert logits.dtype == torch.float32


def _random_hf_state(cfg, seed=3):
    """A random HF-layout Qwen2.5-VL state dict for ``cfg`` (numpy)."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    tc, vc = cfg.text, cfg.vision
    e, d, h, hkv, inter = tc.hidden_size, tc.head_dim, tc.num_attention_heads, tc.num_key_value_heads, tc.intermediate_size
    st = {"model.embed_tokens.weight": r(tc.vocab_size, e), "model.norm.weight": r(e)}
    for i in range(tc.num_hidden_layers):
        p = f"model.layers.{i}."
        st.update({
            p + "self_attn.q_proj.weight": r(h * d, e), p + "self_attn.q_proj.bias": r(h * d),
            p + "self_attn.k_proj.weight": r(hkv * d, e), p + "self_attn.k_proj.bias": r(hkv * d),
            p + "self_attn.v_proj.weight": r(hkv * d, e), p + "self_attn.v_proj.bias": r(hkv * d),
            p + "self_attn.o_proj.weight": r(e, h * d),
            p + "mlp.gate_proj.weight": r(inter, e), p + "mlp.up_proj.weight": r(inter, e),
            p + "mlp.down_proj.weight": r(e, inter),
            p + "input_layernorm.weight": r(e), p + "post_attention_layernorm.weight": r(e),
        })
    ve, vi, unit = vc.hidden_size, vc.intermediate_size, vc.spatial_merge_unit
    st["visual.patch_embed.proj.weight"] = r(
        ve, vc.in_channels, vc.temporal_patch_size, vc.patch_size, vc.patch_size
    )
    for i in range(vc.depth):
        p = f"visual.blocks.{i}."
        st.update({
            p + "norm1.weight": r(ve), p + "norm2.weight": r(ve),
            p + "attn.qkv.weight": r(3 * ve, ve), p + "attn.qkv.bias": r(3 * ve),
            p + "attn.proj.weight": r(ve, ve), p + "attn.proj.bias": r(ve),
            p + "mlp.gate_proj.weight": r(vi, ve), p + "mlp.gate_proj.bias": r(vi),
            p + "mlp.up_proj.weight": r(vi, ve), p + "mlp.up_proj.bias": r(vi),
            p + "mlp.down_proj.weight": r(ve, vi), p + "mlp.down_proj.bias": r(ve),
        })
    st.update({
        "visual.merger.ln_q.weight": r(ve),
        "visual.merger.mlp.0.weight": r(unit * ve, unit * ve), "visual.merger.mlp.0.bias": r(unit * ve),
        "visual.merger.mlp.2.weight": r(vc.out_hidden_size, unit * ve),
        "visual.merger.mlp.2.bias": r(vc.out_hidden_size),
    })
    return st


def test_hf_loader_matches_jax_loader_through_params_from_jax():
    """The port's HF loader and (JAX HF loader -> params_from_jax) give the
    same state dict, key for key, bit for bit."""
    hf = _random_hf_state(CFG)
    ours = params_from_hf_state_dict(hf, CFG)
    jax_tree = jax_from_hf(hf, JAX_CFG, dtype=jnp.float32)
    carried = params_from_jax(jax.tree.map(np.asarray, jax_tree), CFG)
    assert ours.keys() == carried.keys()
    for key in ours:
        torch.testing.assert_close(ours[key], carried[key], atol=0, rtol=0, msg=key)
