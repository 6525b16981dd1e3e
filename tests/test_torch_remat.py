"""``remat="dots"`` (``sharding.remat_policy=dots``, the JAX default) on the
CPU: the selective checkpoint of ``models/qwen2_5_vl/text.checkpointed``.

- ``dots``, ``full`` and True give bit-equal gradients on the tiny preset
  (unpacked multimodal and packed rows): the policy changes what is kept,
  never a value;
- under ``dots`` the forward of one decoder layer keeps exactly its four
  weight products (qkv ``addmm``, o / gate_up / down ``mm``) and one vision
  block its five (qkv, proj, gate, up, down, all ``addmm``); the backward
  runs the attention forward again (two calls, as under ``full``; one
  without checkpointing), into new buffers;
- the packed update under ``dots`` against the JAX package's
  ``make_packed_update_fn(remat="dots")``, at
  ``tests/test_torch_train_step.py``'s tolerances (metrics 1e-4, parameters
  in units of lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from spatialthinker_tpu.data import packing as jpk
from spatialthinker_tpu.data.text_packing import pack_train_rows as jax_pack_train_rows
from spatialthinker_tpu.trainer import train_step as jts
from spatialthinker_torch.data import packing as tpk
from spatialthinker_torch.data.text_packing import pack_train_rows
from spatialthinker_torch.models.qwen2_5_vl import text as ttext
from spatialthinker_torch.models.qwen2_5_vl import vision as tvision
from spatialthinker_torch.models.qwen2_5_vl.rope import compute_cos_sin, make_inv_freq
from spatialthinker_torch.trainer import train_step as tts
from tests.test_torch_parity import CFG, JAX_CFG, both_models
from tests.test_torch_train_step import (
    KNOBS, LR, TOL, _jax_vision, _micro, _params_close, _torch_batch, _torch_vision, _vision,
    rollout_arrays, train_batch_arrays,
)


def _packed(a, row_len):
    per_token = {k: a[k] for k in ("old_log_probs", "ref_log_probs", "advantages")}
    args = (a["input_ids"], a["segment_ids"], a["position_ids"], a["responses"], a["response_mask"],
            a["gen_pos_start"], per_token, row_len)
    packed, slot_map = pack_train_rows(*args)
    n_rows = packed.input_ids.shape[0]
    rows_of = [[i for i in sorted(range(len(a["responses"])), key=lambda i: int(slot_map.dst_start[i]))
                if slot_map.row[i] == g] for g in range(n_rows)]
    return packed, jax_pack_train_rows(*args)[0], n_rows, rows_of


@pytest.mark.parametrize("layout", ["unpacked_multimodal", "packed_multimodal", "packed_text"])
def test_dots_and_full_give_bit_equal_gradients(layout):
    _, model = both_models(seed=11)
    a = rollout_arrays(12, layout != "packed_text")
    if layout == "unpacked_multimodal":
        batch = _torch_batch(tts.TrainBatch, {k: _micro(v, 2) for k, v in train_batch_arrays(a).items()})
        vision = _torch_vision(tpk.stack_vision_packs(
            [_vision(tpk, CFG.vision, a, h) for h in ([0, 1], [2, 3])], CFG.vision))
        make = tts.make_grad_fn
    else:
        packed, _, n_rows, rows_of = _packed(a, 64 if layout == "packed_multimodal" else 40)
        batch = _torch_batch(tts.PackedTrainBatch, {k: _micro(v, n_rows) for k, v in packed._asdict().items()})
        vision = (_torch_vision(tpk.stack_vision_packs([_vision(tpk, CFG.vision, a, r) for r in rows_of],
                                                       CFG.vision))
                  if layout == "packed_multimodal" else None)
        make = tts.make_packed_grad_fn
    grads = {remat: make(model, remat=remat, **KNOBS)(batch, vision)[0] for remat in ("full", "dots", True)}
    assert grads["dots"].keys() == dict(model.named_parameters()).keys()
    for name in grads["full"]:
        assert torch.equal(grads["full"][name], grads["dots"][name]), name
        assert torch.equal(grads[True][name], grads["dots"][name]), name
    assert any(float(g.abs().max()) > 0 for g in grads["dots"].values())


def _count_policy(monkeypatch):
    """Wrap ``dots_policy``: the ops it keeps in the first forward."""
    kept = []
    real = ttext.dots_policy

    def counting(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(str(op))
        return decision

    monkeypatch.setattr(ttext, "dots_policy", counting)
    return kept


def _count_attention(monkeypatch, module):
    calls = []
    real = module.attention

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "attention", counted)
    return calls


@pytest.mark.parametrize("remat,kept_ops,attention_calls", [
    ("dots", ["aten.addmm.default", "aten.mm.default", "aten.mm.default", "aten.mm.default"], 2),
    ("full", [], 2),
    (False, [], 1),
], ids=["dots", "full", "none"])
def test_decoder_layer_keeps_exactly_its_weight_products(monkeypatch, remat, kept_ops, attention_calls):
    _, model = both_models(seed=13)
    kept, calls = _count_policy(monkeypatch), _count_attention(monkeypatch, ttext)
    layer, cfg = model.text.layers[0], CFG.text
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, 12, cfg.hidden_size)).astype(np.float32), requires_grad=True)
    pos = torch.arange(12).repeat(3, 2, 1)
    inv = torch.as_tensor(make_inv_freq(cfg.head_dim, cfg.rope_theta), dtype=torch.float32)
    cos, sin = compute_cos_sin(pos, inv, cfg.mrope_section, dtype=x.dtype)
    seg = torch.ones(2, 12, dtype=torch.int32)
    if remat:
        out = ttext.checkpointed(layer, remat, x, cos, sin, seg, None, 0)
    else:
        out = layer(x, cos, sin, seg, None, 0)
    out.square().sum().backward()
    assert kept == kept_ops
    assert len(calls) == attention_calls
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_vision_block_keeps_exactly_its_weight_products(monkeypatch):
    _, model = both_models(seed=14)
    kept, calls = _count_policy(monkeypatch), _count_attention(monkeypatch, tvision)
    block, cfg = model.vision.blocks[0], CFG.vision
    rng = np.random.default_rng(1)
    n = 16
    x = torch.tensor(rng.normal(size=(n, cfg.hidden_size)).astype(np.float32), requires_grad=True)
    cos = torch.tensor(rng.normal(size=(1, n, 1, cfg.head_dim)).astype(np.float32))
    sin = torch.tensor(rng.normal(size=(1, n, 1, cfg.head_dim)).astype(np.float32))
    seg = torch.ones(1, n, dtype=torch.int32)
    ttext.checkpointed(block, "dots", x, cos, sin, seg).square().sum().backward()
    n_linear = sum(isinstance(m, torch.nn.Linear) for m in block.modules())
    assert kept == ["aten.addmm.default"] * n_linear and n_linear == 5
    assert len(calls) == 2


@pytest.mark.parametrize("multimodal", [False, True], ids=["text", "multimodal"])
def test_packed_update_under_dots_matches_jax(multimodal):
    jax_params, model = both_models(seed=15)
    a = rollout_arrays(16, multimodal)
    packed, ref_packed, n_rows, rows_of = _packed(a, 64 if multimodal else 40)
    pb = {k: _micro(v, n_rows) for k, v in packed._asdict().items()}
    jvis = tvis = None
    if multimodal:
        jvis = jpk.stack_vision_packs([_vision(jpk, JAX_CFG.vision, a, r) for r in rows_of], JAX_CFG.vision)
        tvis = tpk.stack_vision_packs([_vision(tpk, CFG.vision, a, r) for r in rows_of], CFG.vision)
    jopt = jts.make_optimizer(LR)
    jbatch = jts.PackedTrainBatch(**{k: jnp.asarray(_micro(v, n_rows)) for k, v in ref_packed._asdict().items()})
    new_params, _, ref_metrics = jax.jit(jts.make_packed_update_fn(JAX_CFG, jopt, remat="dots", **KNOBS))(
        jax_params, jopt.init(jax_params), jbatch, _jax_vision(jvis))
    metrics = tts.make_packed_update_fn(model, tts.make_optimizer(LR), remat="dots", **KNOBS)(
        _torch_batch(tts.PackedTrainBatch, pb), _torch_vision(tvis))
    assert metrics.keys() == ref_metrics.keys()
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), err_msg=k, **TOL)
    _params_close(model, new_params, LR)


def test_remat_policy_names():
    assert [ttext.remat_policy(r) for r in (False, None, True, "full", "dots")] == [None, None, "dots", "full",
                                                                                  "dots"]
    with pytest.raises(ValueError, match="remat"):
        ttext.remat_policy("some")
