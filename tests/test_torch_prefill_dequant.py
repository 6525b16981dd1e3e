"""The prefill-dequant mode, ``quantize_model(prefill_dequant_min_m=m)``,
against the JAX package's ``SPATIALTHINKER_PREFILL_DEQUANT_M=m`` (set with
``monkeypatch.setenv``), on both sides of the threshold, on the CPU.

At m rows or more every quantized product (qkv, o, gate_up, down, the tied
head) dequantizes its weight and runs a bf16 product on both sides; below m,
and with the default 0, the W8A8 path runs. Tolerances: the W8A8 logits
within 1e-4 (int32 dots exact, fp32 scale products; the activation amax in
another order), the bf16 logits within 2e-3 of the largest |logit| (bf16
products of the same bf16 operands, rounded at the same points; the weight
scales may differ by one fp32 ulp before the bf16 cast). The int8 path
differs from the bf16 one by several times that on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl import model as jm
from spatialthinker_tpu.ops import quant as jq
from spatialthinker_torch.models.qwen2_5_vl import forward, logits_from_hidden
from spatialthinker_torch.ops import quant as tq
from tests.test_torch_parity import JAX_CFG, both_models

torch.set_num_threads(2)

B, S = 2, 16  # 32 rows a product
N_PRODUCTS = 4 * JAX_CFG.text.num_hidden_layers + 1  # per layer qkv, o, gate_up, down; the head


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 900, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32)[None, None], (3, B, 1))
    return ids, pos, np.ones((B, S), np.int32)


def _count(monkeypatch, module):
    calls = []
    real = module.dequantize_weight

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "dequantize_weight", counted)
    return calls


def _port_logits(qmodel, ids, pos, seg):
    with torch.no_grad():
        hidden, _ = forward(qmodel, torch.as_tensor(ids).long(), torch.as_tensor(pos).long(),
                            segment_ids=torch.as_tensor(seg))
        return logits_from_hidden(qmodel.text, hidden).float().numpy()


@pytest.mark.parametrize("min_m,dequant", [(16, True), (32, True), (33, False), (0, False)],
                         ids=["above", "at", "below", "off"])
def test_prefill_dequant_matches_jax(monkeypatch, min_m, dequant):
    jax_params, model = both_models(seed=8)
    ids, pos, seg = _inputs()
    monkeypatch.setenv("SPATIALTHINKER_PREFILL_DEQUANT_M", str(min_m))
    j_calls, t_calls = _count(monkeypatch, jq), _count(monkeypatch, tq)
    qparams = jq.quantize_params(jax_params, mode="int8")
    want = np.asarray(jm.forward_logits(qparams, JAX_CFG, jnp.asarray(ids), jnp.asarray(pos),
                                        segment_ids=jnp.asarray(seg))[0], dtype=np.float32)
    qmodel = tq.quantize_model(model, prefill_dequant_min_m=min_m)
    got = _port_logits(qmodel, ids, pos, seg)
    # the JAX layers run in one scan, whose body is traced once
    assert (len(j_calls), len(t_calls)) == ((4 + 1, N_PRODUCTS) if dequant else (0, 0))
    scale = np.abs(want).max()
    if dequant:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * scale)
        w8a8 = _port_logits(tq.quantize_model(model), ids, pos, seg)  # the default: off
        assert np.abs(w8a8 - got).max() > 3 * 2e-3 * scale
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_threshold_rides_on_the_weights_and_the_junction_steps_aside():
    _, model = both_models(seed=9)
    q = tq.quantize_model(model, prefill_dequant_min_m=2048)
    layer = q.text.layers[0]
    assert layer.self_attn.qkv_proj.weight["dequant_min_m"] == 2048
    assert q.text.embed_tokens.weight["dequant_min_m"] == 2048
    assert tq.quantize_model(model).text.layers[0].mlp.down_proj.weight["dequant_min_m"] == 0
    down = layer.mlp.down_proj.weight
    gu = torch.randn(1024, 2 * down["qvalue"].shape[1])
    assert tq.fused_silu_quant_dot(gu, down, torch.float32) is not None  # 1,024 rows: below 2,048
    assert tq.fused_silu_quant_dot(torch.randn(2048, gu.shape[1]), down, torch.float32) is None
    x = torch.randn(3, down["qvalue"].shape[1])
    w = tq.dequantize_weight(down, 1)
    assert w.dtype == torch.bfloat16 and w.shape == down["qvalue"].shape
    torch.testing.assert_close(tq.quantized_dot(x, {**down, "dequant_min_m": 3}, 1),
                               (x.bfloat16() @ w.t()).float(), rtol=0, atol=0)
