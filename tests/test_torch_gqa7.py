"""An odd query group, G = 7 (the 7B preset's 28 query heads over 4 kv
heads), on the CPU: the tiny preset widened to 14 query heads over 2 kv
heads (hidden 224, head_dim 16), carried from the JAX package.

- the paged engine's greedy decode against JAX's ``generate_paged``, token
  for token, with bf16 pools (log-probs within 2e-3, the port's plain
  version rounding softmax weights per page; with its exact gathered
  attention within 1e-4) and with int4 pools and ``int4_i8dot`` (the exact
  gathered attention on the port's side, as
  ``tests/test_torch_paged_engine.py`` holds it: token for token, 1e-4);
- the packed update's log-probs (1e-4) and gradients (2e-4 of each leaf's
  largest magnitude) against JAX's ``make_packed_grad_fn``, at
  ``tests/test_torch_train_step.py``'s tolerances, under ``remat="dots"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl import init_params as jax_init_params
from spatialthinker_tpu.rollout import paged as jp
from spatialthinker_tpu.rollout.sampling import SamplingParams as JaxSamplingParams
from spatialthinker_tpu.trainer import train_step as jts
from spatialthinker_torch.data.text_packing import pack_train_rows
from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax
from spatialthinker_torch.models.qwen2_5_vl.params import params_to_jax
from spatialthinker_torch.trainer import train_step as tts
from tests.test_torch_paged_engine import JAX_KV, R, _assert_same, _exact_attention, _prompts, _run
from tests.test_torch_parity import CFG, JAX_CFG
from tests.test_torch_train_step import KNOBS, TOL, _grads_close, _micro, _torch_batch, rollout_arrays

torch.set_num_threads(2)


def _g7(cfg):
    text = dataclasses.replace(cfg.text, hidden_size=224, num_attention_heads=14, num_key_value_heads=2)
    return dataclasses.replace(cfg, text=text, vision=dataclasses.replace(cfg.vision, out_hidden_size=224))


JAX_G7, G7 = _g7(JAX_CFG), _g7(CFG)


@pytest.fixture(scope="module")
def models():
    """(JAX params, port model) with equal random fp32 weights."""
    rng = np.random.default_rng(7)
    template = jax_init_params(JAX_G7, jax.random.key(0), jnp.float32)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if "norm" in name or "ln_q" in name:
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.05 * rng.normal(size=leaf.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, template)
    model = build_model(G7, params_from_jax(tree, G7), device="cpu", dtype=torch.float32)
    return jax.tree.map(jnp.asarray, tree), model


def test_the_config_has_an_odd_group(models):
    assert G7.text.num_attention_heads // G7.text.num_key_value_heads == 7 and G7.text.head_dim == 16
    assert models[1].text.layers[0].self_attn.qkv_proj.weight.shape == (2 * (7 + 2) * 16, 224)


def _jax_greedy(params, prompts, kv, **kw):
    return jp.generate_paged(params, JAX_G7, *prompts, sampling=JaxSamplingParams(temperature=0.0),
                             key=jax.random.key(0), kv_cache_dtype=JAX_KV[kv], max_new_tokens=R, **kw)


def test_paged_greedy_matches_jax_bf16_pools(models, monkeypatch):
    jax_params, model = models
    prompts = _prompts(4)
    kw = dict(slots=4, decode_chunk_size=2, page_size=4, group_n=2)
    ref = _jax_greedy(jax_params, prompts, "bf16", **kw)
    _assert_same(_run(model, prompts, "bf16", **kw), ref, logp_atol=2e-3)
    from spatialthinker_torch.rollout import paged as tp

    monkeypatch.setattr(tp, "paged_attention", _exact_attention)
    _assert_same(_run(model, prompts, "bf16", **kw), ref, logp_atol=1e-4)


def test_paged_greedy_matches_jax_int4_i8dot_pools(models, monkeypatch):
    jax_params, model = models
    prompts = _prompts(5)
    kw = dict(slots=4, decode_chunk_size=3, page_size=4, int4_i8dot=True)
    ref = _jax_greedy(jax_params, prompts, "int4", **kw)
    plain = _run(model, prompts, "int4", **kw)
    assert (plain.responses[:, 0] == np.asarray(ref.responses)[:, 0]).all()  # the prefill's token
    from spatialthinker_torch.rollout import paged as tp

    monkeypatch.setattr(tp, "paged_attention", _exact_attention)
    _assert_same(_run(model, prompts, "int4", **kw), ref)


@pytest.mark.parametrize("remat", ["dots", False])
def test_packed_log_probs_and_gradients_match_jax(models, remat):
    jax_params, model = models
    a = rollout_arrays(6, False)
    a["input_ids"] = np.minimum(a["input_ids"], G7.text.vocab_size - 6)
    per_token = {k: a[k] for k in ("old_log_probs", "ref_log_probs", "advantages")}
    packed, _ = pack_train_rows(a["input_ids"], a["segment_ids"], a["position_ids"], a["responses"],
                                a["response_mask"], a["gen_pos_start"], per_token, 40)
    n_rows = packed.input_ids.shape[0]
    jbatch = jts.PackedTrainBatch(*(jnp.asarray(x) for x in packed))
    ref_rows = jts.compute_packed_log_probs(jax_params, JAX_G7, jbatch, None, chunk_size=16, temperature=0.9)[0]
    with torch.no_grad():
        got_rows = tts.compute_packed_log_probs(model, _torch_batch(tts.PackedTrainBatch, packed._asdict()),
                                                None, chunk_size=16, temperature=0.9)[0]
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(ref_rows), **TOL)

    pb = {k: _micro(v, n_rows) for k, v in packed._asdict().items()}
    jgrad = jax.jit(jts.make_packed_grad_fn(JAX_G7, **{**KNOBS, "remat": remat}))
    ref_grads, ref_metrics, _, ref_factor = jgrad(
        jax_params, jts.PackedTrainBatch(**{k: jnp.asarray(v) for k, v in pb.items()}), None)
    grads, metrics, finite, factor = tts.make_packed_grad_fn(model, remat=remat, **KNOBS)(
        _torch_batch(tts.PackedTrainBatch, pb), None)
    assert finite
    np.testing.assert_allclose(factor, float(ref_factor), rtol=1e-4)
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), err_msg=k, **TOL)
    got = params_to_jax(grads, G7)
    _grads_close(got, ref_grads)
