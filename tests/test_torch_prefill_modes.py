"""``prefill_forward`` of the port in its four modes — one forward, sequence
chunks (``prefill_chunk``), row groups (``prefill_rows``) and both — against
the JAX package's ``prefill_forward`` in the same mode, on image and text
prompts with left padding, into a bf16 and into an int4 cache.

Tolerances (fp32 weights on both sides, two layers):
- last-position hidden states within 2e-4 with the bf16 cache: the chunked
  modes attend the bf16-rounded cache prefix, and a k/v value that sits on a
  bf16 rounding boundary may round the other way in the other framework;
- within 2e-2 with the int4 cache, where such a value moves by a whole int4
  step (1/7 of its token's max) before the next chunk attends it;
- the caches themselves, dequantized: every cell within one quantization
  step, and fewer than 1 in 1000 cells differing at all;
- row groups against the unsplit batch in the port: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl.model import prefill_forward as jax_prefill_forward
from spatialthinker_tpu.models.qwen2_5_vl.text import KVCache as JaxKVCache
from spatialthinker_tpu.models.qwen2_5_vl.text import _layer_kv as jax_layer_kv
from spatialthinker_torch.models.qwen2_5_vl import VisionInputs, prefill_forward
from spatialthinker_torch.models.qwen2_5_vl.text import KVCache, _layer_kv
from tests.test_torch_parity import CFG, JAX_CFG, to_torch
from tests.test_torch_rollout import _engine_inputs, _vision
from tests.test_torch_rollout import batch, models  # noqa: F401  (fixtures)

torch.set_num_threads(2)

MODES = {"whole": {}, "chunk": {"prefill_chunk": 16}, "rows": {"prefill_rows": 2},
         "rows+chunk": {"prefill_rows": 2, "prefill_chunk": 16}}
MARKERS = {"bf16": (jnp.bfloat16, torch.bfloat16), "int4": (jnp.uint8, torch.uint8)}
HIDDEN_ATOL = {"bf16": 2e-4, "int4": 2e-2}


def _run_port(model, batch, marker, text_only, **mode):
    ids, seg, pos, _ = (to_torch(a) for a in _engine_inputs(batch))
    vision = None if text_only else VisionInputs(*(to_torch(a) for a in _vision(batch)[:5]))
    if text_only:
        ids = torch.where(ids == CFG.image_token_id, torch.full_like(ids, 7), ids)
    t = CFG.text
    b, p = ids.shape
    cache = KVCache.init(t.num_hidden_layers, b, p, t.num_key_value_heads, t.head_dim,
                         dtype=marker, device="cpu")
    seg32 = seg.to(torch.int32)
    with torch.no_grad():
        hidden, cache = prefill_forward(model, ids, pos, seg32, cache, seg32, vision=vision, **mode)
    assert cache.length == p
    return hidden[:, -1].numpy(), cache


def _run_jax(params, batch, marker, text_only, **mode):
    ids, seg, pos, _ = (jnp.asarray(a) for a in _engine_inputs(batch))
    vision = None if text_only else jax.tree.map(jnp.asarray, _vision(batch))
    if text_only:
        ids = jnp.where(ids == JAX_CFG.image_token_id, 7, ids)
    t = JAX_CFG.text
    b, p = ids.shape
    cache = JaxKVCache.init(t.num_hidden_layers, b, p, t.num_key_value_heads, t.head_dim, dtype=marker)
    seg32 = seg.astype(jnp.int32)
    hidden, cache = jax_prefill_forward(params, JAX_CFG, ids, pos, seg32, cache, seg32, vision=vision, **mode)
    return np.asarray(hidden[:, -1]), cache


def _dense(cache, layer, jax_side):
    """(k, v) of one layer, dequantized to fp32 (B, S, Hkv, D)."""
    fn, dt = (jax_layer_kv, jnp.float32) if jax_side else (_layer_kv, torch.float32)
    k, v = fn(cache.k, cache.v, layer, dt, cache.k_scale, cache.v_scale)
    return np.asarray(k, np.float32) if jax_side else k.float().numpy(), \
        np.asarray(v, np.float32) if jax_side else v.float().numpy()


def _check_cache(a, b, kind, valid):
    step = 1 / 7 if kind == "int4" else 2**-7  # of the token's max / one bf16 ulp of the value
    for x, y in zip(a, b):
        x, y = x[valid], y[valid]
        scale = np.abs(y).max(axis=-1, keepdims=True) if kind == "int4" else np.abs(y) + 1e-6
        assert np.all(np.abs(x - y) <= 1.01 * step * scale + 1e-6)
        assert (x != y).mean() < 1e-3


@pytest.mark.parametrize("text_only", [False, True], ids=["image", "text"])
@pytest.mark.parametrize("kind", list(MARKERS))
@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_mode_matches_jax(models, batch, mode, kind, text_only):
    jax_params, model = models
    jm, tm = MARKERS[kind]
    ref_h, ref_c = _run_jax(jax_params, batch, jm, text_only, **MODES[mode])
    got_h, got_c = _run_port(model, batch, tm, text_only, **MODES[mode])
    np.testing.assert_allclose(got_h, ref_h, rtol=0, atol=HIDDEN_ATOL[kind])
    valid = np.asarray(_engine_inputs(batch)[1]).astype(bool)
    for layer in range(CFG.text.num_hidden_layers):
        _check_cache(_dense(got_c, layer, False), _dense(ref_c, layer, True), kind, valid)
    if kind == "int4":  # same bytes where the values agree: one cache serves both packages
        same = (got_c.k.numpy() == np.asarray(ref_c.k)).mean()
        assert same > 0.999, same


@pytest.mark.parametrize("kind", list(MARKERS))
def test_row_groups_change_nothing(models, batch, kind):
    """Row groups only split the batch: rows == whole and rows+chunk == chunk
    to 1e-5 (each row sees the same arithmetic; a matmul over fewer rows may
    block its reduction differently), with equal caches. Sequence chunks DO
    change the result — later chunks attend the cache's rounded prefix, not
    the fp32 k/v — so whole and chunk are only held to the JAX package above."""
    _, model = models
    valid = np.asarray(_engine_inputs(batch)[1]).astype(bool)
    for base, split in (("whole", "rows"), ("chunk", "rows+chunk")):
        base_h, base_c = _run_port(model, batch, MARKERS[kind][1], False, **MODES[base])
        h, c = _run_port(model, batch, MARKERS[kind][1], False, **MODES[split])
        np.testing.assert_allclose(h, base_h, rtol=0, atol=1e-5, err_msg=split)
        for layer in range(CFG.text.num_hidden_layers):
            _check_cache(_dense(c, layer, False), _dense(base_c, layer, False), kind, valid)
    assert float(np.abs(base_h).max()) > 0.5  # the tolerances are far below the signal
