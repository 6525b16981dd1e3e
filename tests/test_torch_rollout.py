"""The port's dense rollout engine and sampling helpers against the JAX
package's, on the tiny config with images and left-padded prompts.

- greedy ``generate`` must match token for token (n=1 and grouped n=2), and
  its log-probs within 1e-4 (fp32 on both sides through a few layers);
- a sampled grouped call cannot match tokens (the two frameworks' generators
  differ), so its log-probs are held against the JAX model's teacher-forced
  log-probs of the same tokens. Teacher forcing attends fp32 k/v, while both
  engines decode from a bf16 KV cache (rollout.kv_cache_dtype: bfloat16) and
  round the query and softmax weights to bf16 there: about 3e-3 apart on
  this config, so atol 1e-2;
- greedy ``generate`` over an int8 and an int4 cache (n=1 and n=2, whole,
  sequence-chunked and rows-mode prefill): on the CPU the JAX engine decodes
  through its exact dequantizing fallback, so with the port's decode
  attention swapped for an exact dequantizing reference the engines must
  match token for token (the cache bytes are the same), log-probs within
  2e-3 (a chunked prefill attends its own dequantized KV; an int4 step on a
  rounding boundary moves a logit by that much, as in
  ``tests/test_torch_prefill_modes.py``). With the port's own plain versions
  (the kernels' arithmetic: bf16 weights, and with ``int4_i8dot`` int8
  rounding of q and of the softmax weights, ~0.4% of a row max each) the
  first token is equal and the log-probs of the tokens both engines chose
  stay within 2e-2;
- the sampling helpers match the JAX ones on the same logits: the masks
  exactly, log-probs within 1e-6 (fp32, one reduction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.core.config import DataConfig
from spatialthinker_tpu.data.dataset import RLHFDataset as JaxDataset
from spatialthinker_tpu.data.dataset import collate_fn as jax_collate
from spatialthinker_tpu.data.packing import pack_vision_batch as jax_pack
from spatialthinker_tpu.models.qwen2_5_vl import forward_logits as jax_forward_logits
from spatialthinker_tpu.rollout import sampling as jax_sampling
from spatialthinker_tpu.rollout.engine import generate as jax_generate
from spatialthinker_torch.models.qwen2_5_vl import VisionInputs
from spatialthinker_torch.models.qwen2_5_vl import text as torch_text
from spatialthinker_torch.ops import decode_attention as da
from spatialthinker_torch.rollout import sampling
from spatialthinker_torch.rollout.engine import generate
from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer
from tests.test_torch_parity import CFG, DATA_KW, JAX_CFG, both_models, random_image, to_torch

R = 8


@pytest.fixture(scope="module")
def models():
    return both_models(seed=1)


def _rows():
    return [
        {"problem": "<image>Where is the red cup relative to the plate?", "image": [random_image(0)]},
        {"problem": "Count the chairs.", "image": []},
        {"problem": "<image>Is the lamp above the table?", "image": [random_image(1, 56, 112)]},
    ]


@pytest.fixture(scope="module")
def batch():
    # CRC-32 word ids: the same prompts in every process
    ds = JaxDataset.from_rows(
        _rows(), QwenSyntheticTokenizer(CFG), DataConfig(max_prompt_length=48, **DATA_KW), JAX_CFG
    )
    return jax_collate([ds[i] for i in range(len(ds))])


def _vision(batch, n=1):
    rep = lambda xs: [x for x in xs for _ in range(n)]  # noqa: E731
    return jax_pack(
        rep(batch.non_tensors["patches"]), rep(batch.non_tensors["image_grid_thw"]),
        JAX_CFG.vision, granularity=64,
    )


def _engine_inputs(batch):
    t = batch.tensors
    return (t["input_ids"], t["segment_ids"], np.transpose(t["position_ids"], (1, 0, 2)),
            t["gen_pos_start"])


@pytest.mark.parametrize("n", [1, 2])
def test_greedy_generate_matches_jax(models, batch, n):
    jax_params, model = models
    inputs = _engine_inputs(batch)
    pack = _vision(batch)
    ref = jax_generate(
        jax_params, JAX_CFG, *(jnp.asarray(a) for a in inputs),
        max_new_tokens=R, sampling=jax_sampling.SamplingParams(temperature=0.0),
        key=jax.random.key(0), vision=jax.tree.map(jnp.asarray, pack), n=n,
    )
    got = generate(
        model, *(to_torch(a) for a in inputs), max_new_tokens=R,
        sampling=sampling.SamplingParams(temperature=0.0), generator=torch.Generator().manual_seed(0),
        vision=VisionInputs(*(to_torch(a) for a in pack[:5])), n=n,
    )
    assert got.responses.shape == (3 * n, R)
    np.testing.assert_array_equal(got.responses.numpy(), np.asarray(ref.responses))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(ref.response_mask))
    np.testing.assert_allclose(
        got.rollout_log_probs.numpy(), np.asarray(ref.rollout_log_probs), atol=1e-4, rtol=1e-4
    )


JAX_KV = {"int8": jnp.int8, "int4": jnp.uint8}
TORCH_KV = {"int8": torch.int8, "int4": torch.uint8}


def _exact_decode(q, k_cache, v_cache, kv_seg, layer_idx, k_scale=None, v_scale=None, scale=None,
                  int4_i8dot=False):
    """Dequantize the layer, one exact masked softmax in fp32 (the JAX
    package's ``_xla_decode``)."""
    k_l, v_l = torch_text._layer_kv(k_cache, v_cache, layer_idx, q.dtype, k_scale, v_scale)
    as_stack = lambda t: t.transpose(1, 2)[None].float()  # noqa: E731  (1, B, Hkv, S, D)
    return da.decode_attention_plain(q.float(), as_stack(k_l), as_stack(v_l), kv_seg, 0,
                                     scale if scale is not None else q.shape[-1] ** -0.5).to(q.dtype)


def _quantized_runs(models, batch, kv, n, i8dot=False, **prefill):
    jax_params, model = models
    inputs = _engine_inputs(batch)
    pack = _vision(batch)
    ref = jax_generate(
        jax_params, JAX_CFG, *(jnp.asarray(a) for a in inputs),
        max_new_tokens=R, sampling=jax_sampling.SamplingParams(temperature=0.0),
        key=jax.random.key(0), vision=jax.tree.map(jnp.asarray, pack), n=n,
        kv_cache_dtype=JAX_KV[kv], int4_i8dot=i8dot, **prefill,
    )

    def run():
        return generate(
            model, *(to_torch(a) for a in inputs), max_new_tokens=R,
            sampling=sampling.SamplingParams(temperature=0.0), generator=torch.Generator().manual_seed(0),
            vision=VisionInputs(*(to_torch(a) for a in pack[:5])), n=n,
            kv_cache_dtype=TORCH_KV[kv], int4_i8dot=i8dot, **prefill,
        )

    return ref, run


@pytest.mark.parametrize("prefill", [{}, {"prefill_chunk": 16}, {"prefill_rows": 2},
                                     {"prefill_rows": 2, "prefill_chunk": 16}],
                         ids=["whole", "chunked", "rows", "rows_chunked"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_greedy_quantized_cache_matches_jax(models, batch, kv, n, prefill, monkeypatch):
    ref, run = _quantized_runs(models, batch, kv, n, **prefill)
    monkeypatch.setattr(torch_text, "decode_attention", _exact_decode)
    got = run()
    assert got.responses.shape == (3 * n, R)
    np.testing.assert_array_equal(got.responses.numpy(), np.asarray(ref.responses))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(ref.response_mask))
    np.testing.assert_allclose(got.rollout_log_probs.numpy(), np.asarray(ref.rollout_log_probs),
                               atol=2e-3, rtol=0)


@pytest.mark.parametrize("kv,i8dot", [("int8", False), ("int4", False), ("int4", True)],
                         ids=["int8", "int4", "int4_i8dot"])
def test_greedy_quantized_cache_plain_versions_stay_close_to_jax(models, batch, kv, i8dot):
    """The same runs through the port's own plain versions (what its kernels
    compute), grouped n=2: the first token comes from the prefill alone."""
    ref, run = _quantized_runs(models, batch, kv, 2, i8dot=i8dot)
    got = run()
    same = got.responses.numpy() == np.asarray(ref.responses)
    assert same[:, 0].all()
    agree = np.cumprod(same, axis=1).astype(bool) & np.asarray(ref.response_mask, bool)
    assert agree.mean() > 0.5
    np.testing.assert_allclose(got.rollout_log_probs.numpy()[agree], np.asarray(ref.rollout_log_probs)[agree],
                               rtol=0, atol=2e-2)


def test_sampled_grouped_logprobs_match_jax_teacher_forcing(models, batch):
    jax_params, model = models
    n, temp = 2, 1.0
    ids, seg, pos, gen_start = _engine_inputs(batch)
    got = generate(
        model, *(to_torch(a) for a in (ids, seg, pos, gen_start)), max_new_tokens=R,
        sampling=sampling.SamplingParams(temperature=temp), generator=torch.Generator().manual_seed(3),
        vision=VisionInputs(*(to_torch(a) for a in _vision(batch)[:5])), n=n,
    )
    resp = got.responses.numpy()
    mask = got.response_mask.numpy()
    # teacher-force prompt + sampled response through the JAX model, lanes i*n+j
    p = ids.shape[1]
    lane = lambda a, axis=0: np.repeat(a, n, axis=axis)  # noqa: E731
    full_ids = np.concatenate([lane(ids), resp.astype(np.int32)], axis=1)
    full_seg = np.concatenate([lane(seg), np.ones_like(resp, np.int32)], axis=1)
    resp_pos = lane(gen_start)[:, None] + np.arange(R)[None, :]
    full_pos = np.concatenate([lane(pos, 1), np.broadcast_to(resp_pos, (3, *resp_pos.shape))], axis=2)
    logits, _ = jax_forward_logits(
        jax_params, JAX_CFG, jnp.asarray(full_ids), jnp.asarray(full_pos.astype(np.int32)),
        segment_ids=jnp.asarray(full_seg),
        vision=jax.tree.map(jnp.asarray, _vision(batch, n)),
    )
    logp = jax.nn.log_softmax(np.asarray(logits)[:, p - 1 : p - 1 + R] / temp, axis=-1)
    ref = np.take_along_axis(np.asarray(logp), resp[..., None], axis=-1)[..., 0] * mask
    np.testing.assert_allclose(got.rollout_log_probs.numpy(), ref, atol=1e-2, rtol=0)
    assert np.all(got.rollout_log_probs.numpy() <= 0)


def _logits(seed=0, b=4, v=64):
    return np.random.default_rng(seed).normal(size=(b, v)).astype(np.float32) * 3


@pytest.mark.parametrize("k", [-1, 1, 5])
def test_top_k_matches_jax(k):
    x = _logits(1)
    np.testing.assert_array_equal(
        sampling.apply_top_k(to_torch(x), k).numpy(), np.asarray(jax_sampling.apply_top_k(jnp.asarray(x), k))
    )


@pytest.mark.parametrize("p", [0.3, 0.9, 1.0])
def test_top_p_matches_jax(p):
    x = _logits(2)
    np.testing.assert_array_equal(
        sampling.apply_top_p(to_torch(x), p).numpy(), np.asarray(jax_sampling.apply_top_p(jnp.asarray(x), p))
    )


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
def test_token_logp_and_greedy_match_jax(temperature):
    x = _logits(3)
    toks = np.random.default_rng(4).integers(0, x.shape[1], size=x.shape[0])
    params = dict(temperature=temperature)
    got = sampling.sampled_token_logp(to_torch(x), to_torch(toks), sampling.SamplingParams(**params))
    ref = jax_sampling.sampled_token_logp(
        jnp.asarray(x), jnp.asarray(toks), jax_sampling.SamplingParams(**params)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    greedy = sampling.sample_tokens(to_torch(x), torch.Generator(), sampling.SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(greedy.numpy(), np.argmax(x, axis=-1))


def test_response_mask_matches_jax():
    resp = np.asarray([[5, 99, 7, 99], [1, 2, 3, 4], [99, 1, 1, 1]])
    np.testing.assert_array_equal(
        sampling.get_response_mask(to_torch(resp), 99).numpy(),
        np.asarray(jax_sampling.get_response_mask(jnp.asarray(resp), 99)),
    )


def test_sampling_follows_the_tempered_and_filtered_distribution():
    logits = torch.tensor([[2.0, 0.0, -1.0, 1.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    for temp in (1.0, 0.5):
        toks = sampling.sample_tokens(logits, gen, sampling.SamplingParams(temperature=temp))
        freq = torch.bincount(toks, minlength=4).float() / len(toks)
        torch.testing.assert_close(freq, torch.softmax(logits[0] / temp, -1), atol=0.03, rtol=0)
    only_top = sampling.sample_tokens(logits, gen, sampling.SamplingParams(top_k=1))
    assert torch.all(only_top == 0)
    nucleus = sampling.sample_tokens(logits, gen, sampling.SamplingParams(top_p=0.8))
    assert set(nucleus.tolist()) == {0, 3}
