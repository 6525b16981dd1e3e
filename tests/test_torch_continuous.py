"""The port's continuous engine (``spatialthinker_torch/rollout/continuous.py``)
against the JAX package's ``generate_continuous`` on the tiny config with fp32
weights carried across, following ``tests/test_continuous.py``: greedy token
for token, refill with more prompts than slots, chunked and rows-mode
prefill, int8 and int4 caches, image prompts, grouped sampling and the
refill-batch cap; sampled runs by log-probs; and the w4a8 weight copy in both
engines.

Tolerances:
- bf16 caches: the port's plain decode version and the JAX package's
  fallback (``_xla_decode``) both round q and the softmax weights to bf16 at
  the same points, so the engines must match token for token and the
  log-probs agree within 1e-4 (fp32 through two layers, other summation
  orders);
- quantized caches: on the CPU the JAX engine attends through the exact
  dequantizing fallback, so the port's decode attention is swapped for the
  same exact reference (``tests/test_torch_rollout._exact_decode``): token
  for token, the cache bytes are the same (the global-step ring puts every
  token in the same cell), log-probs within 2e-4 (an int4 step on a rounding
  boundary moves a logit by ~1e-4). With the port's own plain versions (the
  kernels' arithmetic: bf16 weights, and with ``int4_i8dot`` int8 rounding of
  q and of the weights, ~0.4% of a row max each) the first token is equal and
  the log-probs of the tokens both engines chose stay within 2e-2;
- a sampled run cannot match tokens (the frameworks' generators differ): its
  log-probs are held against the JAX model's teacher-forced log-probs of the
  same tokens, 1e-2 as ``tests/test_torch_rollout.py`` (bf16 cache against
  fp32 teacher forcing);
- w4a8: the same weights quantized by each package's own pass, exact
  attention; the int4 group dots are exact, but an activation that lies
  within an ulp of a rounding boundary may round one int8 (or bf16) step
  apart in the two packages: under ``jit`` XLA turns the row scale's
  ``amax / 127`` into ``amax * (1 / 127)`` (``tests/test_torch_int4_mlp.py``),
  and sigmoid's last ulp differs before the bf16 ``h``. One such step moves
  the later log-probs of its row by up to 0.021 and can flip a greedy token
  where the top two are within 1.5e-3 (seeds 1-15 of ``_w4a8_models``: 8
  exact to 1e-6, six within 0.021, one near-tie). So ``assert_same_up_to_ties``
  holds tokens equal up to each row's first divergence, requires that
  divergence to be a near-tie (``TIE_ATOL``), the log-probs before it within
  ``ROUNDING_ATOL`` and at least ``MIN_AGREED`` of the tokens compared; it
  runs on seeds with no boundary activation, with the worst rounding reach,
  and with a near-tie. The paged engine's odd lane count makes its w4a8 MLP
  the int8 function: equal tokens and log-probs to the int8 copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl import forward_logits as jax_forward_logits
from spatialthinker_tpu.models.qwen2_5_vl import init_params as jax_init_params
from spatialthinker_tpu.ops import quant as jq
from spatialthinker_tpu.rollout import continuous as jc
from spatialthinker_tpu.rollout.sampling import SamplingParams as JaxSamplingParams
from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax
from spatialthinker_torch.ops import quant as tq
from spatialthinker_torch.rollout import continuous as tcont
from spatialthinker_torch.rollout import paged as tp
from spatialthinker_torch.rollout.sampling import SamplingParams
from tests.test_torch_int4_mlp import w4_configs
from tests.test_torch_parity import CFG, JAX_CFG, both_models
from tests.test_torch_rollout import _engine_inputs, _exact_decode, _vision
from tests.test_torch_rollout import batch  # noqa: F401  (fixture)

torch.set_num_threads(2)

R = 6
JAX_KV = {"bf16": jnp.bfloat16, "int8": jnp.int8, "int4": jnp.uint8}
TORCH_KV = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": torch.uint8}
GREEDY = SamplingParams(temperature=0.0)


@pytest.fixture(scope="module")
def models():
    return both_models(seed=4)


def _prompts(seed, b=6, p=8, pads=((0, 3), (2, 1))):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 900, size=(b, p), dtype=np.int32)
    seg = np.ones((b, p), dtype=np.int32)
    pos = np.tile(np.arange(p, dtype=np.int32)[None, None], (3, b, 1))
    gs = np.full((b,), p, dtype=np.int32)
    for i, pad in pads:  # left padding: tokens shift right, segment ids mark the pad
        ids[i, pad:] = ids[i, : p - pad]
        ids[i, :pad] = 0
        seg[i, :pad] = 0
        pos[:, i, pad:] = pos[:, i, : p - pad]
        gs[i] = p - pad
    return ids, seg, pos, gs


def _jax_run(params, prompts, kv="bf16", cfg=JAX_CFG, **kw):
    kw.setdefault("max_new_tokens", R)
    return jc.generate_continuous(params, cfg, *prompts, sampling=JaxSamplingParams(temperature=0.0),
                                  key=jax.random.key(0), kv_cache_dtype=JAX_KV[kv], **kw)


def _run(model, prompts, kv="bf16", sampling=GREEDY, seed=0, **kw):
    kw.setdefault("max_new_tokens", R)
    return tcont.generate_continuous(model, *prompts, sampling=sampling,
                                     generator=torch.Generator().manual_seed(seed),
                                     kv_cache_dtype=TORCH_KV[kv], **kw)


# w4a8 engines against JAX's: a rounding step's reach on later log-probs
# (0.021 the worst of 15 seeds), a near-tie's gap between the two engines'
# chosen tokens (1.5e-3 measured), the share of tokens compared (0.88 the least)
ROUNDING_ATOL = 5e-2
TIE_ATOL = 1e-2
MIN_AGREED = 0.75


def assert_same_up_to_ties(got, ref) -> int:
    """Greedy w4a8 runs of the two packages: each row's tokens equal up to
    its first divergence, which must be a near-tie (each engine's choice
    within ``TIE_ATOL`` of the other's log-prob); the log-probs before it
    within ``ROUNDING_ATOL``; ``MIN_AGREED`` of the tokens compared. Returns
    the number of diverging rows."""
    mask = np.asarray(ref.response_mask, bool)
    lp, ref_lp = got.rollout_log_probs, np.asarray(ref.rollout_log_probs)
    differ = (got.responses != np.asarray(ref.responses)) & mask
    agreed = np.cumprod(~differ, axis=1).astype(bool) & mask
    np.testing.assert_array_equal(np.asarray(got.response_mask, bool)[agreed], mask[agreed])
    np.testing.assert_allclose(lp[agreed], ref_lp[agreed], rtol=0, atol=ROUNDING_ATOL)
    rows = np.flatnonzero(differ.any(axis=1))
    first = differ[rows].argmax(axis=1)
    np.testing.assert_allclose(lp[rows, first], ref_lp[rows, first], rtol=0, atol=TIE_ATOL)
    assert agreed.sum() >= MIN_AGREED * mask.sum(), (agreed.sum(), mask.sum())
    return len(rows)


def _assert_same(got, ref, logp_atol=1e-4):
    np.testing.assert_array_equal(got.responses, np.asarray(ref.responses))
    np.testing.assert_array_equal(got.response_mask, np.asarray(ref.response_mask))
    np.testing.assert_allclose(got.rollout_log_probs, np.asarray(ref.rollout_log_probs), rtol=0, atol=logp_atol)


@pytest.fixture
def exact(monkeypatch):
    monkeypatch.setattr(tcont, "decode_attention", _exact_decode)


def test_greedy_matches_jax_token_for_token(models):
    jax_params, model = models
    prompts = _prompts(0)
    kw = dict(slots=2, decode_chunk_size=2)
    got = _run(model, prompts, **kw)
    assert got.responses.shape == (6, R) and got.stats["lanes"] == 8
    _assert_same(got, _jax_run(jax_params, prompts, **kw))


def test_refill_more_prompts_than_slots(models):
    jax_params, model = models
    prompts = _prompts(1, b=10, pads=((4, 2),))
    kw = dict(slots=3, decode_chunk_size=4, max_new_tokens=5)
    got = _run(model, prompts, **kw)
    assert got.stats["refills"] >= 3 and got.stats["chunks"] >= 3
    _assert_same(got, _jax_run(jax_params, prompts, **kw))


def test_sampled_logprobs_match_jax_teacher_forcing(models):
    jax_params, model = models
    ids, seg, pos, gs = _prompts(3, b=4, pads=((1, 2),))
    temp = 1.0
    got = _run(model, (ids, seg, pos, gs), sampling=SamplingParams(temperature=temp), seed=5, slots=4,
               decode_chunk_size=3, group_n=2)
    n, p = 2, ids.shape[1]
    resp, mask = got.responses, got.response_mask
    assert (resp[0::2] != resp[1::2]).any()  # lanes of a group sample independently
    lane = lambda a, axis=0: np.repeat(a, n, axis=axis)  # noqa: E731
    full_ids = np.concatenate([lane(ids), resp.astype(np.int32)], axis=1)
    full_seg = np.concatenate([lane(seg), np.ones_like(resp, np.int32)], axis=1)
    resp_pos = lane(gs)[:, None] + np.arange(R)[None, :]
    full_pos = np.concatenate([lane(pos, 1), np.broadcast_to(resp_pos, (3, *resp_pos.shape))], axis=2)
    logits, _ = jax_forward_logits(jax_params, JAX_CFG, jnp.asarray(full_ids),
                                   jnp.asarray(full_pos.astype(np.int32)), segment_ids=jnp.asarray(full_seg))
    logp = jax.nn.log_softmax(np.asarray(logits)[:, p - 1 : p - 1 + R] / temp, axis=-1)
    ref = np.take_along_axis(np.asarray(logp), resp[..., None], axis=-1)[..., 0] * mask
    np.testing.assert_allclose(got.rollout_log_probs, ref, atol=1e-2, rtol=0)
    assert np.all(got.rollout_log_probs <= 0)


@pytest.mark.parametrize("mode", [dict(prefill_chunk_size=3), dict(prefill_rows=2),
                                  dict(prefill_rows=2, max_num_batched_tokens=6)],
                         ids=["chunked", "rows", "rows_chunked"])
def test_chunked_and_rows_prefill_match_jax(models, mode):
    jax_params, model = models
    prompts = _prompts(12, b=8)
    kw = dict(slots=4, decode_chunk_size=2, max_new_tokens=5, **mode)
    calls = []
    real = tcont.prefill_forward

    def spy(*a, **k):
        calls.append((k.get("prefill_chunk"), k.get("prefill_rows")))
        return real(*a, **k)

    tcont.prefill_forward = spy
    try:
        got = _run(model, prompts, **kw)
    finally:
        tcont.prefill_forward = real
    assert all(c == (mode.get("prefill_chunk_size", 0) or (3 if "max_num_batched_tokens" in mode else 0),
                     mode.get("prefill_rows", 0)) for c in calls), calls
    _assert_same(got, _jax_run(jax_params, prompts, **kw), logp_atol=2e-4)


@pytest.mark.parametrize("kv,i8dot", [("int8", False), ("int4", False), ("int4", True)],
                         ids=["int8", "int4", "int4_i8dot"])
def test_quantized_caches_match_jax(models, kv, i8dot, monkeypatch):
    jax_params, model = models
    prompts = _prompts(11)
    kw = dict(slots=3, decode_chunk_size=3, max_new_tokens=7, int4_i8dot=i8dot)
    ref = _jax_run(jax_params, prompts, kv, **kw)
    got = _run(model, prompts, kv, **kw)  # the plain versions
    same = got.responses == np.asarray(ref.responses)
    assert same[:, 0].all()
    agree = np.cumprod(same, axis=1).astype(bool) & np.asarray(ref.response_mask, bool)
    np.testing.assert_allclose(got.rollout_log_probs[agree], np.asarray(ref.rollout_log_probs)[agree],
                               rtol=0, atol=2e-2)
    monkeypatch.setattr(tcont, "decode_attention", _exact_decode)
    _assert_same(_run(model, prompts, kv, **kw), ref, logp_atol=2e-4)


def test_multimodal_matches_jax(batch, exact):  # noqa: F811
    jax_params, model = both_models(seed=1)
    prompts = _engine_inputs(batch)
    kw = dict(slots=2, decode_chunk_size=3, max_new_tokens=5,
              patches_list=list(batch.non_tensors["patches"]),
              grids_list=list(batch.non_tensors["image_grid_thw"]))
    got = _run(model, prompts, "int4", int4_i8dot=True, **kw)
    _assert_same(got, _jax_run(jax_params, prompts, "int4", int4_i8dot=True, **kw), logp_atol=2e-4)
    assert len(_vision(batch).patches) > 0


@pytest.mark.parametrize("slots,n", [(4, 2), (7, 3)])
def test_grouped_matches_jax_and_ungrouped(models, slots, n):
    jax_params, model = models
    prompts = _prompts(23, b=4 if n == 2 else 5)
    kw = dict(slots=slots, decode_chunk_size=2, group_n=n)
    got = _run(model, prompts, **kw)
    assert got.responses.shape == (len(prompts[0]) * n, R)
    _assert_same(got, _jax_run(jax_params, prompts, **kw))
    rep = lambda x, axis=0: np.repeat(x, n, axis=axis)  # noqa: E731
    ids, seg, pos, gs = prompts
    ungrouped = _run(model, (rep(ids), rep(seg), rep(pos, 1), rep(gs)), slots=slots, decode_chunk_size=2)
    np.testing.assert_array_equal(got.responses, ungrouped.responses)


def test_refill_batch_cap_matches_jax(models):
    jax_params, model = models
    prompts = _prompts(37)
    kw = dict(slots=8, decode_chunk_size=2, group_n=2, refill_batch=1, max_new_tokens=5)
    got = _run(model, prompts, **kw)
    assert got.stats["refills"] >= 4  # the 4-group slot bank fills one prompt at a time
    _assert_same(got, _jax_run(jax_params, prompts, **kw))


def test_ring_writes_the_same_cells_as_jax(models, exact):
    """The slot caches after a prefill and two decode chunks, int4, with the
    ring crossing the packed half (cells 126..133 of 256: low nibbles, then
    high nibbles of the byte rows the prompt tokens 0..5 live in): the same
    bytes and scales as JAX's."""
    jax_params, model = models
    ids, seg, pos, gs = _prompts(5, b=3)
    max_new, lanes = 130, 8
    jstate = jc.init_slot_state(JAX_CFG, lanes, ids.shape[1], max_new, jax.random.key(0), jnp.uint8)
    tstate = tcont.init_slot_state(model.cfg, lanes, ids.shape[1], max_new, torch.uint8, device="cpu")
    slot_ids = np.asarray([0, 2, 5])
    valid = np.ones(3, bool)
    greedy = JaxSamplingParams(temperature=0.0)
    jstate = jc.prefill_slots(jax_params, JAX_CFG, jstate, jnp.asarray(slot_ids), jnp.asarray(ids),
                              jnp.asarray(seg), jnp.asarray(pos), jnp.asarray(gs), jnp.asarray(valid), greedy)
    gen = torch.Generator().manual_seed(0)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tcont.prefill_slots(model, tstate, t(slot_ids), t(ids), t(seg), t(pos), t(gs), t(valid), GREEDY, gen)
    for _ in range(2):
        jstate = jc.decode_chunk(jax_params, JAX_CFG, jstate, greedy, 4)
        tcont.decode_chunk(model, tstate, GREEDY, 4, gen)
    assert tstate.ring == int(jstate.ring) == 8 and tstate.kv_seg.shape[1] == 256
    for name in ("kv_seg", "length", "steps", "finished", "cur_tokens"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)), name)
    for name in ("cache_k", "cache_v"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)), name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tstate, name).float().numpy(),
                                      np.asarray(getattr(jstate, name), np.float32), name)


def _w4a8_models(seed=6):
    jcfg, cfg = w4_configs()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(seed), jnp.float32))
    tree = jax.tree.map(lambda a: a * 2.5 if a.ndim >= 2 else a, tree)  # sharper logits than init's
    jparams = jax.tree.map(jnp.asarray, tree)
    model = build_model(cfg, params_from_jax(tree, cfg), device="cpu", dtype=torch.float32)
    return jcfg, jparams, model


@pytest.mark.parametrize("seed", [8, 4, 6], ids=["no_boundary", "rounding_reach", "near_tie"])
def test_w4a8_matches_jax(exact, monkeypatch, seed):
    """Each package quantizes its own weights (w4a8) and decodes with an int4
    cache and int8 dots through 8 lanes (7 slots): the int4 MLP runs at every
    decode step (m = 8) in both engines. Held by ``assert_same_up_to_ties``;
    the int4 MLP's own effect (against the int8 copy) is larger than the
    rounding allowance."""
    monkeypatch.setenv("SPATIALTHINKER_W4", "force")
    jcfg, jparams, model = _w4a8_models(seed=seed)
    qjax = jq.quantize_params(jparams, mode="w4a8")
    qtorch = tq.quantize_model(model, mode="w4a8")
    prompts = _prompts(40, b=7)
    kw = dict(slots=7, decode_chunk_size=3, int4_i8dot=True)
    got = _run(qtorch, prompts, "int4", **kw)
    diverged = assert_same_up_to_ties(got, _jax_run(qjax, prompts, "int4", cfg=jcfg, **kw))
    assert diverged == (seed == 6)
    int8 = _run(tq.quantize_model(model, mode="int8"), prompts, "int4", **kw)
    first = got.responses[:, 0] == int8.responses[:, 0]
    assert np.abs(got.rollout_log_probs - int8.rollout_log_probs)[:, 0][first].max() > ROUNDING_ATOL


def test_paged_w4a8_is_the_int8_function():
    """The paged engine decodes through slots + 1 lanes: an odd m, which the
    int4 kernels refuse, so w4a8 gives the int8 copy's tokens and log-probs
    (prompts of 136 tokens keep the 4-row prefill above the rule's 512 rows,
    as the shipped prompt lengths do)."""
    _, _, model = _w4a8_models(seed=7)
    prompts = _prompts(41, b=6, p=136)
    kw = dict(slots=4, decode_chunk_size=2, page_size=4, max_new_tokens=R)
    runs = [tp.generate_paged(tq.quantize_model(model, mode=mode), *prompts, sampling=GREEDY,
                              generator=torch.Generator().manual_seed(0), kv_cache_dtype=torch.int8, **kw)
            for mode in ("w4a8", "int8")]
    np.testing.assert_array_equal(runs[0].responses, runs[1].responses)
    np.testing.assert_array_equal(runs[0].rollout_log_probs, runs[1].rollout_log_probs)


def test_effective_prefill_chunk_is_one_copy():
    from spatialthinker_torch.rollout import paged

    assert paged.effective_prefill_chunk is tcont.effective_prefill_chunk
    for args in ((6144, 32, 0, 8192), (512, 4, 0, 8192), (6144, 4, 2048, 0), (64, 64, 0, 128),
                 (2048, 128, 0, 8192), (2048, 4, 300, 0)):
        assert tcont.effective_prefill_chunk(*args) == jc.effective_prefill_chunk(*args)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults resolve to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcont.init_slot_state(CFG, 2, 8, 4)
