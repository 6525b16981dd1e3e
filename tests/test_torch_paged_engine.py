"""The slice as a whole: the port's paged rollout engine
(``spatialthinker_torch/rollout/paged.py``) against the JAX package's
``generate_paged`` and against the port's own dense engine, on the tiny
config with fp32 weights carried across, ragged left-padded prompts, tiny
pages (4 cells) and short decode chunks so every scheduling path runs.

Tolerances:
- greedy with bf16 and with int8 pools must match JAX token for token. On
  the CPU the JAX engine attends through its exact gather fallback, while
  the port's plain version repeats the kernel's arithmetic and rounds the
  softmax weights to bf16 page by page: log-probs within 2e-3 (the bound the
  reference's own paged-vs-dense tests use). With the port's attention
  swapped for its exact gathered reference: within 1e-4 (fp32 through two
  layers; both sides round the same KV to the same pool format);
- int4 pools with ``int4_i8dot``: on the CPU the JAX engine runs its exact
  dequantizing fallback, while the port's plain version repeats the kernel's
  int8 rounding of q and of the softmax weights (~0.4% of a row max each).
  With the port's attention swapped for its exact gathered reference the two
  engines must again match token for token (same int4 cache bytes); with the
  int8-dot plain version the log-probs of the SAME tokens stay within 2e-2;
- W8A8 weights on both sides (a carried quantized tree), int8 pools, exact
  attention: token for token, log-probs within 1e-4 (the int32 dots are
  exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops import quant as jq
from spatialthinker_tpu.rollout import paged as jp
from spatialthinker_tpu.rollout.sampling import SamplingParams as JaxSamplingParams
from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax
from spatialthinker_torch.ops import paged_attention as pa
from spatialthinker_torch.rollout import paged as tp
from spatialthinker_torch.rollout.engine import generate
from spatialthinker_torch.rollout.sampling import SamplingParams
from tests.test_torch_parity import CFG, JAX_CFG, both_models, to_torch
from tests.test_torch_rollout import _engine_inputs
from tests.test_torch_rollout import batch  # noqa: F401  (fixture)

torch.set_num_threads(2)

R = 6
JAX_KV = {"bf16": jnp.bfloat16, "int8": jnp.int8, "int4": jnp.uint8}
TORCH_KV = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": torch.uint8}
GREEDY = SamplingParams(temperature=0.0)


@pytest.fixture(scope="module")
def models():
    return both_models(seed=2)


def _prompts(seed, b=6, p=8):
    """Random prompts; rows 0, 2 and 3 left-padded to ragged lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 900, size=(b, p), dtype=np.int32)
    seg = np.ones((b, p), dtype=np.int32)
    pos = np.tile(np.arange(p, dtype=np.int32)[None, None], (3, b, 1))
    gs = np.full((b,), p, dtype=np.int32)
    for i, pad in ((0, 3), (2, 5), (3, 1))[: max(b - 2, 1)]:
        ids[i, pad:] = ids[i, : p - pad]
        ids[i, :pad] = 0
        seg[i, :pad] = 0
        pos[:, i, pad:] = pos[:, i, : p - pad]
        gs[i] = p - pad
    return ids, seg, pos, gs


def _jax_run(params, prompts, kv="bf16", **kw):
    kw.setdefault("max_new_tokens", R)
    return jp.generate_paged(
        params, JAX_CFG, *prompts, sampling=JaxSamplingParams(temperature=0.0),
        key=jax.random.key(0), kv_cache_dtype=JAX_KV[kv], **kw,
    )


def _run(model, prompts, kv="bf16", **kw):
    kw.setdefault("max_new_tokens", R)
    return tp.generate_paged(
        model, *prompts, sampling=GREEDY, generator=torch.Generator().manual_seed(0),
        kv_cache_dtype=TORCH_KV[kv], **kw,
    )


def _exact_attention(q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale, **_):
    return pa.paged_attention_gathered(q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale)


def _assert_same(got, ref, logp_atol=1e-4):
    np.testing.assert_array_equal(got.responses, np.asarray(ref.responses))
    np.testing.assert_array_equal(got.response_mask, np.asarray(ref.response_mask))
    np.testing.assert_allclose(got.rollout_log_probs, np.asarray(ref.rollout_log_probs),
                               rtol=0, atol=logp_atol)


@pytest.mark.parametrize("group_n", [1, 2])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_greedy_matches_jax_token_for_token(models, kv, group_n, monkeypatch):
    jax_params, model = models
    prompts = _prompts(0)
    kw = dict(slots=4, decode_chunk_size=2, page_size=4, group_n=group_n)
    ref = _jax_run(jax_params, prompts, kv, **kw)
    got = _run(model, prompts, kv, **kw)
    assert got.responses.shape == (6 * group_n, R)
    _assert_same(got, ref, logp_atol=2e-3)
    monkeypatch.setattr(tp, "paged_attention", _exact_attention)
    _assert_same(_run(model, prompts, kv, **kw), ref, logp_atol=1e-4)
    for key in ("preemptions", "peak_pages", "total_pages"):
        assert got.stats[key] == ref.stats[key], key
    assert got.stats["refills"] >= 2 and got.stats["chunks"] >= 3


def test_int4_i8dot_against_jax(models, monkeypatch):
    jax_params, model = models
    prompts = _prompts(1)
    kw = dict(slots=4, decode_chunk_size=3, page_size=4, int4_i8dot=True)
    ref = _jax_run(jax_params, prompts, "int4", **kw)
    got = _run(model, prompts, "int4", **kw)
    same = got.responses == np.asarray(ref.responses)
    assert same[:, 0].all()  # the first token comes from the prefill alone
    # log-probs of the tokens both engines chose, up to the first divergence
    agree = np.cumprod(same, axis=1).astype(bool) & np.asarray(ref.response_mask, bool)
    assert agree.mean() > 0.5
    np.testing.assert_allclose(got.rollout_log_probs[agree], np.asarray(ref.rollout_log_probs)[agree],
                               rtol=0, atol=2e-2)

    monkeypatch.setattr(tp, "paged_attention", _exact_attention)
    _assert_same(_run(model, prompts, "int4", **kw), ref)


def test_w8a8_weights_match_jax(models, monkeypatch):
    """Both engines start from the same int8 weights (a carried quantized
    tree), int8 pools, exact attention on both sides (a 1e-3 difference in an
    attention output would move the next matmul's activation quantization)."""
    monkeypatch.setattr(tp, "paged_attention", _exact_attention)
    jax_params, _ = models
    qparams = jq.quantize_params(jax_params, mode="int8")
    qmodel = build_model(CFG, params_from_jax(jax.tree.map(np.asarray, qparams), CFG),
                         device="cpu", dtype=torch.float32)
    prompts = _prompts(2)
    kw = dict(slots=4, decode_chunk_size=2, page_size=4, group_n=2)
    _assert_same(_run(qmodel, prompts, "int8", **kw), _jax_run(qparams, prompts, "int8", **kw))


def test_image_prompts_rows_and_chunked_prefill_match_jax(batch, monkeypatch):
    """Image prompts through the refill path in rows mode with sequence
    chunks (prefill_rows < refill batch, max_num_batched_tokens binding)."""
    jax_params, model = both_models(seed=1)
    prompts = _engine_inputs(batch)
    kw = dict(slots=3, decode_chunk_size=4, page_size=8, prefill_rows=2, max_num_batched_tokens=32,
              patches_list=list(batch.non_tensors["patches"]),
              grids_list=list(batch.non_tensors["image_grid_thw"]), max_new_tokens=5)
    assert tp.effective_prefill_chunk(prompts[0].shape[1], 2, 0, 32) == 16
    ref = _jax_run(jax_params, prompts, "int4", **kw)
    calls = {"chunked": 0}
    real = tp.prefill_forward

    def spy(*a, **k):
        calls["chunked"] += bool(k.get("prefill_chunk")) and bool(k.get("prefill_rows"))
        return real(*a, **k)

    monkeypatch.setattr(tp, "prefill_forward", spy)
    monkeypatch.setattr(tp, "paged_attention", _exact_attention)
    got = _run(model, prompts, "int4", int4_i8dot=True, **kw)
    assert calls["chunked"] >= 1
    _assert_same(got, ref, logp_atol=2e-3)  # an int4 step may flip, see test_torch_prefill_modes


def test_paged_equals_dense_engine_greedy(models):
    _, model = models
    ids, seg, pos, gs = _prompts(3)
    dense = generate(model, to_torch(ids), to_torch(seg), to_torch(pos), to_torch(gs),
                     max_new_tokens=R, sampling=GREEDY, generator=torch.Generator().manual_seed(0))
    paged = _run(model, (ids, seg, pos, gs), slots=2, decode_chunk_size=3, page_size=4)
    np.testing.assert_array_equal(paged.responses, dense.responses.numpy())
    np.testing.assert_array_equal(paged.response_mask, dense.response_mask.numpy())
    # both decode from bf16 KV; the dense kernel's plain version rounds the
    # softmax weights to bf16 over the whole row, the paged one per page
    np.testing.assert_allclose(paged.rollout_log_probs, dense.rollout_log_probs.numpy(), rtol=0, atol=2e-3)


def test_prompt_pages_are_shared_across_a_group(models):
    _, model = models
    rng = np.random.default_rng(23)
    b, p, n = 4, 8, 2
    ids = rng.integers(5, 900, size=(b, p), dtype=np.int32)
    prompts = (ids, np.ones((b, p), np.int32), np.tile(np.arange(p, dtype=np.int32)[None, None], (3, b, 1)),
               np.full((b,), p, np.int32))
    paged = _run(model, prompts, slots=4, decode_chunk_size=2, page_size=4, group_n=n)
    single = _run(model, prompts, slots=4, decode_chunk_size=2, page_size=4, group_n=1)
    assert paged.responses.shape == (b * n, R)
    np.testing.assert_array_equal(paged.responses[::n], single.responses)
    np.testing.assert_array_equal(paged.responses[1::n], single.responses)  # greedy lanes agree
    # 2 groups resident at once; prompt 8 = 2 full pages SHARED by 2 lanes +
    # per-lane growth. Unshared would need 2 groups * 2 lanes * 2 prompt pages.
    assert paged.stats["peak_pages"] < 2 * n * (p // 4) + 2 * n * 2


def test_small_pool_preempts_and_still_completes(models):
    _, model = models
    ids, seg, pos, gs = _prompts(7)
    seg[:] = 1  # full-length prompts: every sequence needs ceil((8+6)/4) = 4 pages
    free = _run(model, (ids, seg, pos, gs), slots=3, decode_chunk_size=2, page_size=4)
    tight = _run(model, (ids, seg, pos, gs), slots=3, decode_chunk_size=2, page_size=4,
                 total_pages=10)  # incl. dummy page 0 -> 9 usable < 3 slots x 4
    assert free.stats["preemptions"] == 0 and tight.stats["preemptions"] >= 1
    assert tight.stats["peak_pages"] <= 9
    np.testing.assert_array_equal(tight.responses, free.responses)
    np.testing.assert_allclose(tight.rollout_log_probs, free.rollout_log_probs, rtol=0, atol=1e-5)


def test_pool_too_small_for_one_sequence_raises(models):
    _, model = models
    ids, seg, pos, gs = _prompts(8, b=2)
    seg[:] = 1
    with pytest.raises(RuntimeError, match="page pool too small for a single sequence"):
        _run(model, (ids, seg, pos, gs), max_new_tokens=8, slots=2, decode_chunk_size=8, page_size=4,
             total_pages=3)  # 2 usable pages < 4 needed by one sequence


def test_unported_options_raise(models):
    _, model = models
    with pytest.raises(TypeError):
        _run(model, _prompts(0), slots=2, page_size=4, mesh=object())


def _exact_fused(q, k_pool, v_pool, table, lengths, layer, k_scale=None, v_scale=None, *,
                 return_stats=False, staged=None, **_):
    res = pa.paged_attention_gathered(q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale,
                                      staged=staged)
    return res if return_stats else res[0]


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_fused_staged_greedy_matches_jax(models, kv, monkeypatch):
    """``generate_paged(fuse_staged=True)`` (the ring attended inside the
    pool kernel's plain version) against the JAX package's, and against the
    port's own unfused run, as the JAX package's
    ``tests/test_paged.py::test_paged_matches_dense_greedy`` holds its fused
    engine. Decode chunks of 3 over pages of 4 cells install across half
    pages (an int4 byte row holds cells c and c + 2) and page boundaries.
    Tolerances as ``test_greedy_matches_jax_token_for_token``: token for
    token, log-probs within 2e-3 (bf16 softmax weights page by page against
    the exact fallback); int4 pools within 5e-3, the envelope
    ``tests/test_torch_paged_attention.py`` gives that plain version against
    the fallback, which rounds every dequantized k and v to bf16; and within
    1e-4 with the port's attention swapped for its exact gathered
    reference."""
    jax_params, model = models
    prompts = _prompts(4)
    kw = dict(slots=4, decode_chunk_size=3, page_size=4, group_n=2, fuse_staged=True)
    ref = _jax_run(jax_params, prompts, kv, **kw)
    got = _run(model, prompts, kv, **kw)
    _assert_same(got, ref, logp_atol=5e-3 if kv == "int4" else 2e-3)
    _assert_same(got, _run(model, prompts, kv, **{**kw, "fuse_staged": False}), logp_atol=2e-3)
    assert got.stats["chunks"] >= 3
    monkeypatch.setattr(tp, "paged_attention", _exact_fused)
    _assert_same(_run(model, prompts, kv, **kw), ref, logp_atol=1e-4)


def test_fused_staged_int4_i8dot_against_jax(models, monkeypatch):
    """The shipped pool format (int4 with int8 dots) with the ring fused:
    the same envelope as ``test_int4_i8dot_against_jax`` (the staged block
    itself dots in bf16 in every mode), and token for token with the exact
    attention."""
    jax_params, model = models
    prompts = _prompts(1)
    kw = dict(slots=4, decode_chunk_size=3, page_size=4, int4_i8dot=True, fuse_staged=True)
    ref = _jax_run(jax_params, prompts, "int4", **kw)
    got = _run(model, prompts, "int4", **kw)
    same = got.responses == np.asarray(ref.responses)
    assert same[:, 0].all()
    agree = np.cumprod(same, axis=1).astype(bool) & np.asarray(ref.response_mask, bool)
    assert agree.mean() > 0.5
    np.testing.assert_allclose(got.rollout_log_probs[agree], np.asarray(ref.rollout_log_probs)[agree],
                               rtol=0, atol=2e-2)
    monkeypatch.setattr(tp, "paged_attention", _exact_fused)
    _assert_same(_run(model, prompts, "int4", **kw), ref)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_install_stage_matches_jax_across_a_half_page(kv):
    """Staged cells that straddle half a page (cells c and c + page/2 of one
    slot share a byte in an int4 pool) and a page boundary install into the
    same bytes as the JAX package's ``_install_stage``; invalid cells drop."""
    rng = np.random.default_rng(4)
    slots, page, p_max, chunk, max_new = 3, 8, 4, 6, 12
    n_pages = slots * p_max + 1
    jstate = jp.init_paged_state(JAX_CFG, slots, n_pages, page, p_max, max_new, jax.random.key(0),
                                 JAX_KV[kv], stage_width=chunk)
    tstate = tp.init_paged_state(CFG, slots, n_pages, page, p_max, max_new, TORCH_KV[kv],
                                 stage_width=chunk, device="cpu")
    table = 1 + np.arange(slots * p_max, dtype=np.int32).reshape(slots, p_max)
    length = np.asarray([2, 7, 13], np.int32)      # 2..7 crosses the half, 7.. and 13.. cross pages
    seg = np.asarray([[1] * 6, [1] * 4 + [0] * 2, [1] * 5 + [0]], np.int32)

    def rand_like(a, lo, hi):
        return rng.integers(lo, hi, size=a.shape).astype(np.asarray(a).dtype)

    fields = {}
    for name in ("k_pool", "v_pool"):
        ref = getattr(jstate, name)
        fields[name] = (rng.normal(size=ref.shape).astype(np.float32) if kv == "bf16"
                        else rand_like(ref, 0, 120))
    lim = {"bf16": None, "int8": 127, "int4": 7}[kv]
    for name in ("stage_k", "stage_v"):
        ref = getattr(jstate, name)
        fields[name] = (rng.normal(size=ref.shape).astype(np.float32) if kv == "bf16"
                        else rand_like(ref, -lim, lim + 1))
    if kv != "bf16":
        for name in ("k_scale", "v_scale", "stage_ks", "stage_vs"):
            fields[name] = rng.uniform(0.01, 0.1, size=getattr(jstate, name).shape).astype(np.float32)
    jstate = jstate._replace(
        page_table=jnp.asarray(table), length=jnp.asarray(length), stage_seg=jnp.asarray(seg),
        **{k: jnp.asarray(v, getattr(jstate, k).dtype) for k, v in fields.items()},
    )
    tstate.page_table, tstate.length, tstate.stage_seg = (torch.from_numpy(a.copy()) for a in (table, length, seg))
    for k, v in fields.items():
        setattr(tstate, k, torch.tensor(v).to(getattr(tstate, k).dtype))
    tstate.ring = chunk
    before = tstate.k_pool.float().numpy().copy()

    jout = jp._install_stage(jstate, page)
    tout = tp._install_stage(tstate)
    assert tout is tstate and tstate.ring == 0 and int(tstate.stage_seg.sum()) == 0
    np.testing.assert_array_equal(tstate.length.numpy(), np.asarray(jout.length))
    names = ["k_pool", "v_pool"] + (["k_scale", "v_scale"] if kv != "bf16" else [])
    for name in names:
        got, ref = getattr(tstate, name), getattr(jout, name)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32), err_msg=name)
    assert (tstate.k_pool.float().numpy() != before).any()  # something was written


@pytest.mark.parametrize("args", [(512, 8, 0, 8192), (512, 8, 0, 2048), (6144, 8, 0, 8192), (48, 2, 0, 32),
                                  (300, 4, 100, 0), (300, 4, 200, 600), (128, 1, 0, 0), (64, 0, 0, 10)])
def test_effective_prefill_chunk_matches_jax(args):
    from spatialthinker_tpu.rollout.continuous import effective_prefill_chunk as ref

    assert tp.effective_prefill_chunk(*args) == ref(*args)
    assert tp.prefill_transient_bytes(CFG, args[0], 8, args[1], 130) == \
        jp.prefill_transient_bytes(JAX_CFG, args[0], 8, args[1], 130)


def test_entry_points_default_to_the_card():
    """With no ``device`` argument the port's entry points run on the GPU; on
    a host without one they raise instead of quietly taking the CPU."""
    from spatialthinker_torch.models.qwen2_5_vl import init_params

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults resolve to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(CFG, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(CFG, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.init_paged_state(CFG, 2, 5, 4, 2, 4)
