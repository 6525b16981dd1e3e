"""Ring attention (``spatialthinker_torch/ops/ring.py``) on 2 and 4 gloo ranks
on the CPU (``tests/torch_dist_worker.py``; the flash kernels' plain
versions), against the JAX package's ``ring_attention`` on the 8-device CPU
mesh and its flash attention over the whole sequence, on the same seeded
inputs: outputs within 2e-4 and dq / dk / dv within 3e-4 (the tolerances of
``tests/test_ring.py``; fp32, other summation orders), causal and not, one
segment per row and packed segments with padding, sp = 4 above the 2 kv
heads; then the model: the port's sp = 2 log-probs through ring attention
(per-sample multimodal rows and packed rows) against JAX's sp = 1
``compute_log_probs`` / ``compute_packed_log_probs`` on the same weights
within 2e-4."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from spatialthinker_tpu.ops.flash_attention import flash_attention as jax_flash
from spatialthinker_tpu.ops.ring import ring_attention as jax_ring
from tests.torch_dist_worker import run_ranks

OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
LOGP_TOL = dict(rtol=2e-4, atol=2e-4)


def attention_case(sp, causal, packed, hq=4, hkv=2, d=32, b=2, seed=0):
    rng = np.random.default_rng(seed + 10 * sp + 2 * causal + packed)
    s = 64 * sp
    q, do = (rng.normal(size=(b, s, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, hkv, d)).astype(np.float32) for _ in range(2))
    seg = np.ones((b, s), np.int32)
    if packed:  # two documents per row, across chunk edges, then padding
        seg[:, s // 2 : 7 * s // 8] = 2
        seg[:, 7 * s // 8 :] = 0
    return dict(q=q, k=k, v=v, seg=seg, do=do, causal=causal)


@functools.lru_cache(maxsize=None)
def _jax_vjps(sp, backend, causal):
    """Jitted (sp-parallel op, whole-sequence flash) -> (out, dq, dk, dv)."""
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    if backend == "ring":
        par = lambda q, k, v, seg: jax_ring(q, k, v, mesh, "sp", segment_ids=seg, causal=causal)  # noqa: E731
    else:
        from spatialthinker_tpu.ops.ulysses import ulysses_attention

        par = lambda q, k, v, seg: ulysses_attention(  # noqa: E731
            q, k, v, mesh, "sp", segment_ids=seg, causal=causal)
    whole = lambda q, k, v, seg: jax_flash(  # noqa: E731
        q, k, v, segment_ids=seg, kv_segment_ids=seg, causal=causal)

    def with_grads(fn):
        def run(q, k, v, seg, do):
            o, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, seg), q, k, v)
            return (o, *vjp(do))
        return jax.jit(run)

    return with_grads(par), with_grads(whole)


def jax_reference(case, sp, backend):
    """(JAX sp-parallel op, JAX whole-sequence flash): (out, dq, dk, dv) each."""
    args = [jnp.asarray(case[n]) for n in ("q", "k", "v", "seg", "do")]
    return [[np.asarray(x) for x in fn(*args)] for fn in _jax_vjps(sp, backend, case["causal"])]


def gather_chunks(ranks, i, name):
    """The ranks' sequence chunks of one result, whole."""
    return np.concatenate([r[i][name] for r in ranks], axis=1)


def check_against_jax(ranks, cases, i, sp, backend):
    case = cases[i]
    for ref in jax_reference(case, sp, backend):
        for name, want in zip(("out", "dq", "dk", "dv"), ref):
            np.testing.assert_allclose(gather_chunks(ranks, i, name), want,
                                       err_msg=name, **(OUT_TOL if name == "out" else GRAD_TOL))


CASES = [(causal, packed) for causal in (True, False) for packed in (False, True)]
RING = {sp: [attention_case(sp, c, p) for c, p in CASES] for sp in (2, 4)}


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    return {sp: run_ranks("ring", sp, tmp, {"cases": RING[sp]}) for sp in (2, 4)}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("i", range(len(CASES)), ids=[f"causal{c}-packed{p}" for c, p in CASES])
def test_ring_matches_jax_ring_and_whole_flash(ring_ranks, sp, i):
    check_against_jax(ring_ranks[sp], RING[sp], i, sp, "ring")


def test_ring_gqa_degree_beyond_heads(ring_ranks):
    """sp = 4 over 2 kv heads, where Ulysses stops: every rank holds its
    chunk of all heads."""
    assert RING[4][0]["k"].shape[2] == 2
    for r in ring_ranks[4]:
        assert r[0]["out"].shape == (2, 64, 4, 32) and r[0]["dk"].shape == (2, 64, 2, 32)


# ---------------------------------------------------------------------------
# the model: sp = 2 log-probs against JAX's sp = 1
# ---------------------------------------------------------------------------


def logprob_payload(seed: int, multimodal: bool):
    """One tiny model (JAX tree and port state dict), a per-sample batch
    (with an image per row when ``multimodal``) and a packed batch."""
    import torch

    from spatialthinker_tpu.data.packing import pack_vision_batch
    from spatialthinker_torch.data import packing as tpk
    from tests.test_torch_parity import CFG, JAX_CFG, both_models

    jax_params, model = both_models(seed=seed)
    rng = np.random.default_rng(seed)
    bs, p_len, r = 4, 24, 8
    s = p_len + r
    ids = rng.integers(1, 200, size=(bs, s), dtype=np.int32)
    vision = tvision = None
    if multimodal:  # one (1, 4, 4) image per row: 16 patches, 4 merged tokens
        ids[:, 2:6] = JAX_CFG.image_token_id
        vcfg = JAX_CFG.vision
        feat = vcfg.in_channels * vcfg.temporal_patch_size * vcfg.patch_size**2
        patches = [rng.normal(size=(16, feat)).astype(np.float32) for _ in range(bs)]
        grids = [np.asarray([[1, 4, 4]], dtype=np.int64)] * bs
        vision = pack_vision_batch(patches, grids, vcfg)
        tvision = tpk.pack_vision_batch(patches, grids, CFG.vision)
    train = (ids, np.ones((bs, s), np.int32), np.tile(np.arange(s)[None, None], (3, bs, 1)),
             ids[:, p_len:], np.ones((bs, r), np.float32), *(np.zeros((bs, r), np.float32),) * 3)
    rows, length = 4, 32
    pids = rng.integers(1, 200, size=(rows, length), dtype=np.int32)
    seg = np.zeros((rows, length), np.int32)
    seg[:, :14], seg[:, 14:28] = 1, 2  # two packed samples per row, 4 pad cells
    loss_mask = (seg > 0).astype(np.float32)
    loss_mask[:, -1] = 0
    packed = (pids, seg, np.tile(np.arange(length)[None, None], (3, rows, 1)), np.roll(pids, -1, axis=1),
              loss_mask, *(np.zeros((rows, length), np.float32),) * 3)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del torch
    return jax_params, vision, {"state": state, "train": train, "train_vision": tvision, "packed": packed}


def jax_log_probs(jax_params, vision, p):
    from spatialthinker_tpu.trainer.train_step import (
        PackedTrainBatch, TrainBatch, compute_log_probs, compute_packed_log_probs,
    )
    from tests.test_torch_parity import JAX_CFG

    vis = None if vision is None else jax.tree.map(jnp.asarray, vision)
    train = jax.jit(lambda w, b, v: compute_log_probs(w, JAX_CFG, b, v, chunk_size=4)[0])(
        jax_params, TrainBatch(*map(jnp.asarray, p["train"])), vis)
    packed = jax.jit(lambda w, b: compute_packed_log_probs(w, JAX_CFG, b, chunk_size=4)[0])(
        jax_params, PackedTrainBatch(*map(jnp.asarray, p["packed"])))
    return {"train": np.asarray(train), "packed": np.asarray(packed)}


@pytest.mark.parametrize("multimodal", [True, False], ids=["multimodal", "text"])
def test_ring_sp2_log_probs_match_jax_sp1(tmp_path, multimodal):
    jax_params, vision, payload = logprob_payload(5, multimodal)
    want = jax_log_probs(jax_params, vision, payload)
    for got in run_ranks("logprobs", 2, tmp_path, {**payload, "backend": "ring"}):
        for key in ("train", "packed"):
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **LOGP_TOL)
