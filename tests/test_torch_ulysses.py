"""Ulysses sequence parallelism (``spatialthinker_torch/ops/ulysses.py``) on 2
and 4 gloo ranks on the CPU, against the JAX package's ``ulysses_attention``
on the 8-device CPU mesh and its flash attention over the whole sequence
(``tests/test_torch_ring.py``'s cases and tolerances: outputs 2e-4, dq / dk /
dv 3e-4), causal and not, packed segments; at sp = 4 over 4 kv heads, and the
head-count error at sp = 4 over 2; ``pad_seq_to_multiple`` against JAX's;
the port's sp = 2 log-probs through Ulysses against JAX's sp = 1 within
2e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatialthinker_tpu.ops.ulysses import pad_seq_to_multiple as jax_pad
from spatialthinker_torch.ops.ulysses import pad_seq_to_multiple
from tests.test_torch_ring import (
    CASES, LOGP_TOL, attention_case, check_against_jax, jax_log_probs, logprob_payload,
)
from tests.torch_dist_worker import run_ranks

HEADS = {2: (4, 2), 4: (8, 4)}  # (q heads, kv heads) divisible by sp
ULYSSES = {sp: [attention_case(sp, c, p, hq=HEADS[sp][0], hkv=HEADS[sp][1], seed=3) for c, p in CASES]
           for sp in (2, 4)}
HEAD_ERROR = attention_case(4, True, False, hq=4, hkv=2, seed=3)


@pytest.fixture(scope="module")
def ulysses_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ulysses")
    return {2: run_ranks("ulysses", 2, tmp, {"cases": ULYSSES[2]}),
            4: run_ranks("ulysses", 4, tmp, {"cases": ULYSSES[4] + [HEAD_ERROR]})}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("i", range(len(CASES)), ids=[f"causal{c}-packed{p}" for c, p in CASES])
def test_ulysses_matches_jax_ulysses_and_whole_flash(ulysses_ranks, sp, i):
    check_against_jax(ulysses_ranks[sp], ULYSSES[sp], i, sp, "ulysses")


def test_ulysses_refuses_kv_heads_that_do_not_divide_sp(ulysses_ranks):
    for r in ulysses_ranks[4]:
        assert r[-1] == {"error": "q/kv heads (4, 2) must divide sp=4"}


@pytest.mark.parametrize("length,multiple", [(10, 4), (12, 4), (7, 2)])
def test_pad_seq_to_multiple_matches_jax(length, multiple):
    x = np.random.default_rng(length).normal(size=(2, length, 3)).astype(np.float32)
    got, pad = pad_seq_to_multiple(torch.as_tensor(x), multiple)
    want, want_pad = jax_pad(jnp.asarray(x), multiple)
    assert pad == want_pad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("multimodal", [True, False], ids=["multimodal", "text"])
def test_ulysses_sp2_log_probs_match_jax_sp1(tmp_path, multimodal):
    jax_params, vision, payload = logprob_payload(0 if multimodal else 1, multimodal)
    want = jax_log_probs(jax_params, vision, payload)
    for got in run_ranks("logprobs", 2, tmp_path, {**payload, "backend": "ulysses"}):
        for key in ("train", "packed"):
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **LOGP_TOL)
