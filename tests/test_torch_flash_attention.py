"""The port's plain flash forward (the CPU side of the CUDA kernel) against the
JAX package's Pallas flash kernel, run in interpret mode on the CPU as the
JAX tests run it: ``flash_attention`` for the output, ``_flash_fwd`` for
(output, logsumexp).

Tolerance: fp32 inputs on both sides and the same algorithm up to summation
order (the Pallas kernel accumulates block by block with online-softmax
rescaling, the plain version over whole rows): atol/rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops.flash_attention import _flash_fwd, flash_attention as jax_flash
from spatialthinker_torch.ops.attention import attention
from spatialthinker_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
from tests.test_torch_parity import to_torch

TOL = dict(atol=1e-5, rtol=1e-5)


def _segs(kind, b, s):
    seg = np.ones((b, s), np.int32)
    if kind == "left_pad":
        seg[0, :5] = 0
        seg[1, :s // 2] = 0
    elif kind == "packed":
        seg[:, : s // 3] = 1
        seg[:, s // 3 : 3 * s // 4] = 2
        seg[:, 3 * s // 4 :] = 0
    elif kind == "dead_row":
        seg[1] = 0  # a row with no live token at all
    return seg


CASES = [
    # name, b, sq, skv, hq, hkv, d, causal, causal_offset, segments
    ("causal_left_pad", 2, 64, 64, 4, 2, 32, True, 0, "left_pad"),
    ("causal_packed", 2, 64, 64, 4, 4, 32, True, 0, "packed"),
    ("causal_offset", 2, 32, 96, 8, 2, 32, True, 64, "ones"),
    ("non_causal_d80", 3, 64, 64, 2, 2, 80, False, 0, "packed"),
    ("fully_masked_row", 2, 64, 64, 4, 2, 32, True, 0, "dead_row"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_flash_matches_pallas_interpret(case):
    _, b, sq, skv, hq, hkv, d, causal, off, kind = case
    rng = np.random.default_rng(sq * 7 + d)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    kv_seg = _segs(kind, b, skv)
    q_seg = np.ascontiguousarray(kv_seg[:, skv - sq :])
    scale = d**-0.5

    ref_o, ref_lse = _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_seg), jnp.asarray(kv_seg),
        causal, scale, 32, 32, off,
    )
    o, lse = flash_fwd_plain(
        to_torch(q), to_torch(k), to_torch(v), to_torch(q_seg), to_torch(kv_seg),
        causal=causal, scale=scale, causal_offset=off,
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    dead = q_seg == 0
    assert np.all(o.numpy()[dead] == 0.0)
    assert np.all(lse.numpy().transpose(0, 2, 1)[dead] == -1e30)

    # the public entry point (and the model's dispatcher) agree with flash_attention
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segment_ids=jnp.asarray(q_seg),
        kv_segment_ids=jnp.asarray(kv_seg), causal=causal, block_q=32, block_k=32,
        causal_offset=off,
    )
    got = attention(
        to_torch(q), to_torch(k), to_torch(v), segment_ids=to_torch(q_seg),
        kv_segment_ids=to_torch(kv_seg), causal=causal, causal_offset=off,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting_a_launch():
    rng = np.random.default_rng(0)
    q = to_torch(rng.normal(size=(1, 16, 2, 16)).astype(np.float32))
    seg = torch.ones((1, 16), dtype=torch.int32)
    before = flash_fwd.launches
    o, lse = flash_fwd(q, q, q, seg, seg, causal=True, scale=0.25)
    ref_o, ref_lse = flash_fwd_plain(q, q, q, seg, seg, causal=True, scale=0.25)
    assert flash_fwd.launches == before
    torch.testing.assert_close(o, ref_o, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)
