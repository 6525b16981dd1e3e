"""The port's flash backward (``flash_bwd_plain``, the CPU side of the two
CUDA backward kernels, and the autograd Function over it) against ``jax.vjp``
of the JAX package's ``flash_attention``, whose backward runs the two Pallas
kernels in interpret mode on the CPU.

Tolerance: fp32 inputs on both sides and the same arithmetic (p from the saved
logsumexp, delta = rowsum(dO * o), ds = p (dp - delta), the three products,
the in-kernel group sum) up to summation order -- the Pallas kernels
accumulate block by block: atol/rtol 2e-5 on O(1..10) gradients. Padding rows
are exact zeros on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from spatialthinker_tpu.ops.flash_attention import flash_attention as jax_flash
from spatialthinker_torch.ops import flash_attention as fa
from spatialthinker_torch.ops.attention import attention
from tests.test_torch_parity import to_torch

TOL = dict(atol=2e-5, rtol=2e-5)


def _segs(kind, b, s):
    seg = np.ones((b, s), np.int32)
    if kind == "packed_padded":
        seg[:, : 3 * s // 8] = 1
        seg[:, 3 * s // 8 : 3 * s // 4] = 2
        seg[:, 3 * s // 4 :] = 0
    elif kind == "windows":
        seg[:] = np.arange(s) // 16 + 1
    elif kind == "dead_row":
        seg[1] = 0
    return seg


CASES = [
    # name, b, s, hq, hkv, d, causal, segments, block
    ("gqa_multiblock_causal", 2, 96, 4, 2, 32, True, "ones", 32),
    ("packed_segments_padding", 1, 128, 2, 2, 32, True, "packed_padded", 64),
    ("vision_d80_non_causal", 1, 64, 2, 2, 80, False, "windows", 32),
    ("windows_form", 4, 16, 2, 2, 80, False, "ones", 16),
    ("gqa_group_of_8_dead_row", 2, 32, 8, 1, 16, True, "dead_row", 32),
]


def _inputs(case):
    _, b, s, hq, hkv, d, causal, kind, block = case
    rng = np.random.default_rng(s * 3 + d + hq)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    return q, k, v, do, _segs(kind, b, s)


def _jax_grads(case, q, k, v, do, seg):
    causal, block = case[6], case[8]
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash(q_, k_, v_, segment_ids=jnp.asarray(seg), causal=causal,
                                     block_q=block, block_k=block),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_flash_backward_matches_pallas_interpret(case):
    q, k, v, do, seg = _inputs(case)
    causal, d = case[6], case[5]
    ref = _jax_grads(case, q, k, v, do, seg)
    tq, tk, tv, tdo, tseg = (to_torch(x) for x in (q, k, v, do, seg))
    o, lse = fa.flash_fwd_plain(tq, tk, tv, tseg, tseg, causal=causal, scale=d**-0.5)
    got = fa.flash_bwd_plain(tq, tk, tv, tseg, tseg, o, lse, tdo, causal=causal, scale=d**-0.5)
    dead = seg == 0
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)
        assert np.all(g.numpy()[dead] == 0.0), name


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_attention_autograd_matches_jax_grad(case):
    """``attention()`` is differentiable end to end: q/k/v are views into one
    fused projection (made contiguous inside), once plainly and once under
    ``torch.utils.checkpoint``."""
    q, k, v, do, seg = _inputs(case)
    hq, hkv, causal = case[3], case[4], case[6]
    ref = _jax_grads(case, q, k, v, do, seg)
    fused = to_torch(np.concatenate([q, k, v], axis=2)).requires_grad_()
    tseg, tdo = to_torch(seg), to_torch(do)

    def run(x):
        out = attention(x[:, :, :hq], x[:, :, hq : hq + hkv], x[:, :, hq + hkv :],
                        segment_ids=tseg, causal=causal)
        return (out * tdo).sum()

    (g_plain,) = torch.autograd.grad(run(fused), fused)
    (g_ckpt,) = torch.autograd.grad(checkpoint(run, fused, use_reentrant=False), fused)
    np.testing.assert_allclose(g_plain.numpy(), np.concatenate(ref, axis=2), **TOL)
    torch.testing.assert_close(g_ckpt, g_plain, atol=0, rtol=0)


def test_backward_with_causal_offset_raises():
    rng = np.random.default_rng(0)
    q = to_torch(rng.normal(size=(1, 8, 2, 16)).astype(np.float32)).requires_grad_()
    kv = to_torch(rng.normal(size=(1, 24, 2, 16)).astype(np.float32))
    out = attention(q, kv, kv, kv_segment_ids=torch.ones((1, 24), dtype=torch.int32),
                    causal=True, causal_offset=16)
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()


def test_cpu_backward_takes_the_plain_version_without_counting_a_launch():
    q, k, v, do, seg = (to_torch(x) for x in _inputs(CASES[0]))
    o, lse = fa.flash_fwd(q, k, v, seg, seg, causal=True, scale=0.2)
    before = (fa._launch_bwd_dq.launches, fa._launch_bwd_dkv.launches)
    got = fa.flash_bwd(q, k, v, seg, seg, o, lse, do, causal=True, scale=0.2)
    ref = fa.flash_bwd_plain(q, k, v, seg, seg, o, lse, do, causal=True, scale=0.2)
    assert (fa._launch_bwd_dq.launches, fa._launch_bwd_dkv.launches) == before
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
