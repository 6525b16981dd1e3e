"""The port's chunked log-probs against the JAX package's
(``ops/logprobs.py``): values, entropy, temperature, uneven lengths, and the
gradients with respect to the hidden states and the head.

Tolerance: fp32 on both sides, the same logsumexp/gather arithmetic, another
summation order in the (E -> V) product: atol/rtol 1e-5 for values and 2e-5
for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops import logprobs as jlp
from spatialthinker_torch.ops import logprobs as tlp
from tests.test_torch_parity import to_torch

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, s, e, v, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(b, s, e)).astype(np.float32)
    head = (rng.normal(size=(e, v)) * 0.3).astype(np.float32)  # JAX layout (E, V)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    return hidden, head, labels


@pytest.mark.parametrize("s,chunk,entropy,temperature", [
    (32, 8, False, 1.0),    # even chunks
    (30, 8, True, 1.0),     # uneven: falls to the largest divisor (6)
    (32, 1024, True, 0.7),  # one chunk, tempered
    (17, 8, False, 1.3),    # prime length: chunk 1
])
def test_chunked_log_probs_match_jax_and_direct(s, chunk, entropy, temperature):
    hidden, head, labels = _inputs(2, s, 16, 50, seed=s)
    ref_lp, ref_ent = jlp.log_probs_from_hidden(
        jnp.asarray(hidden), jnp.asarray(labels), jnp.asarray(head), chunk_size=chunk,
        compute_entropy=entropy, temperature=temperature,
    )
    lp, ent = tlp.log_probs_from_hidden(
        to_torch(hidden), to_torch(labels), to_torch(head.T.copy()), chunk_size=chunk,
        compute_entropy=entropy, temperature=temperature,
    )
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), **TOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(ref_ent), **TOL)
    logits = to_torch(hidden) @ to_torch(head) / temperature
    direct = tlp.log_probs_from_logits(logits, to_torch(labels))
    np.testing.assert_allclose(lp.numpy(), direct.numpy(), **TOL)
    np.testing.assert_allclose(
        direct.numpy(), np.asarray(jlp.log_probs_from_logits(jnp.asarray(logits.numpy()), jnp.asarray(labels))),
        **TOL)
    assert tlp._best_chunk(s, chunk) == jlp._best_chunk(s, chunk)


@pytest.mark.parametrize("entropy", [False, True], ids=["logp", "logp_and_entropy"])
def test_log_prob_gradients_match_jax(entropy):
    hidden, head, labels = _inputs(2, 24, 16, 40, seed=5)
    w = np.random.default_rng(9).normal(size=(2, 24)).astype(np.float32)

    def jax_loss(h, hd):
        lp, ent = jlp.log_probs_from_hidden(h, jnp.asarray(labels), hd, chunk_size=8,
                                            compute_entropy=entropy, temperature=0.9)
        return jnp.sum((lp - 0.5 * ent) * jnp.asarray(w))

    gh_ref, ghead_ref = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head))
    th = to_torch(hidden).requires_grad_()
    thead = to_torch(head.T.copy()).requires_grad_()
    lp, ent = tlp.log_probs_from_hidden(th, to_torch(labels), thead, chunk_size=8,
                                        compute_entropy=entropy, temperature=0.9)
    ((lp - 0.5 * ent) * to_torch(w)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(thead.grad.numpy().T, np.asarray(ghead_ref), atol=2e-5, rtol=2e-5)


def test_matmul_fp32_out_keeps_fp32_logits_from_bf16_operands():
    """bf16 operands give fp32 logits equal to the fp32 product of the same
    bf16 values (no rounding of the output), and the gradient flows."""
    rng = np.random.default_rng(1)
    x = to_torch(rng.normal(size=(3, 5, 16)).astype(np.float32)).bfloat16().requires_grad_()
    w = to_torch(rng.normal(size=(11, 16)).astype(np.float32)).bfloat16().requires_grad_()
    out = tlp.matmul_fp32_out(x, w)
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 5, 11)
    torch.testing.assert_close(out, x.float() @ w.float().t(), atol=1e-5, rtol=1e-5)
    out.sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.shape == w.shape
