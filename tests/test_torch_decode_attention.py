"""The port's plain decode attention (the CPU side of the CUDA kernel) against
the JAX package's Pallas decode kernel in bf16 mode, run in interpret mode on
the CPU as tests/test_decode_attention.py runs it, and against the JAX XLA
reference path in fp32.

Tolerances:
- vs ``_pallas_decode``: the TPU kernel is bf16 by construction — it casts K
  and the softmax weights to bf16 inside and writes a bf16 output — so both
  sides take the same bf16 inputs; they differ in where the weights are
  rounded (running-max-relative vs normalised) and in one output rounding:
  atol/rtol 2e-2, the bf16 tolerance of tests/test_decode_attention.py.
- vs ``_xla_decode`` in fp32: the same math up to summation order: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops.decode_attention import _pallas_decode, _xla_decode
from spatialthinker_torch.ops.decode_attention import decode_attention, decode_attention_plain
from tests.test_torch_parity import to_torch


def _case(hq, hkv, seed, s=128, d=32, b=3, n_layers=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(n_layers, b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(n_layers, b, hkv, s, d)).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    seg[:, s - s // 4 :] = 0  # unwritten decode tail
    seg[0, : s // 4] = 0      # left padding
    seg[2] = 0                # a row with no valid cell
    return q, k, v, seg


@pytest.mark.parametrize("layer_idx", [0, 2])
@pytest.mark.parametrize("hq,hkv", [(16, 2), (14, 2)], ids=["G8", "G7"])
def test_plain_decode_matches_pallas_bf16(hq, hkv, layer_idx):
    q, k, v, seg = _case(hq, hkv, seed=hq + layer_idx)
    d = q.shape[-1]
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = _pallas_decode(
        bf(q), bf(k), bf(v), jnp.asarray(seg), jnp.int32(layer_idx), None, None, d**-0.5, 64
    )
    tb = lambda a: to_torch(a).to(torch.bfloat16)  # noqa: E731
    got = decode_attention_plain(tb(q), tb(k), tb(v), to_torch(seg), layer_idx, d**-0.5)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), atol=2e-2, rtol=2e-2
    )
    assert np.all(got[2].float().numpy() == 0.0)


@pytest.mark.parametrize("hq,hkv", [(16, 2), (14, 2)], ids=["G8", "G7"])
def test_plain_decode_matches_xla_fp32(hq, hkv):
    q, k, v, seg = _case(hq, hkv, seed=7)
    d = q.shape[-1]
    ref = _xla_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), jnp.int32(1),
        None, None, d**-0.5,
    )
    before = decode_attention.launches
    got = decode_attention(to_torch(q), to_torch(k), to_torch(v), to_torch(seg), 1)
    assert decode_attention.launches == before  # CPU tensors never count a launch
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
