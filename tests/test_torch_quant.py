"""The port's W8A8 helpers (``spatialthinker_torch/ops/quant.py``) against the
JAX package's on the same numpy inputs.

Tolerances: int8 values must be bit-equal (same fp32 amax, division and
round-half-even on both sides); fp32 outputs within 1e-5 (the int32
accumulation is exact, the two fp32 scale multiplies round alike; the slack
covers the activation amax reduction order). ``quantize_model`` of carried
weights must equal ``quantize_params``'s tree leaf by leaf: int8 values
bit-equal, scales within one fp32 ulp (2e-7 relative — XLA compiles the
per-layer ``amax / 127`` of ``quantize_params`` to a multiply by a
reciprocal, the eager path divides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops import quant as jq
from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax
from spatialthinker_torch.ops import quant as tq
from tests.test_torch_parity import CFG, both_models, random_jax_tree

torch.set_num_threads(2)

WEIGHT_CASES = [((64, 48), 0), ((64, 48), 1), ((2, 32, 40), 1), ((3, 2, 16, 24), 2)]


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape,axis", WEIGHT_CASES)
def test_quantize_weight_bit_equal(shape, axis):
    w = _rand(np.random.default_rng(0), *shape)
    w[..., 0] = 0.0  # a zero slice exercises the eps floor for axis -1 cases
    ref = jq.quantize_weight(jnp.asarray(w), axis)
    got = tq.quantize_weight(torch.from_numpy(w), axis)
    np.testing.assert_array_equal(got["qvalue"].numpy(), np.asarray(ref["qvalue"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))
    assert got["qvalue"].dtype == torch.int8 and got["scale"].dtype == torch.float32


def test_quantize_activation_bit_equal_and_half_even():
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 5, 32)
    x[0, 0] = 0.0                      # all-zero token: eps floor
    x[1, 1, :4] = [127.0, 0.5, 1.5, -2.5]  # ties after scaling by 1.0
    x[1, 1, 4:] = 0.0
    ref_q, ref_s = jq.quantize_activation(jnp.asarray(x))
    q, s = tq.quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    assert q[1, 1, :4].tolist() == [127, 0, 2, -2]  # round half to even


@pytest.mark.parametrize("shape,axis", WEIGHT_CASES)
def test_quantized_dot_matches(shape, axis):
    rng = np.random.default_rng(2)
    w = _rand(rng, *shape)
    x = _rand(rng, 2, 7, shape[axis])
    ref = jq.quantized_dot(jnp.asarray(x), jq.quantize_weight(jnp.asarray(w), axis), axis)
    got = tq.quantized_dot(torch.from_numpy(x), tq.quantize_weight(torch.from_numpy(w), axis), axis)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_int8_matmul_exact_at_deep_k():
    """K = 2048 with full-range int8 operands overflows an fp32 accumulator's
    24 bits; the int32 product must stay exact."""
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, size=(5, 2048)).astype(np.int8)
    b = rng.integers(-127, 128, size=(24, 2048)).astype(np.int8)
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b).t())
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def test_linear_and_embed_rows_dispatch():
    rng = np.random.default_rng(4)
    w = _rand(rng, 40, 24)   # (vocab, E)
    ids = rng.integers(0, 40, size=(3, 6))
    x = _rand(rng, 3, 24)
    jw = jq.quantize_weight(jnp.asarray(w), 1)
    tw = tq.quantize_weight(torch.from_numpy(w), 1)
    ref = jq.embed_rows(jw, jnp.asarray(ids), dtype=jnp.float32)
    got = tq.embed_rows(tw, torch.from_numpy(ids), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    # plain tables and weights pass through untouched
    np.testing.assert_array_equal(
        tq.embed_rows(torch.from_numpy(w), torch.from_numpy(ids)).numpy(), w[ids]
    )
    ref = jq.linear(jnp.asarray(x), jw, contract_axis=1, out_dtype=jnp.float32)
    got = tq.linear(torch.from_numpy(x), tw, contract_axis=1, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tq.linear(torch.from_numpy(x), torch.from_numpy(w), contract_axis=1).numpy(), x @ w.T,
        rtol=1e-5, atol=1e-5,
    )


def test_quantize_model_equals_quantize_params_leaf_by_leaf():
    """The same fp32 weights quantized by both packages: every int8 leaf and
    scale equal, every other tensor shared with the source model (no copy)."""
    jax_params, model = both_models(seed=3)
    qtree = jax.tree.map(np.asarray, jq.quantize_params(jax_params, mode="int8"))
    want = params_from_jax(qtree, CFG)
    qmodel = tq.quantize_model(model, mode="int8")
    got = dict(qmodel.state_dict())
    assert got.keys() == want.keys()
    n_quant = 0
    for name, ref in want.items():
        if name.endswith(".scale"):
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=2e-7, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name].numpy(), ref.numpy(), err_msg=name)
        assert got[name].dtype == ref.dtype, name
        n_quant += name.endswith(".qvalue")
    assert n_quant == 4 * CFG.text.num_hidden_layers + 1
    src = dict(model.named_parameters())
    for name, p in qmodel.named_parameters():
        assert p is src[name], f"{name} is a copy, not the source model's parameter"


def test_carried_quantized_tree_builds_the_same_model():
    """A JAX quantized rollout tree carried as numpy gives the port model that
    ``quantize_model`` gives: both packages start from the same int8 values."""
    tree = random_jax_tree(5)
    qtree = jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(jnp.asarray, tree), mode="int8"))
    carried = build_model(CFG, params_from_jax(qtree, CFG), device="cpu", dtype=torch.float32)
    direct = tq.quantize_model(
        build_model(CFG, params_from_jax(tree, CFG), device="cpu", dtype=torch.float32)
    )
    a, b = carried.state_dict(), direct.state_dict()
    assert a.keys() == b.keys()
    for name in a:
        if name.endswith(".scale"):  # one fp32 ulp, see the module docstring
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(), rtol=2e-7, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a[name].numpy(), b[name].numpy(), err_msg=name)
    assert isinstance(carried.text.embed_tokens, tq.QuantEmbedding)
    assert isinstance(carried.text.layers[0].mlp.gate_up_proj, tq.QuantLinear)


def test_unported_modes_raise():
    """Only ``int8`` and ``w4a8`` exist; on the tiny preset ``w4a8`` packs its
    int4 copies (groups 32 and 64), which the eligibility rule never runs
    (the down copy's 64 columns are no multiple of 128, as in JAX)."""
    _, model = both_models(seed=3)
    with pytest.raises(ValueError, match="unknown quantization"):
        tq.quantize_model(model, mode="fp8")
    w4 = tq.quantize_model(model, mode="w4a8")
    mlp = w4.text.layers[0].mlp
    assert (mlp.gate_up_w4.group, mlp.down_w4.group) == (32, 64) and mlp.w4
    assert tq.quantize_model(model, mode="int8").text.layers[0].mlp.gate_up_w4 is None
    x = torch.randn(1, 4, CFG.text.hidden_size)
    torch.testing.assert_close(mlp(x), tq.quantize_model(model, mode="int8").text.layers[0].mlp(x),
                               rtol=0, atol=0)
