"""The silu -> int8 junction (``spatialthinker_torch/ops/silu_quant.py``) and
the quantized MLP around it, against the JAX package.

- plain version vs the Pallas kernel ``fused_silu_quantize`` in interpret
  mode: scales within 1e-6 relative, int8 values at most 1 step apart (the
  two sigmoid implementations differ in the last bits, which flips a value
  that sits on a rounding tie);
- the MLP on a quantized tree, fused junction (m >= 1024) vs unfused vs JAX
  ``swiglu_mlp`` (fused through interpret mode, and its XLA pipeline):
  within 2e-3 of an O(0.1) output — one int8 step of one of the I products
  that feed the down dot, times its weight;
- the module imports without triton.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spatialthinker_tpu.models.qwen2_5_vl.text import swiglu_mlp
from spatialthinker_tpu.ops import quant as jq
from spatialthinker_tpu.ops.int8_matmul import fused_silu_quantize as jax_fused_silu_quantize
from spatialthinker_torch.ops import quant as tq
from spatialthinker_torch.ops import silu_quant
from tests.test_torch_parity import CFG, both_models

torch.set_num_threads(2)


def test_module_imports_without_triton():
    """Importing the module builds no kernel and imports no triton: the
    package must import on a CPU-only PyTorch."""
    mod = importlib.reload(silu_quant)
    assert mod._kernel is None and "triton" not in vars(mod)
    assert "triton" not in sys.modules
    assert callable(mod.fused_silu_quantize) and mod.fused_silu_quantize.launches == 0


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    m, i = 64, 256
    gu = rng.normal(size=(m, 2 * i)).astype(np.float32)
    gu[3] = 0.0  # an all-zero row takes the eps floor
    gu_bf16 = jnp.asarray(gu, jnp.bfloat16)
    ref_q, ref_s = jax_fused_silu_quantize(gu_bf16)
    q, s = silu_quant.fused_silu_quantize(torch.from_numpy(np.asarray(gu_bf16, np.float32)).to(torch.bfloat16))
    assert q.dtype == torch.int8 and tuple(q.shape) == (m, i) and tuple(s.shape) == (m, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6, atol=0)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(ref_q, np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3  # ties only


def test_plain_takes_a_width_that_is_no_power_of_two():
    rng = np.random.default_rng(5)
    gu = torch.from_numpy(rng.normal(size=(9, 2 * 86)).astype(np.float32))
    q, s = silu_quant.fused_silu_quantize(gu)
    g, u = gu[:, :86], gu[:, 86:]
    h = (g * torch.sigmoid(g)) * u
    np.testing.assert_allclose(s.numpy(), (h.abs().amax(1, keepdim=True) / 127).numpy(), rtol=1e-6)
    assert int(q.abs().max()) == 127 and tuple(q.shape) == (9, 86)


def test_quantized_mlp_fused_unfused_and_jax(monkeypatch):
    jax_params, model = both_models(seed=4)
    qparams = jq.quantize_params(jax_params, mode="int8")
    qmodel = tq.quantize_model(model)
    layer_p = jax.tree.map(lambda a: a[0], qparams["text"]["layers"]["mlp"])
    mlp = qmodel.text.layers[0].mlp

    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 128, CFG.text.hidden_size)).astype(np.float32)  # m = 1024
    calls = {"n": 0}
    real = silu_quant.fused_silu_quantize

    def counted(gu):
        calls["n"] += 1
        return real(gu)

    monkeypatch.setattr(silu_quant, "fused_silu_quantize", counted)
    fused = mlp(torch.from_numpy(x))
    assert calls["n"] == 1, "m = 1024 must take the fused junction"
    small = mlp(torch.from_numpy(x[:1, :8]))
    assert calls["n"] == 1, "decode-sized m must stay unfused"
    mlp.fused_silu = False
    unfused = mlp(torch.from_numpy(x))
    mlp.fused_silu = True
    assert calls["n"] == 1

    monkeypatch.setenv("SPATIALTHINKER_FUSED_SILU", "force")
    ref_fused = np.asarray(swiglu_mlp(layer_p, jnp.asarray(x)))
    monkeypatch.setenv("SPATIALTHINKER_FUSED_SILU", "0")
    ref_unfused = np.asarray(swiglu_mlp(layer_p, jnp.asarray(x)))

    np.testing.assert_allclose(fused.numpy(), ref_fused, rtol=0, atol=2e-3)
    np.testing.assert_allclose(unfused.numpy(), ref_unfused, rtol=0, atol=2e-3)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(small.numpy(), unfused.numpy()[:1, :8], rtol=0, atol=2e-3)
    assert float(np.abs(ref_unfused).max()) > 0.02  # the tolerance is far below the signal
