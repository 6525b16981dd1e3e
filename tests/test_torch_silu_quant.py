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
- the module imports without triton (the kernel is CUDA C++ now);
- the launch plan ``silu_plan`` covers every column of a row once, refuses
  widths whose h outgrows shared memory, and shares its constants with
  ``csrc/silu_quant.cu`` (read from the source text); the wrapper's input
  checks; the plain version (the CPU side of the wrapper) in bf16, fp16 and
  fp32 at odd widths.
"""

import importlib
import inspect
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl.text import swiglu_mlp
from spatialthinker_tpu.ops import quant as jq
from spatialthinker_tpu.ops.int8_matmul import fused_silu_quantize as jax_fused_silu_quantize
from spatialthinker_torch import csrc
from spatialthinker_torch.ops import quant as tq
from spatialthinker_torch.ops import silu_quant
from tests.test_torch_parity import CFG, both_models

torch.set_num_threads(2)
SOURCE = Path(silu_quant.__file__).resolve().parents[1] / "csrc" / "silu_quant.cu"


def test_module_imports_without_triton():
    """Importing the module builds no kernel and imports no triton (the
    kernel is CUDA C++ in ``csrc/silu_quant.cu``, built at its first launch):
    the package must import on a CPU-only PyTorch."""
    mod = importlib.reload(silu_quant)
    assert "triton" not in vars(mod) and "triton" not in inspect.getsource(mod)
    assert "triton" not in sys.modules
    assert csrc._lib is None  # nothing was built or loaded
    assert callable(mod.fused_silu_quantize) and mod.fused_silu_quantize.launches == 0


def _covered(plan, i):
    """Columns each (thread, pass) of ``silu_quant_kernel`` takes at width
    ``i``: thread t's chunks t, t + threads, ... (two a pass), 16 columns a
    chunk, the tail masked."""
    cols = []
    for t in range(plan.threads):
        for c0 in range(t, plan.chunks, silu_quant_unroll() * plan.threads):
            for k in range(silu_quant_unroll()):
                c = c0 + k * plan.threads
                if c < plan.chunks:
                    cols += [col for col in range(c * silu_quant.CHUNK, (c + 1) * silu_quant.CHUNK) if col < i]
    return sorted(cols)


def silu_quant_unroll():
    return int(re.search(r"constexpr int UNROLL = (\d+);", SOURCE.read_text()).group(1))


@pytest.mark.parametrize("i", [1, 15, 16, 17, 86, 4095, 11008, 18944, 58096])
def test_plan_covers_every_column_once(i):
    """The launch plan (a plain function the wrapper and the card tests
    share): every column of a row taken by exactly one thread and pass, whole
    warps, at most 256 threads, h within a block's shared memory."""
    plan = silu_quant.silu_plan(i)
    assert _covered(plan, i) == list(range(i))
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= silu_quant.MAX_THREADS
    assert plan.smem == plan.chunks * silu_quant.CHUNK * 4 <= silu_quant.KERNEL_MAX_SMEM


def test_plan_refuses_what_the_kernel_cannot_run():
    for i in (0, -3, 58097, 1 << 20):
        with pytest.raises(ValueError):
            silu_quant.silu_plan(i)
    for bad in (torch.zeros((4, 7)), torch.zeros((0, 8)), torch.zeros((4, 8), dtype=torch.int32),
                torch.zeros((4, 8), dtype=torch.float64), torch.zeros((8, 4)).t(), torch.zeros((4, 2 * 58112))):
        with pytest.raises(ValueError):
            silu_quant._check_cuda_input(bad)
    silu_quant._check_cuda_input(torch.zeros((4, 24))[:, 2:18])  # rows further apart than 2I take the stride


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("CHUNK") == silu_quant.CHUNK and const("MAX_THREADS") == silu_quant.MAX_THREADS
    assert const("MAX_SMEM") - const("MAX_THREADS") // 32 * 4 == silu_quant.KERNEL_MAX_SMEM
    assert "return chunks >= MAX_THREADS ? MAX_THREADS : (chunks + 31) / 32 * 32;" in src
    assert "int row_smem(int I) { return (I + CHUNK - 1) / CHUNK * CHUNK * 4; }" in src
    assert "fmaxf(row_amax, EPS) * (1.0f / 127.0f)" in src  # the plain version's scale on the card
    assert "rintf(h / scale)" in src                        # and its IEEE quotient


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("m,i", [(9, 86), (4, 16), (3, 17), (2, 1)])
def test_plain_takes_every_dtype_and_odd_widths(dtype, m, i):
    """The contract on the CPU (the plain version the wrapper runs there):
    bf16, fp16 and fp32 inputs, widths that are no multiple of 16, q the
    round-half-even quotient of h by the row scale."""
    rng = np.random.default_rng(m * i)
    gu = torch.from_numpy(rng.normal(size=(m, 2 * i)).astype(np.float32)).to(dtype)
    q, s = silu_quant.fused_silu_quantize(gu)
    g, u = gu[:, :i].double(), gu[:, i:].double()
    h = g * torch.sigmoid(g) * u
    s_ref = torch.clamp(h.abs().amax(1, keepdim=True), min=1e-8) / 127
    assert q.dtype == torch.int8 and tuple(q.shape) == (m, i) and s.dtype == torch.float32
    np.testing.assert_allclose(s.double().numpy(), s_ref.numpy(), rtol=1e-6)
    assert (q.double() - torch.round(h / s_ref)).abs().max() <= 1
    assert int(q.abs().max()) == 127


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
