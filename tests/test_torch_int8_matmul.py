"""The port's fused W8A8 matmul (``spatialthinker_torch/ops/int8_matmul.py``:
``fused_w8a8_matmul_plain``, the CPU side of the CUDA kernel, which is
``ops.quant.quantized_dot``) against the JAX package's ``fused_w8a8_matmul``
with its Pallas kernels in interpret mode: the resident-weight kernel #10
(``_kernel_resident_w``, epilogue ``(acc * xs) * ws``) and, with the VMEM
budget lowered until the resident panel no longer fits, the streaming kernel
#11 (``_kernel``, epilogue ``acc * (xs * ws)``).

The JAX kernels take m in multiples of 8; odd m (1, 7, 65) goes to them with
zero rows appended, which change no other row (the quantization is per row).

Tolerance. The int8 dot is exact on both sides, so differences come from two
places only:
- the row scale: the port divides, ``max(amax, 1e-8) / 127``, while XLA
  compiles the JAX kernel's division under ``jit`` as ``amax * (1 / 127)``,
  one fp32 ulp off in some rows (``tests/test_torch_int4_mlp.py::
  test_jitted_scale_is_amax_times_the_reciprocal``). In such a row the output
  may differ by three ulps of the output type from the scale (one ulp of
  relative error entering two rounded products, then the output rounding),
  plus one int8 step (``xs * ws * 127``) for
  each element of x at a half step that the other scale rounds the other
  way; the quantized x itself is equal outside such rows and within one
  step inside them;
- #11's epilogue order ``acc * (xs * ws)``: the two rounded products in the
  other association, up to two ulps of the output type.
Every other element is equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops import int8_matmul as jim
from spatialthinker_torch import csrc
from spatialthinker_torch.ops import int8_matmul as tim
from spatialthinker_torch.ops.quant import quantize_weight, quantized_dot

OUT = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}


def _case(m, k, n, x_dtype, seed, zero_row=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    if zero_row:  # the eps floor: xs = 1e-8 / 127, xq = 0
        x[m // 2] = 0.0
    qw = quantize_weight(torch.from_numpy((rng.normal(size=(n, k)) * 0.05).astype(np.float32)), 1)
    return torch.from_numpy(x).to(x_dtype), qw


def _jax(x, qw, out_dtype):
    m, k = x.shape
    padded = np.zeros((-(-m // 8) * 8, k), np.float32)
    padded[:m] = x.float().numpy()
    jx = jnp.asarray(padded, jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    out = jim.fused_w8a8_matmul(jx, jnp.asarray(qw["qvalue"].t().numpy()), jnp.asarray(qw["scale"].numpy()),
                                out_dtype=out_dtype)
    assert out is not None
    return np.asarray(out, np.float32)[:m]


def _ulp(v, torch_dtype):
    a = np.maximum(np.abs(v), np.float32(2.0**-126))
    mant = 7 if torch_dtype == torch.bfloat16 else 23
    return np.exp2(np.floor(np.log2(a)) - mant)


def _assert_close_up_to_the_jitted_scale(got, ref, x, qw, out_dtype, epilogue_ulps):
    xf = x.float().numpy()
    xq, xs = (t.numpy() for t in tim.quantize_rows(x))
    xs = xs[:, 0]
    amax = np.abs(xf).max(axis=1)
    xs_jit = np.asarray(jax.jit(lambda a: jnp.maximum(a, 1e-8) / 127.0)(jnp.asarray(amax)))
    moved = xs != xs_jit
    # the JAX kernel's int8 x: its (jitted) scale, then the division as the port's
    xq_jit = np.clip(np.rint(xf / xs_jit[:, None]), -127, 127)
    flips = xq_jit != xq
    assert not flips[~moved].any() and np.abs(xq_jit - xq).max() <= 1
    ws = qw["scale"].numpy()
    step = xs[:, None] * ws[None, :] * 127.0 * flips.sum(axis=1)[:, None]
    allowed = (epilogue_ulps + 3 * moved[:, None]) * _ulp(np.maximum(np.abs(got), np.abs(ref)), out_dtype) + step
    diff = np.abs(got - ref)
    assert (diff <= allowed).all(), (diff - allowed).max()
    if epilogue_ulps == 0:
        np.testing.assert_array_equal(got[~moved], ref[~moved])


SHAPES = [(1, 256, 128), (7, 512, 384), (65, 256, 384), (64, 512, 384)]


@pytest.mark.parametrize("out", ["bf16", "fp32"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["x_bf16", "x_fp32"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_the_resident_kernel(m, k, n, x_dtype, out):
    """#10: the whole weight panel resident, epilogue (acc * xs) * ws — the
    port's order: bit-equal outside the rows the jitted scale moved."""
    x, qw = _case(m, k, n, x_dtype, seed=m + k + n, zero_row=m == 65)
    assert jim._resident_bm(-(-m // 8) * 8, n, k) is not None
    got = tim.fused_w8a8_matmul(x, qw["qvalue"], qw["scale"], OUT[out][0])
    assert got.dtype == OUT[out][0] and got.shape == (m, n)
    torch.testing.assert_close(got, quantized_dot(x, qw, 1, out_dtype=OUT[out][0]), rtol=0, atol=0)
    ref = _jax(x, qw, OUT[out][1])
    _assert_close_up_to_the_jitted_scale(got.float().numpy(), ref, x, qw, OUT[out][0], epilogue_ulps=0)
    if m == 65:
        assert (got[m // 2] == 0).all()


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["x_bf16", "x_fp32"])
@pytest.mark.parametrize("m,k,n", [s for s in SHAPES if s[2] == 384])
def test_plain_matches_the_streaming_kernel(m, k, n, x_dtype, monkeypatch):
    """#11: the VMEM budget lowered until the resident panel does not fit, so
    (K, bn) weight blocks stream; its epilogue acc * (xs * ws) rounds once
    more: within two ulps of the output."""
    mp = -(-m // 8) * 8
    for budget in range(1 << 20, 0, -1024):
        monkeypatch.setattr(jim, "_VMEM_BUDGET", budget)
        if jim._resident_bm(mp, n, k) is None:
            break
    assert jim._pick_blocks(mp, n, k)[0] is not None
    x, qw = _case(m, k, n, x_dtype, seed=3 * m + k)
    got = tim.fused_w8a8_matmul(x, qw["qvalue"], qw["scale"]).float().numpy()
    ref = _jax(x, qw, jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)
    _assert_close_up_to_the_jitted_scale(got, ref, x, qw, x_dtype, epilogue_ulps=2)


def test_prequantized_route_equals_the_fused_one():
    x, qw = _case(33, 512, 384, torch.bfloat16, seed=4)
    xq, xs = tim.quantize_rows(x)
    pre = tim.w8a8_matmul_prequantized(xq, xs, qw["qvalue"], qw["scale"], torch.bfloat16)
    torch.testing.assert_close(pre, tim.fused_w8a8_matmul(x, qw["qvalue"], qw["scale"]), rtol=0, atol=0)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(csrc, "library", no_library)
    tim.fused_w8a8_matmul.launches = tim.w8a8_matmul_prequantized.launches = 0
    x, qw = _case(65, 256, 128, torch.bfloat16, seed=5)
    quantized_dot(x[None], qw, 1)
    quantized_dot(x, qw, 1, out_dtype=torch.float32)
    tim.fused_w8a8_matmul(x, qw["qvalue"], qw["scale"])
    assert tim.fused_w8a8_matmul.launches == 0 and tim.w8a8_matmul_prequantized.launches == 0
