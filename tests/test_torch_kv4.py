"""The port's KV-cache encodings (``spatialthinker_torch/models/qwen2_5_vl/text.py``)
against the JAX package's, bit for bit: one cache must be readable by both
packages. int8 and int4 quantization, nibble packing (+8 biased, split-half
along the sequence), the in-place ``_update_kv4`` across the half boundary
and at odd starts, and ``_layer_kv``'s live-prefix unpack. Everything here
is integer or a single fp32 rounding, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl import text as jt
from spatialthinker_torch.models.qwen2_5_vl import text as tt

torch.set_num_threads(2)


def _bf16(a):
    """numpy view of a bf16 tensor's bits (both frameworks)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("fn", ["_quantize_kv", "_quantize_kv4"])
def test_quantize_kv_bit_equal(fn):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0            # zero row: the 1e-6 floor
    x[1, 2, 4, :3] = [3.5, -3.5, 7.0]
    ref_q, ref_s = getattr(jt, fn)(jnp.asarray(x))
    q, s = getattr(tt, fn)(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(_bf16(s), _bf16(ref_s))
    back = tt._dequantize_kv(q, s, torch.float32)
    ref_back = jt._dequantize_kv(ref_q, ref_s, jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_back))


def test_pack_unpack_nibbles_bit_equal():
    rng = np.random.default_rng(1)
    low = rng.integers(-7, 8, size=(2, 3, 6, 16)).astype(np.int8)
    high = rng.integers(-7, 8, size=(2, 3, 6, 16)).astype(np.int8)
    ref = jt._pack_nibbles(jnp.asarray(low), jnp.asarray(high))
    got = tt._pack_nibbles(torch.from_numpy(low), torch.from_numpy(high))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    lo, hi = tt._unpack_nibbles(got)
    np.testing.assert_array_equal(lo.numpy(), low)
    np.testing.assert_array_equal(hi.numpy(), high)
    both = tt._unpack_kv4(got, seq_axis=2)
    np.testing.assert_array_equal(both.numpy(), np.asarray(jt._unpack_kv4(ref, seq_axis=2)))
    assert tt.KV4_BIAS == jt.KV4_BIAS == 8


@pytest.mark.parametrize("start,s", [(0, 4), (3, 1), (5, 6), (8, 5), (11, 5), (0, 16), (7, 2)])
def test_update_kv4_bit_equal(start, s):
    """Writes in the low half, the high half, across the boundary (5+6 > 8),
    at odd starts, and the whole width; untouched nibbles keep their value."""
    rng = np.random.default_rng(2)
    n_layers, b, hkv, width, d = 2, 2, 2, 16, 8
    arr = rng.integers(0, 256, size=(n_layers, b, hkv, width // 2, d)).astype(np.uint8)
    q4 = rng.integers(-7, 8, size=(b, hkv, s, d)).astype(np.int8)
    ref = jt._update_kv4(jnp.asarray(arr), jnp.asarray(q4), 1, start)
    buf = torch.from_numpy(arr.copy())
    out = tt._update_kv4(buf, torch.from_numpy(q4), 1, start)
    assert out is buf  # in place
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(buf.numpy()[0], arr[0])  # other layers untouched


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("end", [None, 3, 8, 11, 16])
def test_layer_kv_bit_equal(kind, end):
    rng = np.random.default_rng(3)
    n_layers, b, hkv, width, d = 2, 2, 2, 16, 8
    shape = (n_layers, b, hkv, width, d)
    scales = (None, None)
    if kind == "bf16":
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
    else:
        lim = 127 if kind == "int8" else 7
        k = rng.integers(-lim, lim + 1, size=shape).astype(np.int8)
        v = rng.integers(-lim, lim + 1, size=shape).astype(np.int8)
        scales = tuple(rng.uniform(0.01, 0.1, size=shape[:-1]).astype(np.float32) for _ in range(2))
    if kind == "int4":
        half = width // 2
        jk = jt._pack_nibbles(jnp.asarray(k[:, :, :, :half]), jnp.asarray(k[:, :, :, half:]))
        jv = jt._pack_nibbles(jnp.asarray(v[:, :, :, :half]), jnp.asarray(v[:, :, :, half:]))
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    js = tuple(None if s is None else jnp.asarray(s, jnp.bfloat16) for s in scales)
    tk, tv = torch.tensor(np.asarray(jk)), torch.tensor(np.asarray(jv))
    ts = tuple(None if s is None else torch.from_numpy(s).to(torch.bfloat16) for s in scales)
    ref_k, ref_v = jt._layer_kv(jk, jv, 1, jnp.float32, *js, end=end)
    got_k, got_v = tt._layer_kv(tk, tv, 1, torch.float32, *ts, end=end)
    assert tuple(got_k.shape) == tuple(ref_k.shape)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


@pytest.mark.parametrize("marker", [torch.bfloat16, torch.int8, torch.uint8])
def test_kvcache_init_shapes(marker):
    c = tt.KVCache.init(2, 3, 16, 2, 8, dtype=marker, device="cpu")
    rows = 8 if marker == torch.uint8 else 16
    assert tuple(c.k.shape) == (2, 3, 2, rows, 8) and c.k.dtype == marker and c.length == 0
    if marker == torch.bfloat16:
        assert c.k_scale is None and len(c.arrays()) == 2
    else:
        assert tuple(c.k_scale.shape) == (2, 3, 2, 16) and c.k_scale.dtype == torch.bfloat16
        assert len(c.arrays()) == 4
    if marker == torch.uint8:
        with pytest.raises(ValueError, match="even width"):
            tt.KVCache.init(2, 3, 15, 2, 8, dtype=marker, device="cpu")
