"""The port's plain decode attention over quantized dense caches (the CPU side
of the CUDA kernels in ``csrc/decode_attention.cu``) against the JAX
package's Pallas decode kernels in interpret mode (``_pallas_decode``, called
as ``tests/test_decode_attention.py`` and ``tests/test_int4_kv.py`` call it,
with the block ``decode_attention`` itself would pick) and against its exact
XLA path (``_xla_decode``), on the same numpy inputs; plus ``repack_kv4`` and
the decode step's single-token ``_update_kv4`` against JAX, bit for bit.

Tolerances (outputs are O(0.1-1), bf16 on both sides):
- int8 cache vs the interpret-mode kernel: both round the softmax weights to
  bf16, the kernel relative to its running max and the plain version relative
  to the global one, and both round the output to bf16: atol/rtol 2e-2, the
  tolerance of ``tests/test_decode_attention.py``; vs ``_xla_decode`` (which
  rounds every dequantized value to bf16): the same 2e-2;
- int4 cache, bf16-lane dots, vs the kernel: same arithmetic (bf16 weights in
  the dot, fp32 weights in the -8 debias), other rounding points: atol 2e-2;
  vs ``_xla_decode``: relative output norm 2e-2 (``tests/test_int4_kv.py``);
- int4 cache, int8 dots, vs the kernel: the same integers unless a weight
  sits on a rounding tie (one step of 1/127 of its block's largest weight):
  atol 2e-2; vs ``_xla_decode``: relative norm 3e-2 (the reference's envelope
  for q and p rounding on top of the int4 KV);
- a row with no valid cell gives exact zeros in every mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl import text as jt
from spatialthinker_tpu.ops.decode_attention import _pallas_decode, _pick_block, _xla_decode
from spatialthinker_torch.models.qwen2_5_vl import text as tt
from spatialthinker_torch.ops import decode_attention as da

torch.set_num_threads(2)

D = 128
SCALE = D**-0.5


def _case(kind, hq, hkv, s, seed, b=3, n_layers=2):
    """Quantized by the JAX package's own functions from seeded normal K/V;
    ragged ``kv_seg`` (left padding, holes, an unwritten tail) and row 2 fully
    masked. Returns (jax args, torch args)."""
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(2, n_layers, b, hkv, s, D)).astype(np.float32)
    q = jnp.asarray(rng.normal(size=(b, hq, D)).astype(np.float32), jnp.bfloat16)
    seg = (rng.random((b, s)) < 0.7).astype(np.int32)
    seg[:, s - s // 8:] = 0   # unwritten decode tail
    seg[0, : s // 4] = 0      # left padding
    seg[:, s // 4] = 1
    seg[2] = 0                # a row with no valid cell
    if kind == "int8":
        kq, ks = jt._quantize_kv(jnp.asarray(kv[0]))
        vq, vs = jt._quantize_kv(jnp.asarray(kv[1]))
    else:
        k4, ks = jt._quantize_kv4(jnp.asarray(kv[0]))
        v4, vs = jt._quantize_kv4(jnp.asarray(kv[1]))
        half = s // 2
        kq = jt._pack_nibbles(k4[:, :, :, :half], k4[:, :, :, half:])
        vq = jt._pack_nibbles(v4[:, :, :, :half], v4[:, :, :, half:])
    jax_args = (q, kq, vq, jnp.asarray(seg), jnp.asarray(1, jnp.int32), ks, vs)

    def t(a, dtype=None):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.asarray(a).copy())

    torch_args = (t(q), t(kq), t(vq), torch.from_numpy(seg), 1, t(ks), t(vs))
    return jax_args, torch_args


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(a, b):
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9)


@pytest.mark.parametrize("hq,hkv", [(16, 2), (14, 2)], ids=["G8", "G7"])
def test_plain_int8_vs_pallas_and_xla(hq, hkv):
    jax_args, torch_args = _case("int8", hq, hkv, 256, seed=hq)
    got = _np(da.decode_attention(*torch_args))
    ref_k = _np(_pallas_decode(*jax_args, SCALE, _pick_block(256)))
    ref_x = _np(_xla_decode(*jax_args, SCALE))
    np.testing.assert_allclose(got, ref_k, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got, ref_x, atol=2e-2, rtol=2e-2)
    assert np.all(got[2] == 0.0) and np.abs(got[0]).max() > 0


@pytest.mark.parametrize("i8dot", [False, True], ids=["bf16dot", "i8dot"])
@pytest.mark.parametrize("s", [512, 768], ids=["one_block", "three_blocks"])
@pytest.mark.parametrize("hq,hkv", [(16, 2), (14, 2)], ids=["G8", "G7"])
def test_plain_int4_vs_pallas_and_xla(hq, hkv, s, i8dot):
    """Width 512 is one 256-row block, width 768 three 128-row blocks (the
    rule ``int4_block_rows`` shares with the TPU kernel's tiling)."""
    jax_args, torch_args = _case("int4", hq, hkv, s, seed=hq + s)
    assert da.int4_block_rows(s // 2) == min(_pick_block(s // 2), 256 if (s // 2) % 256 == 0 else 128)
    got = _np(da.decode_attention(*torch_args, int4_i8dot=i8dot))
    ref_k = _np(_pallas_decode(*jax_args, SCALE, _pick_block(s // 2), int4_i8dot=i8dot))
    ref_x = _np(_xla_decode(*jax_args, SCALE))
    np.testing.assert_allclose(got, ref_k, atol=2e-2, rtol=0)
    assert _rel(got, ref_x) < (3e-2 if i8dot else 2e-2)
    assert np.all(got[2] == 0.0) and np.abs(got[0]).max() > 0


def test_int8_dot_weights_round_per_block():
    """The int8-dot mode is a function of the block: quantizing the weights
    over the whole row instead moves the output, and the plain version sits
    with the kernel's blocks, not with the whole-row variant."""
    jax_args, torch_args = _case("int4", 16, 2, 768, seed=5)
    got = _np(da.decode_attention(*torch_args, int4_i8dot=True))
    ref_k = _np(_pallas_decode(*jax_args, SCALE, 128, int4_i8dot=True))
    saved = da.int4_block_rows
    da.int4_block_rows = lambda rows: rows  # one block per row
    try:
        whole = _np(da.decode_attention(*torch_args, int4_i8dot=True))
    finally:
        da.int4_block_rows = saved
    assert np.abs(got - ref_k).max() <= 2e-2
    assert np.abs(whole - got).max() > 0  # the rule matters


def test_cache_format_checks():
    _, torch_args = _case("int4", 4, 2, 256, seed=1)
    with pytest.raises(ValueError, match="needs k_scale"):
        da.decode_attention(*torch_args[:5])
    bf = torch.zeros((2, 3, 2, 256, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scales given"):
        da.decode_attention(torch_args[0], bf, bf, torch_args[3], 1, torch_args[5], torch_args[6])
    before = (da._launch_int8_kernel.launches, da._launch_int4_kernel.launches,
              da._launch_int4_i8_kernel.launches)
    da.decode_attention(*torch_args)
    assert before == (da._launch_int8_kernel.launches, da._launch_int4_kernel.launches,
                      da._launch_int4_i8_kernel.launches)  # CPU tensors never count a launch


@pytest.mark.parametrize("p,total", [(8, 16), (8, 12), (12, 16), (16, 16), (6, 32)])
def test_repack_kv4_bit_equal(p, total):
    """Prompt-width packed cache -> total-width layout: prompts that stay in
    the low half, that straddle the new half boundary, and an equal width."""
    rng = np.random.default_rng(p + total)
    src = rng.integers(0, 256, size=(2, 2, 2, p // 2, 8)).astype(np.uint8)
    ref = jt.repack_kv4(jnp.asarray(src), total)
    got = tt.repack_kv4(torch.from_numpy(src), total)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 2, 2, total // 2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("start", [0, 5, 7, 8, 13, 15])
def test_single_token_update_kv4_matches_traced_jax_write(start):
    """The decode step's write: one token at a start JAX only knows at run
    time (its traced branch), low and high half, first and last byte row."""
    rng = np.random.default_rng(start)
    arr = rng.integers(0, 256, size=(2, 2, 2, 8, 8)).astype(np.uint8)
    q4 = rng.integers(-7, 8, size=(2, 2, 1, 8)).astype(np.int8)
    ref = jt._update_kv4(jnp.asarray(arr), jnp.asarray(q4), 1, jnp.asarray(start, jnp.int32))
    buf = torch.from_numpy(arr.copy())
    tt._update_kv4(buf, torch.from_numpy(q4), 1, start)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref))
