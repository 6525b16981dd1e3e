"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc (they build ``spatialthinker_torch/csrc``)
and skip elsewhere. The file imports no JAX, so it also runs on a GPU host
without it: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.

Tolerances: both sides take the same bf16 inputs and accumulate in fp32; they
differ in summation order, in where the softmax weights are rounded to bf16
(the kernels round running-max-relative weights, the plain versions final
ones) and in the bf16 rounding of the output — a few bf16 ulps of an O(1)
output, so atol/rtol 2e-2. The logsumexp is fp32 end to end: atol 2e-3.
"""

import numpy as np
import pytest
import torch

from spatialthinker_torch.ops.decode_attention import decode_attention, decode_attention_plain
from spatialthinker_torch.ops.flash_attention import flash_fwd, flash_fwd_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)


def _segs(rng, b, s, kind):
    seg = np.ones((b, s), np.int32)
    if kind == "left_pad":
        for i in range(b):
            seg[i, : rng.integers(0, s // 2)] = 0
        seg[0, :] = 0  # a fully masked row
        seg[0, -1] = 1
    elif kind == "packed":
        seg[:, : s // 3] = 1
        seg[:, s // 3 : 2 * s // 3] = 2
        seg[:, 2 * s // 3 :] = 0
    return seg


FLASH_CASES = [
    # b, sq, skv, hq, hkv, d, causal, causal_offset, seg kind
    (2, 200, 200, 16, 2, 128, True, 0, "left_pad"),   # text prefill, ragged length
    (1, 300, 300, 4, 4, 80, False, 0, "packed"),      # vision full attention
    (6, 64, 64, 4, 4, 80, False, 0, "packed"),        # vision windows
    (2, 64, 192, 16, 2, 128, True, 128, "ones"),      # causal_offset
    (2, 130, 130, 14, 2, 128, True, 0, "left_pad"),   # G = 7
    (1, 96, 96, 4, 2, 128, True, 0, "packed"),        # packed causal text
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, case):
    b, sq, skv, hq, hkv, d, causal, off, kind = case
    rng = np.random.default_rng(sq + skv + d)
    q = _bf16(rng, (b, sq, hq, d), dev)
    k = _bf16(rng, (b, skv, hkv, d), dev)
    v = _bf16(rng, (b, skv, hkv, d), dev)
    kv_seg = _segs(rng, b, skv, kind)
    q_seg = kv_seg[:, skv - sq :] if sq != skv else kv_seg
    q_seg = torch.from_numpy(np.ascontiguousarray(q_seg)).to(dev)
    kv_seg = torch.from_numpy(kv_seg).to(dev)
    kw = dict(causal=causal, scale=d**-0.5, causal_offset=off)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, q_seg, kv_seg, **kw)
    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, q_seg, kv_seg, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=2e-3, rtol=0)
    dead = (q_seg == 0)
    assert torch.all(o[dead] == 0)


@pytest.mark.parametrize("hq,hkv,s", [(16, 2, 640), (14, 2, 200), (16, 16, 128)])
def test_decode_kernel_matches_plain(dev, hq, hkv, s):
    rng = np.random.default_rng(hq + s)
    b, d, n_layers = 3, 128, 3
    q = _bf16(rng, (b, hq, d), dev)
    kc = _bf16(rng, (n_layers, b, hkv, s, d), dev)
    vc = _bf16(rng, (n_layers, b, hkv, s, d), dev)
    seg = np.ones((b, s), np.int32)
    seg[:, s - s // 4 :] = 0
    seg[1, : s // 3] = 0
    seg[2] = 0  # no valid cell
    seg = torch.from_numpy(seg).to(dev)
    for layer in (0, n_layers - 1):
        ref = decode_attention_plain(q, kc, vc, seg, layer, d**-0.5)
        out = decode_attention(q, kc, vc, seg, layer)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
        assert torch.all(out[2] == 0)


def test_kernels_raise_on_unsupported_cuda_input(dev):
    q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=dev)
    seg = torch.ones((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        flash_fwd(q, q, q, seg, seg, causal=True, scale=1.0)
    with pytest.raises(ValueError):
        flash_fwd(q.float(), q.float(), q.float(), seg, seg, causal=True, scale=1.0)
    cache = torch.zeros((1, 1, 2, 8, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], cache, cache, seg, 0)
