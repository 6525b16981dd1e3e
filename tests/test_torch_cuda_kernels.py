"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc (they build ``spatialthinker_torch/csrc``)
and skip elsewhere. The file imports no JAX, so it also runs on a GPU host
without it: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.

Tolerances: both sides take the same bf16 inputs and accumulate in fp32; they
differ in summation order, in where the softmax weights are rounded to bf16
(the kernels round running-max-relative weights, the plain versions final
ones) and in the bf16 rounding of the output — a few bf16 ulps of an O(1)
output, so atol/rtol 2e-2. The logsumexp is fp32 end to end: atol 2e-3.
The flash forward also: padding rows o = 0 and lse = -1e30 exactly, two
calls bit-identical, its range launch's tables equal to ``tile_ranges``
(integers), one range and one forward launch counted per call.
The paged kernels repeat their plain versions' arithmetic page by page: the
stats m, l within 2e-3 (fast-math-free fp32, other summation order), the
bf16 output within 2e-2 (bf16 pools) or 1e-2 of an O(0.3) output (int8 and
int4 pools; an int8 softmax weight on a rounding tie may flip by one step).
The quantized dense-decode kernels (int8, int4, int4 with int8 dots) repeat
their plain version's arithmetic with a running max instead of the global
one: bf16 outputs of O(0.3) within 1e-2 (an int8 softmax weight on a rounding
tie may flip by one step of 1/127 of its block's largest weight). The int4
modes run the split kernel too (whole blocks a rank): under the rule's plan
and forced clusters, two calls bit-identical; the int8-dot mode refuses a
block of more than 256 rows, the widened-nibble mode takes any width.
The flash backward kernels round p and ds to bf16 before the second products
where the plain version keeps fp32: each gradient within 1e-2 of its own
largest magnitude (4e-3 to 7e-3 measured on an H100); padding rows exactly zero;
two calls bit-identical. Their pre-pass: delta within fp32 summation order
(atol 1e-4 on sums of 80-128 products of O(1) values), range tables equal.
The silu->int8 kernel: scales within 1e-5 relative, int8 values at most one
step apart and fewer than 1 in 100 differing (ties; the kernel repeats the
plain version's operations, so it is expected to agree bit for bit, and
``chip_smoke.py`` prints whether it does).
The dense decode kernel's bf16 and int8 modes (the split kernel) repeat the
plain version's arithmetic with each warp's own running max (bf16 weights
rounded against it) and the warps and ranks combined in order: the bf16 and
int8 tolerances above (2e-2 and 1e-2), and two calls bit-identical.
The int4 MLP kernels: the row quantize is the plain version's to the bit and
the int32 group dots are exact, so only the order of the fp32 group sums,
the silu's last bit and the bf16 rounding of the output differ: the largest
error within 1e-2 of the largest output magnitude (two bf16 ulps) for bf16
outputs, within 1e-4 of it for fp32 down (only the sum order differs); two
calls bit-identical (the plan's ranks are summed in rank order).
The fused W8A8 kernel: the row quantize divides as the plain version does,
the int32 dot is exact whatever the plan's split of K and the epilogue rounds
the same two products in the same order: equal bit for bit, and two calls
bit-identical.
The staged block of the paged kernels: the paged tolerances above.
The paged int4 kernel with int8 dots (#9) splits a slot's pages over the
ranks of a cluster, each with its own running max, and takes the weights'
exp through ex2 and their quantization as a product with 1 / pscale: the
int8 weights of a page do not depend on which max they are relative to, so
the same paged tolerances hold (m, l 2e-3, o 1e-2); two calls bit-identical
(ranks meet in rank order, warps in warp order, no atomics).
The paged kernels of bf16, int8 and int4 (widened-nibble) pools (#7, #8) run
the same split: a page passes in parts of the CTA's blocks, each part's
weights rounded to bf16 against the running max after it (the plain
versions: after the page), so only the weights' rounding and the exp move:
the paged tolerances above (bf16 2e-2, int8 and int4 1e-2), under the rule's
plan and other plans (cluster 1, 2, 3, 8; fewer warps, so more parts; other
ring depths), with and without the ring, at the shipped scale; two calls
bit-identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paged_cases

from spatialthinker_torch.ops import decode_attention as da
from spatialthinker_torch.ops.decode_attention import decode_attention, decode_attention_plain
from spatialthinker_torch.ops import paged_attention as pa
from spatialthinker_torch.ops import flash_attention as fa
from spatialthinker_torch.ops import int4_mlp as i4
from spatialthinker_torch.ops import int8_matmul as i8
from spatialthinker_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
from spatialthinker_torch.ops.silu_quant import fused_silu_quantize, fused_silu_quantize_plain

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
    elif kind == "nine_images":  # nine unequal images in one sequence, a padded tail
        seg[:] = 0
        start = 0
        for i, n in enumerate((310, 150, 220, 90, 260, 175, 205, 130, 240)):
            seg[:, start : start + n] = i + 1
            start += n
    elif kind == "non_monotone":  # ids 1, 2, 1 (one id in two places), then 3 and padding
        seg[:, : s // 4], seg[:, s // 4 : s // 2], seg[:, s // 2 : 3 * s // 4] = 1, 2, 1
        seg[:, 3 * s // 4 : s - 37] = 3
        seg[:, s - 37 :] = 0
    elif kind == "dead_row":  # two segments, and a batch row of padding only
        seg[:, s // 2 :] = 2
        seg[1 % b] = 0
    elif kind == "text_rows":  # the update's packed text rows: 2-3 samples per row
        seg[:] = 0
        for row in range(b):
            cuts = ((400, 790, 1000), (520, 980), (330, 660, 940), (470, 900, 1024))[row % 4]
            start = 0
            for i, end in enumerate(cuts):
                seg[row, start : min(end, s)] = i + 1
                start = end
    return seg


FLASH_CASES = [
    # b, sq, skv, hq, hkv, d, causal, causal_offset, seg kind
    (2, 200, 200, 16, 2, 128, True, 0, "left_pad"),   # text prefill, ragged length
    (1, 300, 300, 4, 4, 80, False, 0, "packed"),      # vision full attention
    (6, 64, 64, 4, 4, 80, False, 0, "packed"),        # vision windows
    (2, 64, 192, 16, 2, 128, True, 128, "ones"),      # causal_offset
    (2, 130, 130, 14, 2, 128, True, 0, "left_pad"),   # G = 7
    (1, 96, 96, 4, 2, 128, True, 0, "packed"),        # packed causal text
    # the backward's layouts, through the forward's tile skip
    (1, 2000, 2000, 4, 4, 80, False, 0, "nine_images"),  # vision full: nine unequal images
    (2, 400, 400, 4, 4, 80, False, 0, "non_monotone"),   # ids 1, 2, 1
    (4, 1024, 1024, 16, 2, 128, True, 0, "text_rows"),   # G = 8 at 4 x 1,024
    (3, 1000, 1000, 4, 4, 80, False, 0, "left_pad"),     # left padding over whole tiles
    # the forward's own edges
    (2, 100, 333, 16, 2, 128, True, 233, "left_pad"),    # ragged causal-offset chunk, Sq != Skv
    (2, 20, 20, 14, 2, 128, True, 0, "left_pad"),        # Skv shorter than one tile, G = 7
    (3, 150, 150, 4, 4, 80, False, 0, "dead_row"),       # a batch row of padding only
]
_BWD_BASE = 6  # the backward's cases below start from the first six forward cases


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
    assert torch.all(lse.transpose(1, 2)[dead] == fa.NEG_INF)


def _fwd_inputs(case, seed, dev):
    b, sq, skv, hq, hkv, d, causal, off, kind = case
    rng = np.random.default_rng(seed)
    q = _bf16(rng, (b, sq, hq, d), dev)
    k, v = _bf16(rng, (b, skv, hkv, d), dev), _bf16(rng, (b, skv, hkv, d), dev)
    kv_seg = _segs(rng, b, skv, kind)
    q_seg = torch.from_numpy(np.ascontiguousarray(kv_seg[:, skv - sq :])).to(dev)
    return q, k, v, q_seg, torch.from_numpy(kv_seg).to(dev), dict(causal=causal, scale=d**-0.5, causal_offset=off)


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[8] in ("nine_images", "text_rows", "left_pad")])
def test_flash_kernel_is_deterministic(dev, case):
    """Two forward calls on the same inputs give bit-identical o and lse (no
    atomics; every row's tiles are walked in one order)."""
    q, k, v, q_seg, kv_seg, kw = _fwd_inputs(case, 3, dev)
    first = flash_fwd(q, k, v, q_seg, kv_seg, **kw)
    second = flash_fwd(q, k, v, q_seg, kv_seg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("kind", ["nine_images", "non_monotone", "left_pad", "text_rows", "dead_row"])
def test_flash_range_kernel_matches_tile_ranges(dev, kind):
    """The forward's range launch equals the plain ``tile_ranges``, Sq != Skv."""
    rng = np.random.default_rng(9)
    q_seg = torch.from_numpy(_segs(rng, 3, 1000, kind)).to(dev)
    kv_seg = torch.from_numpy(_segs(rng, 3, 1333, "packed")).to(dev)
    before = fa._launch_ranges.launches
    q_rng, kv_rng = fa._launch_ranges(q_seg, kv_seg)
    torch.cuda.synchronize()
    assert fa._launch_ranges.launches == before + 1
    assert torch.equal(q_rng, fa.tile_ranges(q_seg)) and torch.equal(kv_rng, fa.tile_ranges(kv_seg))


def test_flash_forward_counts_one_launch_per_call(dev):
    """Each forward call launches the range kernel and the forward once."""
    q, k, v, q_seg, kv_seg, kw = _fwd_inputs(FLASH_CASES[3], 4, dev)
    before = (flash_fwd.launches, fa._launch_ranges.launches)
    for _ in range(3):
        flash_fwd(q, k, v, q_seg, kv_seg, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, fa._launch_ranges.launches) == (before[0] + 3, before[1] + 3)


FLASH_BWD_CASES = [c for c in FLASH_CASES[:_BWD_BASE] if c[7] == 0] + [
    (2, 512, 512, 16, 2, 128, True, 0, "packed"),     # multi-tile packed text rows
    (1, 1000, 1000, 16, 16, 80, False, 0, "packed"),  # vision full, ragged length
    (3, 70, 70, 2, 2, 80, True, 0, "left_pad"),       # G = 1 causal, ragged
    (1, 2000, 2000, 4, 4, 80, False, 0, "nine_images"),  # vision full: nine unequal images
    (2, 400, 400, 4, 4, 80, False, 0, "non_monotone"),   # ids 1, 2, 1
    (3, 1000, 1000, 4, 4, 80, False, 0, "left_pad"),     # left padding, vision heads
    (4, 1024, 1024, 16, 2, 128, True, 0, "text_rows"),   # G = 8 at 4 x 1,024: head splits
]


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_backward_kernels_match_plain(dev, case):
    b, sq, skv, hq, hkv, d, causal, _, kind = case
    rng = np.random.default_rng(sq + hq + d)
    q = _bf16(rng, (b, sq, hq, d), dev)
    k = _bf16(rng, (b, skv, hkv, d), dev)
    v = _bf16(rng, (b, skv, hkv, d), dev)
    do = _bf16(rng, (b, sq, hq, d), dev)
    seg = torch.from_numpy(_segs(rng, b, skv, kind)).to(dev)
    kw = dict(causal=causal, scale=d**-0.5)
    o, lse = flash_fwd(q, k, v, seg, seg, **kw)
    ref = fa.flash_bwd_plain(q, k, v, seg, seg, o, lse, do, **kw)
    before = (fa._launch_bwd_dq.launches, fa._launch_bwd_dkv.launches)
    got = fa.flash_bwd(q, k, v, seg, seg, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa._launch_bwd_dq.launches, fa._launch_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    dead = seg == 0
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(x.float()).all(), name
        err = (x.float() - r.float()).abs().max().item()
        assert err <= 1e-2 * r.float().abs().max().item(), (name, err)
        assert torch.all(x[dead] == 0), name


@pytest.mark.parametrize("case", [FLASH_BWD_CASES[i] for i in (-1, -4, -3)])
def test_flash_backward_kernels_are_deterministic(dev, case):
    """Two calls on the same inputs give bit-identical dq, dk and dv (no
    atomics; the head splits' partials are summed in a fixed order)."""
    b, sq, skv, hq, hkv, d, causal, _, kind = case
    rng = np.random.default_rng(7 + sq)
    q, do = _bf16(rng, (b, sq, hq, d), dev), _bf16(rng, (b, sq, hq, d), dev)
    k, v = _bf16(rng, (b, skv, hkv, d), dev), _bf16(rng, (b, skv, hkv, d), dev)
    seg = torch.from_numpy(_segs(rng, b, skv, kind)).to(dev)
    kw = dict(causal=causal, scale=d**-0.5)
    o, lse = flash_fwd(q, k, v, seg, seg, **kw)
    first = fa.flash_bwd(q, k, v, seg, seg, o, lse, do, **kw)
    second = fa.flash_bwd(q, k, v, seg, seg, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("kind", ["nine_images", "non_monotone", "left_pad", "text_rows"])
def test_flash_backward_prep_kernel_matches_plain(dev, kind):
    """The pre-pass: delta within fp32 summation order of the eager rowsum,
    the range tables equal."""
    b, s, hq, d = (4, 1024, 16, 128) if kind == "text_rows" else (3, 2000, 4, 80)
    rng = np.random.default_rng(5)
    do, o = _bf16(rng, (b, s, hq, d), dev), _bf16(rng, (b, s, hq, d), dev)
    seg = torch.from_numpy(_segs(rng, b, s, kind)).to(dev)
    kv_seg = torch.from_numpy(_segs(rng, b, s + 45, "packed")).to(dev)
    want = fa.flash_bwd_prep_plain(do, o, seg, kv_seg)
    before = fa._launch_bwd_prep.launches
    got = fa._launch_bwd_prep(do, o, seg, kv_seg)
    torch.cuda.synchronize()
    assert fa._launch_bwd_prep.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_flash_backward_kernels_cross_lengths(dev):
    """Sq != Skv, q_seg != kv_seg, not causal (another shard's k/v): the tile
    skip reads each side's own range table."""
    rng = np.random.default_rng(12)
    b, sq, skv, hq, hkv, d = 2, 150, 420, 8, 2, 128
    q, do = _bf16(rng, (b, sq, hq, d), dev), _bf16(rng, (b, sq, hq, d), dev)
    k, v = _bf16(rng, (b, skv, hkv, d), dev), _bf16(rng, (b, skv, hkv, d), dev)
    kv_seg = np.repeat(np.arange(1, 8, dtype=np.int32), 60)[None].repeat(b, 0)
    q_seg = np.ascontiguousarray(kv_seg[:, 100:250])
    q_seg[1, :40] = 0
    q_seg, kv_seg = torch.from_numpy(q_seg).to(dev), torch.from_numpy(kv_seg).to(dev)
    kw = dict(causal=False, scale=d**-0.5)
    o, lse = flash_fwd(q, k, v, q_seg, kv_seg, **kw)
    ref = fa.flash_bwd_plain(q, k, v, q_seg, kv_seg, o, lse, do, **kw)
    got = fa.flash_bwd(q, k, v, q_seg, kv_seg, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert torch.all(got[0][q_seg == 0] == 0)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        err = (x.float() - r.float()).abs().max().item()
        assert err <= 1e-2 * r.float().abs().max().item(), (name, err)


def test_flash_attention_function_backward_on_the_card(dev):
    """The autograd Function end to end (also under checkpoint): gradients of
    views into a fused projection equal the plain backward's."""
    from torch.utils.checkpoint import checkpoint

    rng = np.random.default_rng(11)
    b, s, hq, hkv, d = 2, 160, 8, 2, 128
    fused = _bf16(rng, (b, s, hq + 2 * hkv, d), dev).requires_grad_()
    seg = torch.from_numpy(_segs(rng, b, s, "packed")).to(dev)
    w = _bf16(rng, (b, s, hq, d), dev)

    def run(x):
        q, k, v = x[:, :, :hq].contiguous(), x[:, :, hq : hq + hkv].contiguous(), x[:, :, hq + hkv :].contiguous()
        return (fa.flash_attention(q, k, v, seg, seg, causal=True, scale=d**-0.5).float() * w.float()).sum()

    (g1,) = torch.autograd.grad(run(fused), fused)
    (g2,) = torch.autograd.grad(checkpoint(run, fused, use_reentrant=False), fused)
    q, k, v = fused[:, :, :hq].contiguous(), fused[:, :, hq : hq + hkv].contiguous(), fused[:, :, hq + hkv :].contiguous()
    o, lse = flash_fwd(q, k, v, seg, seg, causal=True, scale=d**-0.5)
    ref = torch.cat(fa.flash_bwd_plain(q, k, v, seg, seg, o, lse, w, causal=True, scale=d**-0.5), dim=2)
    torch.cuda.synchronize()
    assert torch.equal(g1, g2)
    assert (g1.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    with pytest.raises(NotImplementedError):
        out = fa.flash_attention(q.detach().requires_grad_(), k, v, seg, seg, causal=True,
                                 scale=d**-0.5, causal_offset=0 + 1)
        out.sum().backward()


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


def _quant_cache(dev, kind, b, hkv, s, n_layers=2, d=128, seed=0):
    """A dense quantized cache of random stored values and scales, with a
    ragged ``kv_seg``: left padding, holes, an unwritten tail, one empty row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    int4 = kind != "int8"
    shape = (n_layers, b, hkv, s // 2 if int4 else s, d)
    lo, hi, dtype = (0, 256, torch.uint8) if int4 else (-127, 128, torch.int8)
    k = torch.randint(lo, hi, shape, dtype=dtype, device=dev, generator=gen)
    v = torch.randint(lo, hi, shape, dtype=dtype, device=dev, generator=gen)
    s_lo, s_hi = (0.01, 0.1) if int4 else (0.001, 0.02)
    ks, vs = ((torch.rand((n_layers, b, hkv, s), device=dev, generator=gen) * (s_hi - s_lo) + s_lo)
              .to(torch.bfloat16) for _ in range(2))
    seg = (torch.rand((b, s), device=dev, generator=gen) < 0.8).to(torch.int32)
    seg[:, s - s // 6:] = 0
    seg[0, : s // 3] = 0
    seg[:, s // 3] = 1
    seg[b - 1] = 0
    return k, v, ks, vs, seg


QUANT_DECODE_CASES = [
    # kind, Hq, Hkv, S (int4: 768 = three 128-row blocks, 512 = one 256-row block,
    # 200 = one 100-row block, 1024 = two 256-row blocks)
    ("int8", 16, 2, 640), ("int8", 14, 2, 200), ("int8", 16, 16, 128),
    ("int4", 16, 2, 768), ("int4", 14, 2, 512), ("int4", 16, 2, 200),
    ("int4_i8", 16, 2, 768), ("int4_i8", 14, 2, 512), ("int4_i8", 16, 2, 200), ("int4_i8", 16, 4, 1024),
]


@pytest.mark.parametrize("kind,hq,hkv,s", QUANT_DECODE_CASES)
def test_quantized_decode_kernels_match_plain(dev, kind, hq, hkv, s):
    b, d = 5, 128
    rng = np.random.default_rng(hq + s)
    q = _bf16(rng, (b, hq, d), dev)
    k, v, ks, vs, seg = _quant_cache(dev, kind, b, hkv, s, seed=s)
    counter = {"int8": da._launch_int8_kernel, "int4": da._launch_int4_kernel,
               "int4_i8": da._launch_int4_i8_kernel}[kind]
    i8 = kind == "int4_i8"
    for layer in (0, 1):
        ref = decode_attention_plain(q, k, v, seg, layer, d**-0.5, ks, vs, i8)
        before = counter.launches, decode_attention.launches
        out = decode_attention(q, k, v, seg, layer, ks, vs, int4_i8dot=i8)
        torch.cuda.synchronize()
        assert (counter.launches, decode_attention.launches) == (before[0] + 1, before[1])
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
        assert torch.all(out[b - 1] == 0) and out[0].abs().max() > 0


SPLIT_CASES = [  # kind, Hq, Hkv, S, cluster (None: the rule's plan)
    (kind, hq, hkv, s, cluster)
    for kind in ("bf16", "int8")
    for hq, hkv in ((14, 2), (16, 2), (32, 2))
    for s in (128, 200, 640, 8192)
    for cluster in (None, 1, 2, 8)
]


def _split_case(dev, kind, hq, hkv, s, b=4, n_layers=3, seed=0):
    """q and a 3-layer cache of one format with a ragged ``kv_seg``: left
    padding, a hole, the unwritten tail, a row with no valid cell."""
    rng = np.random.default_rng(seed + s + hq)
    q = _bf16(rng, (b, hq, 128), dev)
    if kind == "bf16":
        k = _bf16(rng, (n_layers, b, hkv, s, 128), dev)
        v = _bf16(rng, (n_layers, b, hkv, s, 128), dev)
        ks = vs = None
        seg = np.ones((b, s), np.int32)
        seg[:, s - s // 5:] = 0
        seg[0, : s // 3] = 0
        seg[1, s // 2: s // 2 + 9] = 0
        seg[b - 1] = 0
        seg = torch.from_numpy(seg).to(dev)
    else:
        k, v, ks, vs, seg = _quant_cache(dev, "int8", b, hkv, s, n_layers=n_layers, seed=s + hq)
    return q, k, v, seg, ks, vs


@pytest.mark.parametrize("kind,hq,hkv,s,cluster", SPLIT_CASES)
def test_decode_split_kernel_matches_plain(dev, kind, hq, hkv, s, cluster):
    """#4 in both modes (the split kernel) against the plain version, under
    the rule's plan and plans of 1, 2 and 8 ranks, at the first and the last
    layer of the stack; two calls bit-identical."""
    q, k, v, seg, ks, vs = _split_case(dev, kind, hq, hkv, s)
    b = q.shape[0]
    mode = da.MODE_BF16 if kind == "bf16" else da.MODE_INT8
    plan = da.decode_plan(b, hkv, hq // hkv, s, mode, sms=pa.device_sms(dev.index), cluster=cluster)
    launch = da._launch_bf16_kernel if kind == "bf16" else da._launch_int8_kernel
    tol = 2e-2 if kind == "bf16" else 1e-2
    for layer in (0, k.shape[0] - 1):
        ref = decode_attention_plain(q, k, v, seg, layer, 128**-0.5, ks, vs)
        args = (q, k, v, seg, layer, 128**-0.5, ks, vs)
        out, again = launch(*args, plan=plan), launch(*args, plan=plan)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        assert torch.equal(out, again)
        assert torch.all(out[b - 1] == 0) and out[0].abs().max() > 0


INT4_SPLIT_CASES = [  # kind, Hq, Hkv, S, cluster (None: the rule's plan)
    (kind, hq, hkv, s, cluster)
    for kind in ("int4", "int4_i8")
    for hq, hkv in ((14, 2), (16, 2), (32, 2))
    for s in (200, 512, 768, 2048, 8192)
    for cluster in (None, 1, 2, 8)
]


@pytest.mark.parametrize("kind,hq,hkv,s,cluster", INT4_SPLIT_CASES)
def test_decode_int4_split_kernel_matches_plain(dev, kind, hq, hkv, s, cluster):
    """#5 and #6 (the int4 modes of the split kernel) against the plain
    version under the rule's plan and plans of 1, 2 and 8 ranks (more ranks
    than blocks leave ranks idle), at the first and the last layer; two calls
    bit-identical; one launch a call on the mode's counter."""
    b = 4
    rng = np.random.default_rng(s + hq)
    q = _bf16(rng, (b, hq, 128), dev)
    k, v, ks, vs, seg = _quant_cache(dev, kind, b, hkv, s, n_layers=3, seed=s + hq)
    i8 = kind == "int4_i8"
    mode = da.MODE_INT4_I8 if i8 else da.MODE_INT4
    plan = da.decode_plan(b, hkv, hq // hkv, s, mode, sms=pa.device_sms(dev.index), cluster=cluster)
    launch = da._launch_int4_i8_kernel if i8 else da._launch_int4_kernel
    for layer in (0, k.shape[0] - 1):
        ref = decode_attention_plain(q, k, v, seg, layer, 128**-0.5, ks, vs, i8)
        args = (q, k, v, seg, layer, 128**-0.5, ks, vs)
        before = launch.launches
        out, again = launch(*args, plan=plan), launch(*args, plan=plan)
        torch.cuda.synchronize()
        assert launch.launches == before + 2
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
        assert torch.equal(out, again)
        assert torch.all(out[b - 1] == 0) and out[0].abs().max() > 0


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "int4_i8"])
def test_decode_split_counts_one_launch_per_call(dev, kind):
    counters = [decode_attention, da._launch_int8_kernel, da._launch_int4_kernel, da._launch_int4_i8_kernel]
    mine = ["bf16", "int8", "int4", "int4_i8"].index(kind)
    if kind.startswith("int4"):
        q = _bf16(np.random.default_rng(7), (4, 16, 128), dev)
        k, v, ks, vs, seg = _quant_cache(dev, kind, 4, 2, 768)
    else:
        q, k, v, seg, ks, vs = _split_case(dev, kind, 16, 2, 640)
    before = [c.launches for c in counters]
    decode_attention(q, k, v, seg, 1, ks, vs, int4_i8dot=kind == "int4_i8")
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + (i == mine) for i, n in enumerate(before)]


def test_decode_split_smem_matches_plan(dev):
    """The Python plan's shared-memory arithmetic is the C side's, and both
    refuse the same plans."""
    from spatialthinker_torch import csrc
    lib = csrc.library()
    for mode in (da.MODE_BF16, da.MODE_INT8, da.MODE_INT4, da.MODE_INT4_I8):
        int4 = mode in (da.MODE_INT4, da.MODE_INT4_I8)
        for g in (1, 7, 8, 9, 16):
            for stages in range(1, (da.INT4_MAX_STAGES if int4 else da.SPLIT_MAX_STAGES) + 1):
                for cluster in (1, 8):
                    assert lib.st_decode_split_smem(mode, g, cluster, stages) == da.split_smem(mode, g, stages)
    for bad in ((4, 8, 1, 2), (0, 17, 1, 2), (0, 8, 9, 2), (0, 8, 1, 5), (1, 8, 0, 2), (1, 8, 1, 0),
                (2, 8, 1, 9), (3, 8, 1, 9), (3, 17, 1, 2)):
        assert lib.st_decode_split_smem(*bad) == -1
    # the C side refuses what decode_plan refuses: mode 3 with a ring shorter than a block, a block of
    # more than 256 rows, a block that does not divide the rows
    qi = _bf16(np.random.default_rng(1), (4, 16, 128), dev)
    ki, vi, ksi, vsi, segi = _quant_cache(dev, "int4_i8", 4, 2, 1024)
    out = torch.empty_like(qi)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (qi, ki, vi, ksi, vsi, segi, out)]
    for block_rows, stages in ((256, 3), (512, 8), (192, 4), (0, 4)):
        assert lib.st_decode_split(*ptrs, 2, 4, 16, 2, 1024, 0, da.MODE_INT4_I8, block_rows, 1, stages, 0.1,
                                   stream) != 0, (block_rows, stages)
    q, k, v, seg, _, _ = _split_case(dev, "bf16", 16, 2, 200)
    with pytest.raises(ValueError):  # a cluster the kernel cannot run
        da.decode_plan(4, 2, 8, 200, da.MODE_BF16, sms=132, cluster=9)
    with pytest.raises(ValueError):  # a cache of another layer count than the scales
        _, k8, v8, seg8, ks8, vs8 = _split_case(dev, "int8", 16, 2, 200)
        decode_attention(q, k8, v8, seg8, 0, ks8[:2].contiguous(), vs8[:2].contiguous())
    with pytest.raises(ValueError):  # a cache that is not contiguous
        decode_attention(q, k.transpose(3, 4).contiguous().transpose(3, 4), v, seg, 0)


def test_quantized_decode_wrapper_raises_on_unsupported_cuda_input(dev):
    q = _bf16(np.random.default_rng(0), (5, 16, 128), dev)
    k, v, ks, vs, seg = _quant_cache(dev, "int4", 5, 2, 512)
    with pytest.raises(ValueError):  # fp32 query
        decode_attention(q.float(), k, v, seg, 0, ks, vs)
    with pytest.raises(ValueError):  # scales of the packed width
        decode_attention(q, k, v, seg, 0, ks[..., :256].contiguous(), vs[..., :256].contiguous())
    with pytest.raises(ValueError):  # kv_seg of the packed width
        decode_attention(q, k, v, seg[:, :256].contiguous(), 0, ks, vs)
    with pytest.raises(ValueError, match="needs k_scale"):
        decode_attention(q, k, v, seg, 0)
    kb, vb, ksb, vsb, segb = _quant_cache(dev, "int4", 2, 1, 6000, n_layers=1)
    qb = q[:2, :8].contiguous()
    with pytest.raises(ValueError, match="one block"):  # one block of 3,000 byte rows
        decode_attention(qb, kb, vb, segb, 0, ksb, vsb, int4_i8dot=True)
    # the widened-nibble mode walks any block in tiles: the same width runs
    ref = decode_attention_plain(qb, kb, vb, segb, 0, 128**-0.5, ksb, vsb)
    out = decode_attention(qb, kb, vb, segb, 0, ksb, vsb)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


def test_kernels_raise_on_unsupported_cuda_input(dev):
    q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=dev)
    seg = torch.ones((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        flash_fwd(q, q, q, seg, seg, causal=True, scale=1.0)
    with pytest.raises(ValueError):
        flash_fwd(q.float(), q.float(), q.float(), seg, seg, causal=True, scale=1.0)
    with pytest.raises(ValueError):  # the backward refuses the same head dim
        fa.flash_bwd(q, q, q, seg, seg, q, torch.zeros((1, 2, 8), device=dev), q, causal=True, scale=1.0)
    cache = torch.zeros((1, 1, 2, 8, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], cache, cache, seg, 0)


def _paged_case(rng, dev, kind, g, page, lengths, hkv=2, n_layers=2, d=128):
    """Pools of one format with every slot's pages scattered over the pool."""
    s_slots = len(lengths)
    need = sum(-(-ell // page) for ell in lengths)
    n_pages = need + 2
    order = iter(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((s_slots, max(-(-ell // page) for ell in lengths) + 1), np.int32)
    for i, ell in enumerate(lengths):
        for c in range(-(-ell // page)):
            table[i, c] = next(order)
    shape = (n_layers, n_pages, hkv, page, d)
    scales = (None, None)
    if kind == "bf16":
        k, v = _bf16(rng, shape, dev), _bf16(rng, shape, dev)
    else:
        lim = 127 if kind == "int8" else 7
        k = rng.integers(-lim, lim + 1, size=shape).astype(np.int8)
        v = rng.integers(-lim, lim + 1, size=shape).astype(np.int8)
        lo, hi = (0.001, 0.02) if kind == "int8" else (0.01, 0.1)
        scales = tuple(
            torch.from_numpy(rng.uniform(lo, hi, size=shape[:-1]).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2)
        )
        if kind == "int4":
            half = page // 2
            k, v = ((((a[:, :, :, :half] + 8).astype(np.uint8) & 0xF)
                     | ((a[:, :, :, half:] + 8).astype(np.uint8) << 4).astype(np.uint8)) for a in (k, v))
        k, v = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    q = _bf16(rng, (s_slots, hkv * g, d), dev)
    return (q, k, v, torch.from_numpy(table).to(dev),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev), n_layers - 1, *scales)


PAGED_CASES = [
    # kind, G, page, lengths
    ("bf16", 8, 256, (600, 256, 37, 0, 511)),
    ("bf16", 7, 6, (11, 6, 1, 17)),
    ("bf16", 16, 1024, (1500, 1024, 3, 0, 2048)),  # a page of 8 parts
    ("bf16", 8, 130, (300, 131, 0, 390)),
    ("int8", 8, 256, (600, 256, 37, 0, 511)),
    ("int8", 7, 130, (300, 131, 0, 390)),
    ("int8", 16, 1024, (1500, 1024, 3, 0, 2048)),
    ("int8", 8, 2050, (4100, 2051, 1025, 1)),
    ("int4", 8, 256, (600, 256, 37, 0, 511)),
    ("int4", 8, 1024, (1500, 1024, 3, 2048)),
    ("int4", 7, 6, (11, 6, 1, 17, 0)),
    ("int4", 16, 130, (300, 131, 65, 66)),
    ("int4", 8, 2048, (5000, 2048, 3, 0, 1100)),  # pages beyond 1,024 cells pass in parts
    ("int4", 16, 2050, (4100, 2051, 1025, 1)),
    ("int4", 8, 4096, (9000, 4096, 600, 0)),
    ("int4_bf16dot", 8, 256, (600, 256, 37, 0, 511)),
    ("int4_bf16dot", 8, 1024, (1500, 1024, 3, 2048)),
    ("int4_bf16dot", 7, 6, (11, 6, 1, 17, 0)),
    ("int4_bf16dot", 16, 130, (300, 131, 65, 66)),
    ("int4_bf16dot", 8, 2048, (5000, 2048, 3, 0, 1100)),
    ("int4_bf16dot", 16, 2050, (4100, 2051, 1025, 1)),
]


@pytest.mark.parametrize("kind,g,page,lengths", PAGED_CASES)
def test_paged_kernels_match_plain(dev, kind, g, page, lengths):
    rng = np.random.default_rng(page + g)
    args = _paged_case(rng, dev, kind.split("_")[0], g, page, lengths)
    i8 = kind == "int4"
    plain, counter = {
        "int4": (pa.paged_attention_int4_i8_plain, pa._launch_int4_i8_kernel),
        "int4_bf16dot": (pa.paged_attention_int4_plain, pa._launch_int4_kernel),
    }.get(kind, (pa.paged_attention_plain, pa._launch_pool_kernel))
    o_ref, m_ref, l_ref = plain(*args, 128**-0.5)
    before = counter.launches
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=i8)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    torch.testing.assert_close(m, m_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(l, l_ref, atol=2e-3, rtol=2e-3)
    tol = 2e-2 if kind == "bf16" else 1e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    for i, ell in enumerate(lengths):
        if ell == 0:
            assert torch.all(o[i] == 0) and torch.all(l[i] == 0) and torch.all(m[i] == -1e30)


def _ring(rng, dev, kind, lengths, c, hkv=2, n_layers=2, d=128):
    """A staging ring for the pools of ``_paged_case``: bf16 cells under bf16
    pools, int8 cells (int4 values under int4 pools) with bf16 scales
    otherwise; about half the cells live, slot 0 with none."""
    shape = (n_layers, len(lengths), hkv, c, d)
    if kind == "bf16":
        k, v, ks, vs = _bf16(rng, shape, dev), _bf16(rng, shape, dev), None, None
    else:
        lim, lo, hi = (127, 0.001, 0.02) if kind == "int8" else (7, 0.01, 0.1)
        k, v = (torch.from_numpy(rng.integers(-lim, lim + 1, size=shape).astype(np.int8)).to(dev)
                for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(lo, hi, size=shape[:-1]).astype(np.float32)).to(dev, torch.bfloat16)
                  for _ in range(2))
    seg = (rng.random((len(lengths), c)) < 0.5).astype(np.int32)
    seg[0] = 0
    for i, ell in enumerate(lengths):
        if ell == 0:
            seg[i, 0] = 1  # a slot with ring cells and no pool cell
    return k, v, ks, vs, torch.from_numpy(seg).to(dev)


STAGED_CASES = [  # kind, G, page, lengths, ring cells
    ("bf16", 8, 256, (600, 256, 37, 0, 511), 16),
    ("bf16", 16, 1024, (1500, 1024, 3, 0), 200),  # a ring of two parts
    ("int4_bf16dot", 7, 130, (300, 131, 65, 66, 0), 3),
    ("int8", 8, 256, (600, 256, 37, 0, 511), 16),
    ("int4", 8, 256, (600, 256, 37, 0, 511), 16),
    ("int4_bf16dot", 8, 256, (600, 256, 37, 0, 511), 16),
    ("int4", 7, 6, (11, 6, 1, 17, 0), 80),  # a ring over two staging tiles
    ("int8", 7, 130, (300, 131, 0, 390), 3),
    ("int4", 8, 2048, (5000, 2048, 3, 0), 16),  # the ring after pages in parts
]


@pytest.mark.parametrize("kind,g,page,lengths,c", STAGED_CASES)
def test_staged_block_matches_plain(dev, kind, g, page, lengths, c):
    """The staged block (``staged=``) in every mode of the paged kernel
    against the plain versions with the same ring."""
    rng = np.random.default_rng(page + g + c)
    pool = kind.split("_")[0]
    args = _paged_case(rng, dev, pool, g, page, lengths)
    ring = _ring(rng, dev, pool, lengths, c)
    i8 = kind == "int4"
    plain = {"int4": pa.paged_attention_int4_i8_plain,
             "int4_bf16dot": pa.paged_attention_int4_plain}.get(kind, pa.paged_attention_plain)
    o_ref, m_ref, l_ref = plain(*args, 128**-0.5, ring)
    before = pa._launch.staged_launches
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=i8, staged=ring)
    torch.cuda.synchronize()
    assert pa._launch.staged_launches == before + 1
    torch.testing.assert_close(m, m_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(l, l_ref, atol=2e-3, rtol=2e-3)
    tol = 2e-2 if kind == "bf16" else 1e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    unfused = pa.paged_attention(*args, return_stats=True, int4_i8dot=i8)
    assert not torch.equal(unfused[2], l)  # the ring cells entered


def _shipped_case(dev):
    """The shipped scale of #9 (``paged_cases.make_shipped``): 128 lanes in
    16 groups of 8 sharing their prompt pages + the trash lane, page 1024,
    lengths in [6144, 8192], a one-layer pool."""
    return paged_cases.call_args(torch, paged_cases.make_shipped(torch, np, dev), dev)


def _assert_paged_close(o, m, l, ref):
    o_ref, m_ref, l_ref = ref
    torch.testing.assert_close(m, m_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(l, l_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)


def test_paged_int4_i8_shipped_scale(dev):
    """#9 at the shipped scale (page 1024, 129 lanes, 16 groups of 8 sharing
    their prompt pages, up to 8 pages a slot) against the plain version."""
    args = _shipped_case(dev)
    ref = pa.paged_attention_int4_i8_plain(*args, 128**-0.5)
    o, m, l = pa.paged_attention(*args, return_stats=True, int4_i8dot=True)
    torch.cuda.synchronize()
    _assert_paged_close(o, m, l, ref)
    assert torch.all(o[-1] == 0) and torch.all(l[-1] == 0) and torch.all(m[-1] == -1e30)


@pytest.mark.parametrize("ring", [0, 16])
@pytest.mark.parametrize("g,page,lengths", [(8, 256, (600, 256, 37, 0, 511)), (8, 1024, (1500, 1024, 3, 2048)),
                                            (7, 6, (11, 6, 1, 17, 0))])
def test_paged_int4_i8_bit_identical_twice(dev, g, page, lengths, ring):
    """Two calls of the split kernel agree bit for bit: the ranks meet in
    rank order and the warps' partials in warp order, no atomics."""
    rng = np.random.default_rng(page + g + ring)
    args = _paged_case(rng, dev, "int4", g, page, lengths)
    staged = _ring(rng, dev, "int4", lengths, ring) if ring else None
    first = pa.paged_attention(*args, return_stats=True, int4_i8dot=True, staged=staged)
    second = pa.paged_attention(*args, return_stats=True, int4_i8dot=True, staged=staged)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("cluster,warps,stages", [(1, None, 1), (3, None, 2), (4, 2, 3), (8, None, 4), (2, 4, 1),
                                                  (1, 1, None), (3, 1, 1)])
@pytest.mark.parametrize("ring", [0, 16])
def test_paged_int4_i8_other_plans_match_plain(dev, cluster, warps, stages, ring):
    """Plans the rule would not pick (other cluster sizes, fewer warps taking
    more blocks each, deeper or shallower rings; a cluster wider than a slot's
    pages; one warp, so a page of 256 cells passes in two parts) still equal
    the plain version, with and without the ring."""
    lengths = (600, 256, 37, 0, 511, 1)
    rng = np.random.default_rng(cluster + ring)
    args = _paged_case(rng, dev, "int4", 8, 256, lengths)
    staged = _ring(rng, dev, "int4", lengths, ring) if ring else None
    sms = pa.device_sms(0)
    plan = pa.paged_plan(len(lengths), 2, 8, 256, args[3].shape[1], ring, sms=sms, cluster=cluster, warps=warps,
                         stages=stages)
    assert plan != pa.paged_plan(len(lengths), 2, 8, 256, args[3].shape[1], ring, sms=sms)
    ref = pa.paged_attention_int4_i8_plain(*args, 128**-0.5, staged)
    before = pa._launch_int4_i8_kernel.launches
    o, m, l = pa._launch_int4_i8_kernel(*args, 128**-0.5, staged, plan=plan)
    torch.cuda.synchronize()
    assert pa._launch_int4_i8_kernel.launches == before + 1
    _assert_paged_close(o, m, l, ref)


def test_paged_int4_i8_refused_plans(dev):
    """The plan refuses what the kernel cannot run, and the C side refuses a
    plan that bypasses it, before anything launches."""
    rng = np.random.default_rng(3)
    lengths = (600, 256, 37, 0, 511)
    args = _paged_case(rng, dev, "int4", 8, 256, lengths)
    p_max, sms = args[3].shape[1], pa.device_sms(0)
    for bad in (dict(cluster=9), dict(warps=9), dict(stages=5), dict(stages=0), dict(warps=1, stages=2)):
        with pytest.raises(ValueError):
            pa.paged_plan(len(lengths), 2, 8, 256, p_max, sms=sms, **bad)
    with pytest.raises(ValueError, match="parts"):
        pa.paged_plan(4, 2, 8, 2048, 3, sms=sms, stages=2)  # 64 blocks a page: two parts through one slot pair
    good = pa.paged_plan(len(lengths), 2, 8, 256, p_max, sms=sms)
    for bad in (dict(cluster=9), dict(warps=1), dict(blocks_per_warp=3), dict(stages=0), dict(stages=5)):
        plan = dataclasses.replace(good, **bad)
        with pytest.raises(RuntimeError, match="CUDA error"):
            pa._launch_int4_i8_kernel(*args, 128**-0.5, None, plan=plan)


def test_paged_split_smem_matches_plan(dev):
    """``split_smem`` (Python) and ``split_layout`` (the .cu file) agree in every mode."""
    lib = pa.csrc.library()
    for mode in (pa.MODE_BF16, pa.MODE_INT8, pa.MODE_INT4_I8, pa.MODE_INT4):
        for g in (7, 8, 16):
            for page in (6, 130, 256, 1024, 2048, 2050, 4096):
                for ring in (0, 3, 16):
                    plan = pa.paged_plan(65, 2, g, page, 9, ring, sms=pa.device_sms(0), mode=mode)
                    assert lib.st_paged_split_smem(mode, g, page, ring, plan.cluster, plan.warps, plan.stages,
                                                   plan.blocks_per_warp) == plan.smem


POOL_KINDS = {  # kind: (pool format, mode, plain version, counted launcher)
    "bf16": ("bf16", pa.MODE_BF16, pa.paged_attention_plain, pa._launch_pool_kernel),
    "int8": ("int8", pa.MODE_INT8, pa.paged_attention_plain, pa._launch_pool_kernel),
    "int4_bf16dot": ("int4", pa.MODE_INT4, pa.paged_attention_int4_plain, pa._launch_int4_kernel),
}


def _launch_mode(kind, args, staged, plan):
    _, mode, _, launcher = POOL_KINDS[kind]
    if mode == pa.MODE_INT4:
        return launcher(*args, 128**-0.5, staged, plan=plan)
    return launcher(*args, 128**-0.5, staged, mode=mode, plan=plan)


def _assert_pool_close(kind, out, ref):
    tol = 2e-2 if kind == "bf16" else 1e-2
    torch.testing.assert_close(out[1], ref[1], atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(out[2], ref[2], atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(out[0].float(), ref[0].float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", list(POOL_KINDS))
@pytest.mark.parametrize("ring", [0, 16])
@pytest.mark.parametrize("cluster,warps,stages", [(1, None, 1), (2, None, 2), (3, 4, 3), (8, 4, 4), (2, 2, 1),
                                                  (1, 1, None)])
def test_paged_pool_modes_other_plans_match_plain(dev, kind, ring, cluster, warps, stages):
    """Modes 0, 1, 3 under plans the rule would not pick (clusters 1, 2, 3, 8,
    a cluster wider than a slot's pages; fewer warps, so a page of 256 cells
    passes in 2 to 16 parts; shallower and deeper rings) equal the plain
    version, with and without the ring."""
    pool, mode, plain, launcher = POOL_KINDS[kind]
    lengths = (600, 256, 37, 0, 511, 1)
    rng = np.random.default_rng(cluster + ring + mode)
    args = _paged_case(rng, dev, pool, 8, 256, lengths)
    staged = _ring(rng, dev, pool, lengths, ring) if ring else None
    plan = pa.paged_plan(len(lengths), 2, 8, 256, args[3].shape[1], ring, sms=pa.device_sms(0), cluster=cluster,
                         warps=warps, stages=stages, mode=mode)
    assert plan != pa.paged_plan(len(lengths), 2, 8, 256, args[3].shape[1], ring, sms=pa.device_sms(0), mode=mode)
    ref = plain(*args, 128**-0.5, staged)
    before = launcher.launches
    out = _launch_mode(kind, args, staged, plan)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    _assert_pool_close(kind, out, ref)
    assert torch.all(out[0][3] == 0) == (ring == 0 or not bool(staged[4][3].any()))


@pytest.mark.parametrize("kind", list(POOL_KINDS))
@pytest.mark.parametrize("ring", [0, 16])
@pytest.mark.parametrize("g,page,lengths", [(8, 256, (600, 256, 37, 0, 511)), (16, 1024, (1500, 1024, 3, 2048)),
                                            (7, 6, (11, 6, 1, 17, 0))])
def test_paged_pool_modes_bit_identical_twice(dev, kind, ring, g, page, lengths):
    """Two calls of modes 0, 1, 3 agree bit for bit: the warps' partials meet
    in warp order and the ranks in rank order, no atomics."""
    pool, mode, _, _ = POOL_KINDS[kind]
    rng = np.random.default_rng(page + g + ring)
    args = _paged_case(rng, dev, pool, g, page, lengths)
    staged = _ring(rng, dev, pool, lengths, ring) if ring else None
    kw = dict(return_stats=True, staged=staged)
    first, second = pa.paged_attention(*args, **kw), pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("kind", list(POOL_KINDS))
def test_paged_pool_modes_shipped_scale(dev, kind):
    """Modes 0, 1, 3 at the shipped scale (``paged_cases.make_shipped``: page
    1024, 129 lanes, 16 groups of 8 sharing their prompt pages, bf16 / int8 /
    int4 pools over the same tables) against the plain versions."""
    pool, mode, plain, _ = POOL_KINDS[kind]
    args = paged_cases.call_args(torch, paged_cases.make_shipped(torch, np, dev, kind=pool), dev)
    ref = plain(*args, 128**-0.5)
    out = pa.paged_attention(*args, return_stats=True)
    torch.cuda.synchronize()
    _assert_pool_close(kind, out, ref)
    assert torch.all(out[0][-1] == 0) and torch.all(out[2][-1] == 0) and torch.all(out[1][-1] == -1e30)


def test_paged_pool_modes_refused_plans(dev):
    """Modes 0, 1, 3: the plan refuses what the kernel cannot run, and the C
    side refuses a plan that bypasses it, before anything launches."""
    rng = np.random.default_rng(4)
    lengths = (600, 256, 37, 0, 511)
    sms = pa.device_sms(0)
    for kind, (pool, mode, _, _) in POOL_KINDS.items():
        args = _paged_case(rng, dev, pool, 8, 256, lengths)
        p_max = args[3].shape[1]
        for bad in (dict(cluster=9), dict(warps=9), dict(stages=5), dict(stages=0), dict(warps=0)):
            with pytest.raises(ValueError):
                pa.paged_plan(len(lengths), 2, 8, 256, p_max, sms=sms, mode=mode, **bad)
        good = pa.paged_plan(len(lengths), 2, 8, 256, p_max, sms=sms, mode=mode)
        for bad in (dict(cluster=9), dict(warps=9), dict(blocks_per_warp=2), dict(stages=0), dict(stages=5)):
            with pytest.raises(RuntimeError, match="CUDA error"):
                _launch_mode(kind, args, None, dataclasses.replace(good, **bad))
    with pytest.raises(ValueError, match="shared memory"):  # a bf16 ring of 512 cells outgrows a block
        pa.paged_plan(4, 2, 8, 256, 3, 512, sms=sms, mode=pa.MODE_BF16)


W8A8_LINEARS = {  # (K, N, the linear's out dtype): the 3B and 7B presets
    "qkv": (2048, 2560, torch.bfloat16), "o": (2048, 2048, torch.bfloat16),
    "gate_up": (2048, 22016, torch.bfloat16), "down": (11008, 2048, torch.bfloat16),
    "head": (2048, 151936, torch.float32),
    "qkv_7b": (3584, 4608, torch.bfloat16), "o_7b": (3584, 3584, torch.bfloat16),
    "gate_up_7b": (3584, 37888, torch.bfloat16), "down_7b": (18944, 3584, torch.bfloat16),
    "head_7b": (3584, 152064, torch.float32),
}
# decode lanes of the engines (65, 128, 129, 136), the m16 / m64 edges, the
# regimes' meeting point (256 / 257), a prefill chunk and a refill
W8A8_MS = [1, 15, 16, 17, 64, 65, 128, 129, 136, 255, 256, 257, 1024, 4096]


def _w8a8_inputs(dev, name, m, x_dtype=torch.bfloat16):
    k, n, _ = W8A8_LINEARS[name]
    gen = torch.Generator(device=dev).manual_seed(k + n + m)
    x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
    x[m // 2] = 0  # the eps floor
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=gen, device=dev) * 1e-3
    return x, w, ws


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", W8A8_MS)
@pytest.mark.parametrize("name", list(W8A8_LINEARS))
def test_w8a8_kernel_bit_equal_to_plain(dev, name, m, out_dtype):
    x, w, ws = _w8a8_inputs(dev, name, m)
    n = w.shape[0]
    before = i8.fused_w8a8_matmul.launches
    out = i8.fused_w8a8_matmul(x, w, ws, out_dtype)
    torch.cuda.synchronize()
    assert i8.fused_w8a8_matmul.launches == before + 1
    assert out.dtype == out_dtype and tuple(out.shape) == (m, n)
    assert torch.equal(out, i8.fused_w8a8_matmul_plain(x, w, ws, out_dtype))
    # the prologue off: rows quantized elsewhere
    xq, xs = i8.quantize_rows(x)
    before = i8.w8a8_matmul_prequantized.launches
    pre = i8.w8a8_matmul_prequantized(xq, xs, w, ws, out_dtype)
    torch.cuda.synchronize()
    assert i8.w8a8_matmul_prequantized.launches == before + 1
    assert torch.equal(pre, out)


@pytest.mark.parametrize("m", [1, 65, 136, 256, 1024])
@pytest.mark.parametrize("name", list(W8A8_LINEARS))
def test_w8a8_kernel_fp32_x_bit_equal_to_plain(dev, name, m):
    x, w, ws = _w8a8_inputs(dev, name, m, torch.float32)
    out_dtype = W8A8_LINEARS[name][2]
    out = i8.fused_w8a8_matmul(x, w, ws, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, i8.fused_w8a8_matmul_plain(x, w, ws, out_dtype))


@pytest.mark.parametrize("splits", [None, 8])
@pytest.mark.parametrize("m", [65, 136, 256, 1024])
@pytest.mark.parametrize("name", ["qkv", "down", "qkv_7b", "o_7b", "down_7b", "gate_up"])
def test_w8a8_kernel_is_deterministic(dev, name, m, splits):
    """Two calls agree bit for bit: the split-K partials meet in an exact
    int32 sum, in no order that atomics could change (the plan's own split,
    and K cut over a cluster of 8)."""
    x, w, ws = _w8a8_inputs(dev, name, m)
    k, n, out_dtype = W8A8_LINEARS[name]
    real = i8.w8a8_plan
    plan = real(m, n, k, splits=splits)
    try:
        i8.w8a8_plan = lambda *a, **kw: plan
        first = i8.fused_w8a8_matmul(x, w, ws, out_dtype)
        second = i8.fused_w8a8_matmul(x, w, ws, out_dtype)
        torch.cuda.synchronize()
    finally:
        i8.w8a8_plan = real
    assert torch.equal(first, second)
    assert torch.equal(first, i8.fused_w8a8_matmul_plain(x, w, ws, out_dtype))


def test_w8a8_kernel_runs_every_built_tile_and_split(dev):
    """Every tile the kernel builds, with and without split-K and at the
    ring's depths, on one shape: bit-equal to the plain chain."""
    k, n, m = 1024, 768, 200
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=gen, device=dev) * 1e-3
    ref = i8.fused_w8a8_matmul_plain(x, w, ws, torch.bfloat16)
    real = i8.w8a8_plan
    plans = []
    for mb, bn in sorted(i8.TILES):
        for splits, stages in ((1, 2), (3, 3), (8, 8)):
            plan = i8.W8A8Plan("prefill", mb, bn, splits, stages, -(-m // (64 * mb)), -(-n // bn),
                               i8.split_k_ranges(k, splits), i8.xq_box_rows(m, mb, bn))
            if plan.smem_bytes <= i8.SMEM_LIMIT:
                plans.append(plan)
    try:
        for plan in plans:
            i8.w8a8_plan = lambda *a, _p=plan, **kw: _p
            out = i8.fused_w8a8_matmul(x, w, ws, torch.bfloat16)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), plan
    finally:
        i8.w8a8_plan = real
    assert {(p.mb, p.bn) for p in plans} == i8.TILES


def test_w8a8_kernel_refuses_a_plan_it_cannot_run(dev):
    """The C side checks the plan it is given: nine splits (more than a
    portable cluster), one stage, an unbuilt tile, more splits than k-steps
    are refused before anything launches."""
    x, w, ws = _w8a8_inputs(dev, "o", 65)
    real = i8.w8a8_plan
    good = real(65, 2048, 2048)
    bad = [good._replace(splits=9), good._replace(stages=1), good._replace(bn=96),
           good._replace(mb=5), good._replace(splits=8, stages=9)]
    try:
        for plan in bad:
            i8.w8a8_plan = lambda *a, _p=plan, **kw: _p
            with pytest.raises(RuntimeError, match="launch failed"):
                i8.fused_w8a8_matmul(x, w, ws)
    finally:
        i8.w8a8_plan = real
    with pytest.raises(ValueError):  # 16 splits of 2 k-steps
        real(65, 2048, 256, splits=16)
    assert torch.equal(i8.fused_w8a8_matmul(x, w, ws), i8.fused_w8a8_matmul_plain(x, w, ws))


def test_w8a8_kernel_takes_fp32_x_and_raises_on_unsupported_shapes(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((33, 512), generator=gen, device=dev)
    w = torch.randint(-127, 128, (384, 512), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.rand((384,), generator=gen, device=dev) * 1e-3
    assert torch.equal(i8.fused_w8a8_matmul(x, w, ws), i8.fused_w8a8_matmul_plain(x, w, ws))
    with pytest.raises(ValueError, match="multiple of 32"):  # K % 32
        i8.fused_w8a8_matmul(x[:, :500].contiguous(), w[:, :500].contiguous(), ws)
    with pytest.raises(ValueError, match="multiple of 8"):  # N % 8
        i8.fused_w8a8_matmul(x, w[:380], ws[:380])
    with pytest.raises(ValueError):  # fp16 output
        i8.fused_w8a8_matmul(x, w, ws, torch.float16)
    with pytest.raises(ValueError):  # a transposed (non-contiguous) weight
        i8.fused_w8a8_matmul(x[:, :384].contiguous(), w[:, :384].t(), ws[:384].contiguous())


@pytest.mark.parametrize("m,i,dtype", [(1024, 11008, torch.bfloat16), (8, 18944, torch.bfloat16),
                                       (33, 86, torch.float32)])
def test_silu_quant_kernel_matches_plain(dev, m, i, dtype):
    rng = np.random.default_rng(i)
    gu = torch.from_numpy(rng.normal(size=(m, 2 * i)).astype(np.float32)).to(dev, dtype)
    gu[1] = 0  # an all-zero row takes the eps floor
    q_ref, s_ref = fused_silu_quantize_plain(gu)
    before = fused_silu_quantize.launches
    q, s = fused_silu_quantize(gu)
    torch.cuda.synchronize()
    assert fused_silu_quantize.launches == before + 1
    assert q.dtype == torch.int8 and tuple(q.shape) == (m, i) and tuple(s.shape) == (m, 1)
    torch.testing.assert_close(s, s_ref, atol=0, rtol=1e-5)
    diff = (q.int() - q_ref.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) < 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("m,i", [(1024, 11008), (8, 18944), (33, 86), (4096, 11008), (1024, 18944)])
def test_silu_quant_kernel_dtypes_and_widths(dev, m, i, dtype):
    """The CUDA junction at the prefill's widths (3B, 7B), a width that is no
    multiple of 16, in every input dtype, within the existing limits; rows
    `stride` values apart (a column slice of a wider tensor) take the same
    values as contiguous ones."""
    rng = np.random.default_rng(m + i)
    gu = torch.from_numpy(rng.normal(size=(m, 2 * i)).astype(np.float32)).to(dev, dtype)
    gu[m // 2] = 0  # an all-zero row takes the eps floor
    q_ref, s_ref = fused_silu_quantize_plain(gu)
    q, s = fused_silu_quantize(gu)
    wide = torch.zeros((m, 2 * i + 24), dtype=dtype, device=dev)
    wide[:, 8: 8 + 2 * i] = gu
    q_w, s_w = fused_silu_quantize(wide[:, 8: 8 + 2 * i])
    torch.cuda.synchronize()
    torch.testing.assert_close(s, s_ref, atol=0, rtol=1e-5)
    diff = (q.int() - q_ref.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) < 1e-2
    assert torch.equal(q_w, q) and torch.equal(s_w, s)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("m,i,tp", [(4096, 11008, 2), (1024, 18944, 4), (33, 172, 2)])
def test_silu_quant_split_mode_equals_one_pass(dev, m, i, tp, dtype):
    """The split mode (tensor parallelism: each rank's I / tp columns with the
    row scale of the whole I) on ``tp`` column slices, their amaxes maxed:
    the slices' q side by side and each slice's scale equal the one-pass
    kernel on the whole row bit for bit, each pass its plain version, and
    one launch a pass."""
    from spatialthinker_torch.ops import silu_quant as sqm

    rng = np.random.default_rng(m + i + tp)
    gu = torch.from_numpy(rng.normal(size=(m, 2 * i)).astype(np.float32)).to(dev, dtype)
    gu[m // 2] = 0
    part = i // tp
    pieces = [torch.cat([gu[:, r * part:(r + 1) * part], gu[:, i + r * part:i + (r + 1) * part]], dim=1).contiguous()
              for r in range(tp)]
    before = sqm.silu_row_amax.launches, sqm.silu_quantize_with_amax.launches
    amaxes = [sqm.silu_row_amax(p) for p in pieces]
    amax = torch.stack(amaxes).amax(dim=0)
    outs = [sqm.silu_quantize_with_amax(p, amax) for p in pieces]
    q, s = fused_silu_quantize(gu)
    torch.cuda.synchronize()
    assert (sqm.silu_row_amax.launches, sqm.silu_quantize_with_amax.launches) == (before[0] + tp, before[1] + tp)
    assert torch.equal(torch.cat([o[0] for o in outs], dim=1), q)
    assert all(torch.equal(o[1], s) for o in outs)
    for p, a, (qo, so) in zip(pieces, amaxes, outs):
        assert torch.equal(a, sqm.silu_row_amax_plain(p))
        q_ref, s_ref = sqm.silu_quantize_with_amax_plain(p, amax)
        assert torch.equal(qo, q_ref) and torch.equal(so, s_ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("m,k,tp", [(129, 2048, 2), (4096, 11008, 2), (129, 3584, 4), (1024, 18944, 4), (1, 64, 2)])
def test_quantize_rows_split_mode_equals_one_pass(dev, m, k, tp, dtype):
    """Kernel A's row quantize in its split mode (a row-parallel product's
    input under tensor parallelism: each rank's K / tp columns with the scale
    of the whole row) on ``tp`` column slices, their amaxes maxed: the slices'
    xq side by side and each slice's scale equal ``quantize_rows`` of the
    whole row bit for bit, each pass its plain version, one launch a pass."""
    rng = np.random.default_rng(m + k + tp)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev, dtype)
    x[m // 2] = 0  # the eps floor
    part = k // tp
    pieces = [x[:, r * part:(r + 1) * part].contiguous() for r in range(tp)]
    before = i8.row_amax.launches, i8.quantize_rows_with_amax.launches
    amaxes = [i8.row_amax(p) for p in pieces]
    amax = torch.stack(amaxes).amax(dim=0)
    outs = [i8.quantize_rows_with_amax(p, amax) for p in pieces]
    xq, xs = i8.quantize_rows(x)
    torch.cuda.synchronize()
    assert (i8.row_amax.launches, i8.quantize_rows_with_amax.launches) == (before[0] + tp, before[1] + tp)
    assert torch.equal(torch.cat([o[0] for o in outs], dim=1), xq)
    assert all(torch.equal(o[1], xs) for o in outs)
    for p, a, (qo, so) in zip(pieces, amaxes, outs):
        assert torch.equal(a, i8.row_amax_plain(p))
        q_ref, s_ref = i8.quantize_rows_with_amax_plain(p, amax)
        assert torch.equal(qo, q_ref) and torch.equal(so, s_ref)
    with pytest.raises(ValueError, match="multiple of 32"):
        i8.row_amax(x[:, :48].contiguous())


def test_silu_plan_matches_the_c_side(dev):
    from spatialthinker_torch import csrc
    from spatialthinker_torch.ops import silu_quant as sqm
    lib = csrc.library()
    for i in (1, 15, 16, 17, 86, 4095, 4096, 4097, 11008, 18944, 58096):
        plan = sqm.silu_plan(i)
        assert (lib.st_silu_quant_threads(i), lib.st_silu_quant_smem(i)) == (plan.threads, plan.smem)
    with pytest.raises(ValueError, match="shared memory"):
        fused_silu_quantize(torch.zeros((2, 2 * 58112), dtype=torch.bfloat16, device=dev))


def test_paged_and_silu_wrappers_raise_on_unsupported_cuda_input(dev):
    rng = np.random.default_rng(0)
    args = list(_paged_case(rng, dev, "int4", 8, 256, (300, 10)))
    with pytest.raises(ValueError, match="ring scales"):  # a ring without scales under int4 pools
        pa.paged_attention(*args, int4_i8dot=False, staged=(None,) * 5)
    with pytest.raises(ValueError):  # fp32 query
        pa.paged_attention(args[0].float(), *args[1:], int4_i8dot=False)
    with pytest.raises(ValueError):  # fp32 query
        pa.paged_attention(args[0].float(), *args[1:], int4_i8dot=True)
    with pytest.raises(ValueError):  # int64 table
        pa.paged_attention(*args[:3], args[3].long(), *args[4:], int4_i8dot=True)
    big = _paged_case(rng, dev, "bf16", 16, 256, (10,), hkv=1, n_layers=1)
    with pytest.raises(ValueError, match="shared memory"):  # a bf16 ring of 512 cells outgrows a block
        pa.paged_attention(*big, staged=_ring(rng, dev, "bf16", (10,), 512, hkv=1, n_layers=1))
    with pytest.raises(ValueError):
        fused_silu_quantize(torch.zeros((4, 7), device=dev))
    with pytest.raises(ValueError):
        fused_silu_quantize(torch.zeros((4, 8), dtype=torch.int32, device=dev))


INT4_CASES = [  # m, E, I, group: gate_up x (m, E) -> (m, I); down x (m, I) -> (m, E)
    (136, 2048, 11008, 128), (8, 512, 256, 64), (2, 256, 128, 32), (26, 1024, 512, 128),
]
# two row tiles each; the rule refuses down at m = 256 (and the 7B down at 136)
INT4_GATEUP_CASES = INT4_CASES + [(256, 2048, 11008, 128)]
INT4_DOWN_CASES = INT4_CASES + [(200, 2048, 11008, 128)]


def _int4_case(dev, m, k, n_cols, group, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng, (m, k), dev)
    w = torch.from_numpy((rng.normal(size=(n_cols, k)) * 0.02).astype(np.float32)).to(dev)
    return x, i4.Int4Weight.from_weight(w, group)


@pytest.mark.parametrize("m,k,i,group", INT4_GATEUP_CASES)
def test_int4_gateup_kernel_matches_plain(dev, m, k, i, group):
    x, w = _int4_case(dev, m, k, 2 * i, group, seed=m)
    before = i4.w4_gateup_silu.launches
    out = i4.w4_gateup_silu(x, w)
    again = i4.w4_gateup_silu(x, w)
    torch.cuda.synchronize()
    assert i4.w4_gateup_silu.launches == before + 2
    ref = i4.w4_gateup_silu_plain(x, w.q4, w.gscale)
    assert out.dtype == torch.bfloat16 and out.shape == (m, i)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,k,group", INT4_DOWN_CASES)
def test_int4_down_kernel_matches_plain(dev, m, n, k, group, out_dtype):
    x, w = _int4_case(dev, m, k, n, group, seed=m + 1)
    before = i4.w4_matmul.launches
    out = i4.w4_matmul(x, w, out_dtype=out_dtype)
    again = i4.w4_matmul(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert i4.w4_matmul.launches == before + 2
    ref = i4.w4_matmul_plain(x, w.q4, w.gscale, out_dtype=torch.float32)
    assert out.dtype == out_dtype and out.shape == (m, n)
    err = (out.float() - ref).abs().max().item()
    assert err <= (1e-4 if out_dtype == torch.float32 else 1e-2) * ref.abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("gateup", [True, False])
@pytest.mark.parametrize("m,e,i,group", INT4_CASES + [(200, 2048, 11008, 128)])
def test_int4_prologue_bit_equal_to_quantize_rows(dev, m, e, i, group, gateup):
    """The prologue's xq (read back through ``staged_offsets``) and xs equal
    ``quantize_rows`` bit for bit."""
    k, n_cols = (e, 2 * i) if gateup else (i, e)
    x, w = _int4_case(dev, m, k, n_cols, group, seed=m + 2)
    out = torch.empty((m, n_cols // 2 if gateup else n_cols), dtype=torch.bfloat16, device=dev)
    scratch = i4._launch(x, w, out, gateup)
    torch.cuda.synchronize()
    plan = i4.w4_plan(m, k, out.shape[1], gateup, pa.device_sms(dev.index), group)
    xq_ref, xs_ref = i4.quantize_rows(x)
    xq = scratch[i4.staged_offsets(m, k, plan).to(dev)].view(torch.int8)
    xs = scratch[scratch.numel() - 4 * m:].view(torch.float32)
    assert torch.equal(xq, xq_ref)
    assert torch.equal(xs, xs_ref.reshape(-1))


@pytest.mark.parametrize("gateup,m,k,n,plan_kw", [
    (True, 136, 2048, 11008, dict(warps=4, ranks=2)),   # split K over a cluster at gate_up
    (True, 136, 2048, 11008, dict(warps=8)),            # two warpgroups
    (False, 136, 11008, 2048, dict(warps=12, ranks=4)),  # three warpgroups, split K
    (True, 8, 2048, 11008, dict(warps=4, stages=2)),
    (False, 136, 11008, 2048, dict(warps=4, ranks=1)),  # down without the split
    (False, 136, 11008, 2048, dict(warps=4, ranks=3)),  # a last rank with fewer stages
    (False, 26, 1024, 512, dict(tile_rows=16)),         # two row tiles below 144 rows
])
def test_int4_other_plans_match_plain(dev, monkeypatch, gateup, m, k, n, plan_kw):
    """Plans the rule would not pick equal the plain version within the
    card tolerances and bit-identical twice."""
    real = i4.w4_plan
    monkeypatch.setattr(i4, "w4_plan", lambda *a, **kw: real(*a, **kw, **plan_kw))
    x, w = _int4_case(dev, m, k, 2 * n if gateup else n, 128, seed=m + 3)
    if gateup:
        out, again = i4.w4_gateup_silu(x, w), i4.w4_gateup_silu(x, w)
        ref = i4.w4_gateup_silu_plain(x, w.q4, w.gscale).float()
        tol = 1e-2
    else:
        out, again = i4.w4_matmul(x, w, torch.float32), i4.w4_matmul(x, w, torch.float32)
        ref, tol = i4.w4_matmul_plain(x, w.q4, w.gscale, torch.float32), 1e-4
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert torch.equal(out, again)


def test_int4_refused_plans_raise(dev):
    """A plan the kernel cannot run is refused before any launch: by the plan
    (ValueError) and, for one passed past it, by the C side."""
    with pytest.raises(ValueError):
        i4.w4_plan(136, 2048, 11008, True, warps=9)
    with pytest.raises(ValueError):
        i4.w4_plan(136, 11008, 2048, False, ranks=9)
    with pytest.raises(ValueError):
        i4.w4_plan(136, 2048, 11008, True, stages=6)  # six stages of 54 KB
    from spatialthinker_torch import csrc

    x, w = _int4_case(dev, 8, 256, 256, 128, seed=4)
    out = torch.empty((8, 256), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty((1 << 20,), dtype=torch.uint8, device=dev)
    lib = csrc.library()
    args = (x.data_ptr(), scratch.data_ptr(), w.q4.data_ptr(), w.gscale.data_ptr(), out.data_ptr(), 8, 256, 256,
            128, 0, 0)
    stream = torch.cuda.current_stream().cuda_stream
    for plan in ((9, 1, 2, 8), (6, 1, 2, 8), (16, 1, 2, 8), (4, 2, 2, 8), (4, 1, 7, 8), (4, 1, 2, 12),
                 (4, 1, 2, 136), (4, 1, 2, 152)):
        assert lib.st_int4_mlp(*args, *plan, stream) != 0, plan


def test_int4_wrappers_raise_on_unsupported_cuda_input(dev):
    x, w = _int4_case(dev, 8, 256, 256, 128, seed=3)
    with pytest.raises(ValueError, match="bf16 activations"):
        i4.w4_matmul(x.float(), w)
    with pytest.raises(ValueError, match="group sizes"):
        i4.w4_matmul(x, i4.Int4Weight.from_weight(torch.zeros(256, 256, device=dev), 16))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        i4.w4_matmul(x, w, out_dtype=torch.float16)
    assert i4.w4_matmul(x[:7], w) is None  # the rule refuses an odd m before any launch
