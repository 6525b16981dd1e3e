"""The flash forward's tile skip (``fwd_live_tiles``), in plain versions.

The CUDA forward runs a (q tile, kv tile) pair of ``FWD_Q_ROWS`` x
``FWD_KV_ROWS`` rows only when the segment-id ranges of the two tiles
intersect and, when causal, the kv tile starts at or before the diagonal of
the q tile's last row (``kv_start <= causal_offset + last_row``). These tests
hold that rule to ``make_attention_mask`` on seeded layouts (no unmasked pair
may fall in a skipped pair; exactly the needed pairs on contiguous layouts),
and run a tile-walking plain forward -- online softmax over only the live
tiles, in the kernel's order and arithmetic (scores in log2 units, ``exp2``)
-- against ``flash_fwd_plain`` and the JAX package's ``_flash_fwd`` (Pallas,
interpret mode), with the tolerance of ``tests/test_torch_flash_attention.py``:
fp32 inputs on every side, the same algorithm up to summation order and the
log2 folding, atol/rtol 1e-5. Masks and tile rules are integer: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops.flash_attention import _flash_fwd
from spatialthinker_torch.data.packing import pack_vision_batch
from spatialthinker_torch.models.qwen2_5_vl.config import qwen25_vl_3b
from spatialthinker_torch.ops import flash_attention as fa
from tests.test_torch_flash_tiles import LAYOUTS, _layout

TOL = dict(atol=1e-5, rtol=1e-5)


def _forward_layout(kind, rng):
    """(q_seg, kv_seg, causal, causal_offset): the backward's six layouts and
    the forward's own edges."""
    if kind in LAYOUTS:
        return (*_layout(kind, rng), 0)
    if kind == "causal_offset_chunk":  # the chunked prefill: the last 256 rows against all 512
        kv_seg = np.ones((4, 512), np.int32)
        for row in kv_seg:
            row[: int(rng.integers(0, 300))] = 0
        return np.ascontiguousarray(kv_seg[:, 256:]), kv_seg, True, 256
    if kind == "ragged_offset":  # Sq != Skv, neither a tile multiple
        kv_seg = np.zeros((2, 333), np.int32)
        kv_seg[:, 40:190], kv_seg[:, 190:300], kv_seg[:, 300:] = 1, 2, 3
        kv_seg[1, :120] = 0
        return np.ascontiguousarray(kv_seg[:, 233:]), kv_seg, True, 233
    if kind == "short_kv":  # Skv shorter than one range tile
        seg = np.ones((3, 20), np.int32)
        seg[1, :7] = 0
        seg[2, 12:] = 2
        return seg, seg, True, 0
    if kind == "padding_row":  # a batch row that is all padding
        seg = np.zeros((3, 260), np.int32)
        seg[0, :100], seg[0, 100:250] = 1, 2
        seg[2, 30:] = 5
        return seg, seg, False, 0
    raise ValueError(kind)


FORWARD_LAYOUTS = LAYOUTS + ["causal_offset_chunk", "ragged_offset", "short_kv", "padding_row"]
CONTIGUOUS = ["contiguous_packing", "left_padding", "dead_rows", "causal_offset_chunk", "ragged_offset",
              "short_kv", "padding_row"]
TILE_SIZES = [(fa.FWD_Q_ROWS, fa.FWD_KV_ROWS), (32, 32), (128, 64)]


def _tensors(q_seg, kv_seg):
    return torch.from_numpy(q_seg), torch.from_numpy(kv_seg)


def _live(tq, tk, causal, off, q_rows, kv_rows):
    return fa.fwd_live_tiles(fa.tile_ranges(tq), fa.tile_ranges(tk), causal, off, tq.shape[1], tk.shape[1],
                             q_rows, kv_rows)


def _needed(mask, q_rows, kv_rows):
    """Bool (B, nQ, nK): tile pairs that hold an unmasked pair."""
    pad = (0, (-mask.shape[2]) % kv_rows, 0, (-mask.shape[1]) % q_rows)
    return torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(mask.float(), pad)[:, None], (q_rows, kv_rows))[:, 0] > 0


@pytest.mark.parametrize("rows", TILE_SIZES, ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("kind", FORWARD_LAYOUTS)
def test_fwd_live_tiles_keep_every_unmasked_pair(kind, rows):
    rng = np.random.default_rng(200 + FORWARD_LAYOUTS.index(kind))
    q_seg, kv_seg, causal, off = _forward_layout(kind, rng)
    tq, tk = _tensors(q_seg, kv_seg)
    mask = fa.make_attention_mask(tq, tk, causal, off)
    live = _live(tq, tk, causal, off, *rows)
    assert live.shape == (tq.shape[0], -(-tq.shape[1] // rows[0]), -(-tk.shape[1] // rows[1]))
    assert mask.any()
    assert not (_needed(mask, *rows) & ~live).any(), "an unmasked pair lies in a skipped tile pair"


@pytest.mark.parametrize("rows", TILE_SIZES, ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("kind", CONTIGUOUS)
def test_fwd_live_tiles_are_minimal_on_contiguous_layouts(kind, rows):
    """Ascending contiguous segments, q the tail of kv: a pair of tiles runs
    iff it holds an unmasked pair."""
    rng = np.random.default_rng(200 + FORWARD_LAYOUTS.index(kind))
    q_seg, kv_seg, causal, off = _forward_layout(kind, rng)
    tq, tk = _tensors(q_seg, kv_seg)
    mask = fa.make_attention_mask(tq, tk, causal, off)
    assert torch.equal(_live(tq, tk, causal, off, *rows), _needed(mask, *rows))


@pytest.mark.parametrize("kind", LAYOUTS)
def test_fwd_rule_at_the_backward_tiles_is_the_backward_rule(kind):
    """At RANGE_TILE x RANGE_TILE, offset 0 and Sq = Skv the forward's causal
    rule (kv_start <= last q row) is the backward's (kv tile <= q tile)."""
    rng = np.random.default_rng(300 + LAYOUTS.index(kind))
    q_seg, kv_seg, causal = _layout(kind, rng)
    tq, tk = _tensors(q_seg, kv_seg)
    want = fa.live_tile_pairs(fa.tile_ranges(tq), fa.tile_ranges(tk), causal)
    assert torch.equal(_live(tq, tk, causal, 0, fa.RANGE_TILE, fa.RANGE_TILE), want)


def test_fwd_live_tiles_refuse_tables_that_do_not_fit():
    seg = torch.ones((1, 100), dtype=torch.int32)
    rng_ = fa.tile_ranges(seg)
    with pytest.raises(ValueError, match="multiples"):
        fa.fwd_live_tiles(rng_, rng_, False, 0, 100, 100, q_rows=48)
    with pytest.raises(ValueError, match="do not fit"):
        fa.fwd_live_tiles(rng_, rng_, False, 0, 100, 200)


def tile_walking_forward(q, k, v, q_seg, kv_seg, *, causal, scale, causal_offset=0,
                         q_rows=fa.FWD_Q_ROWS, kv_rows=fa.FWD_KV_ROWS):
    """The forward kernel's algorithm in fp32 tensor ops: per q tile, online
    softmax over only its live kv tiles in ascending order, scores scaled by
    scale * log2(e) and exponentiated with exp2, masked cells selected to
    p = 0, P cast to v's dtype for the PV product, lse = m ln 2 + ln l.
    Returns (o, lse, the tile pairs walked)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    live = _live(q_seg, kv_seg, causal, causal_offset, q_rows, kv_rows)
    mask = fa.make_attention_mask(q_seg, kv_seg, causal, causal_offset)
    c = scale * float(np.log2(np.e))
    o = torch.zeros((b, sq, hq, d), dtype=torch.float32)
    lse = torch.full((b, hq, sq), fa.NEG_INF, dtype=torch.float32)
    for bi in range(b):
        for qt in range(live.shape[1]):
            rows = slice(qt * q_rows, min((qt + 1) * q_rows, sq))
            qb = q[bi, rows].float().reshape(-1, hkv, g, d)                     # (r, Hkv, G, D)
            n = qb.shape[0]
            m = torch.full((hkv, g, n), fa.NEG_INF)
            l = torch.zeros((hkv, g, n))
            acc = torch.zeros((hkv, g, n, d))
            for kt in torch.nonzero(live[bi, qt]).flatten().tolist():           # ascending
                cols = slice(kt * kv_rows, min((kt + 1) * kv_rows, skv))
                s = torch.einsum("rhgd,chd->hgrc", qb, k[bi, cols].float()) * c
                mk = mask[bi, rows, cols]
                s = torch.where(mk, s, torch.tensor(fa.NEG_INF))
                mn = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - mn)
                p = torch.where(mk, torch.exp2(s - mn[..., None]), torch.tensor(0.0))
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("hgrc,chd->hgrd", p.to(v.dtype).float(),
                                                           v[bi, cols].float())
                m = mn
            safe = torch.where(l == 0, torch.ones_like(l), l)
            o[bi, rows] = (acc / safe[..., None]).permute(2, 0, 1, 3).reshape(n, hq, d)
            lse[bi, :, rows] = torch.where(l == 0, torch.tensor(fa.NEG_INF), m * float(np.log(2)) + torch.log(safe)
                                           ).reshape(hq, n)
    return o.to(q.dtype), lse, live


WALK_CASES = [
    # kind, hq, hkv, d: the kernel's head dims; G = 2 and G = 1
    ("contiguous_packing", 4, 2, 80),
    ("non_monotone_ids", 2, 2, 80),
    ("cross_lengths", 4, 2, 128),
    ("causal_offset_chunk", 4, 2, 128),
    ("ragged_offset", 4, 2, 128),
    ("short_kv", 2, 1, 80),
    ("padding_row", 2, 2, 80),
]


@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_tile_walking_forward_matches_plain_and_jax(case):
    kind, hq, hkv, d = case
    rng = np.random.default_rng(400 + FORWARD_LAYOUTS.index(kind))
    q_seg, kv_seg, causal, off = _forward_layout(kind, rng)
    (b, sq), skv = q_seg.shape, kv_seg.shape[1]
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    scale = d**-0.5
    tq, tk = _tensors(q_seg, kv_seg)
    tensors = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse, live = tile_walking_forward(*tensors, tq, tk, causal=causal, scale=scale, causal_offset=off)
    ref_o, ref_lse = fa.flash_fwd_plain(*tensors, tq, tk, causal=causal, scale=scale, causal_offset=off)
    np.testing.assert_allclose(o.numpy(), ref_o.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), **TOL)
    # the JAX package's Pallas forward in interpret mode, one block per (batch, kv head)
    jax_o, jax_lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_seg),
                                jnp.asarray(kv_seg), causal, scale, sq, skv, off)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse), **TOL)
    # rows with an empty tile list (or no live cell): o = 0, lse = -1e30, exactly
    dead = (q_seg == 0)
    assert np.all(o.numpy()[dead] == 0.0)
    assert np.all(lse.numpy().transpose(0, 2, 1)[dead] == fa.NEG_INF)
    if kind == "padding_row":
        assert not live[1].any()  # the padding row walks no tile at all
    if kind in ("contiguous_packing", "non_monotone_ids", "cross_lengths", "padding_row"):
        assert not live.all()     # the skip is exercised


def _vision_pack(n_images):
    """``n_images`` images of 34 x 46 patches (1,920 slots each in the
    uniform-window layout) as ``pack_vision_batch`` packs them."""
    vc = qwen25_vl_3b().vision
    grids = [np.array([[1, 34, 46]])] * n_images
    vis = pack_vision_batch([np.zeros((34 * 46, 1), np.float32)] * n_images, grids, vc)
    return torch.from_numpy(vis.seg_full.astype(np.int32))[None]


@pytest.mark.parametrize("n_images, slots, limit", [
    (8, 16384, 0.12),     # the update's vision pack (4 packed rows)
    (16, 32768, 1 / 8),   # a log-prob piece: the 16 images of 16 samples
])
def test_fwd_live_share_at_the_vision_packs(n_images, slots, limit):
    seg = _vision_pack(n_images)
    assert seg.shape[1] == slots and int(seg.max()) == n_images
    rng_ = fa.tile_ranges(seg)
    live = fa.fwd_live_tiles(rng_, rng_, False, 0, slots, slots)
    share = live.float().mean().item()
    assert share < limit, share
    # the tile pairs that share a nonzero id (non-causal: exactly those holding an unmasked pair),
    # from per-tile id presence rather than the (S, S) mask
    ids = torch.nn.functional.one_hot(seg[0].long(), n_images + 1)[:, 1:].float()
    present = ids.reshape(-1, fa.FWD_Q_ROWS, n_images).amax(1)
    needed = (present @ present.T) > 0
    assert torch.equal(live[0], needed)
