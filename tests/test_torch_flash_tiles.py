"""The flash backward's pre-pass and tile skip, in their plain versions.

The CUDA dQ and dK/dV kernels run a (q tile, kv tile) pair only when the
ranges of nonzero segment ids of the two tiles intersect (and, when causal,
the kv tile is not above the diagonal). These tests hold that rule to
``make_attention_mask`` on seeded layouts: no unmasked pair may fall in a
skipped tile pair. The pre-pass's delta is held to the eager expression
the wrapper used before and to the JAX package's own (``_flash_bwd``).
All exact: integer ranges, and the same fp32 expression on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_torch.models.qwen2_5_vl.config import qwen25_vl_3b
from spatialthinker_torch.models.qwen2_5_vl.host import pad_vision_inputs, prepare_vision_aux
from spatialthinker_torch.ops import flash_attention as fa

T = fa.RANGE_TILE


def _layout(kind, rng):
    """(q_seg, kv_seg, causal) of one seeded layout."""
    if kind == "contiguous_packing":
        seg = np.zeros((3, 500), np.int32)
        for row in seg:
            cuts = np.sort(rng.choice(np.arange(20, 480), size=3, replace=False))
            start = 0
            for i, end in enumerate(list(cuts) + [int(rng.integers(480, 501))]):
                row[start:end] = i + 1
                start = end
        return seg, seg, True
    if kind == "left_padding":
        seg = np.ones((4, 300), np.int32)
        for i, row in enumerate(seg):
            row[: int(rng.integers(0, 280))] = 0
        return seg, seg, False
    if kind == "non_monotone_ids":
        seg = np.zeros((2, 400), np.int32)
        seg[:, :90], seg[:, 90:230], seg[:, 230:390] = 1, 2, 1
        seg[1, 300:330] = 3
        return seg, seg, False
    if kind == "dead_rows":
        seg = np.ones((3, 256), np.int32)
        seg[0] = 0
        seg[2, 100:] = 2
        seg[2, 170:] = 0
        return seg, seg, True
    if kind == "cross_lengths":
        kv_seg = np.repeat(np.arange(1, 8, dtype=np.int32), 50)[None].repeat(2, 0)
        q_seg = np.ascontiguousarray(kv_seg[:, ::3][:, :117])
        q_seg[1, :40] = 0
        return q_seg, kv_seg, False
    if kind == "random_ids_causal":
        seg = rng.integers(0, 4, size=(2, 333)).astype(np.int32)
        return seg, seg, True
    raise ValueError(kind)


LAYOUTS = ["contiguous_packing", "left_padding", "non_monotone_ids", "dead_rows", "cross_lengths",
           "random_ids_causal"]


def _ranges_by_loop(seg):
    b, s = seg.shape
    out = np.zeros((b, -(-s // T), 2), np.int64)
    for i in range(b):
        for t in range(out.shape[1]):
            ids = seg[i, t * T : (t + 1) * T]
            ids = ids[ids != 0]
            out[i, t] = (ids.min(), ids.max()) if ids.size else (fa.INT32_MAX, fa.INT32_MIN)
    return out


def _live_elements(q_seg, kv_seg, causal):
    live = fa.live_tile_pairs(fa.tile_ranges(q_seg), fa.tile_ranges(kv_seg), causal)
    live = live.repeat_interleave(T, dim=1).repeat_interleave(T, dim=2)
    return live[:, : q_seg.shape[1], : kv_seg.shape[1]]


@pytest.mark.parametrize("kind", LAYOUTS)
def test_prep_plain_matches_eager_delta_and_jax(kind):
    rng = np.random.default_rng(LAYOUTS.index(kind))
    q_seg, kv_seg, _ = _layout(kind, rng)
    b, sq = q_seg.shape
    do = rng.normal(size=(b, sq, 4, 80)).astype(np.float32)
    o = rng.normal(size=(b, sq, 4, 80)).astype(np.float32)
    t_do, t_o = (torch.from_numpy(x).to(torch.bfloat16) for x in (do, o))
    delta, q_rng, kv_rng = fa.flash_bwd_prep_plain(t_do, t_o, torch.from_numpy(q_seg),
                                                   torch.from_numpy(kv_seg))
    eager = (t_do.float() * t_o.float()).sum(-1).transpose(1, 2).contiguous()
    assert delta.dtype == torch.float32 and delta.is_contiguous()
    torch.testing.assert_close(delta, eager, atol=0, rtol=0)
    jdo, jo = (jnp.asarray(x.float().numpy()) for x in (t_do, t_o))
    jax_delta = np.asarray(jnp.sum(jdo * jo, axis=-1).transpose(0, 2, 1))
    np.testing.assert_allclose(delta.numpy(), jax_delta, rtol=1e-5, atol=1e-5)
    for seg, got in ((q_seg, q_rng), (kv_seg, kv_rng)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), _ranges_by_loop(seg))


@pytest.mark.parametrize("kind", LAYOUTS)
def test_live_tile_pairs_keep_every_unmasked_pair(kind):
    rng = np.random.default_rng(100 + LAYOUTS.index(kind))
    q_seg, kv_seg, causal = _layout(kind, rng)
    tq, tk = torch.from_numpy(q_seg), torch.from_numpy(kv_seg)
    mask = fa.make_attention_mask(tq, tk, causal)
    live = _live_elements(tq, tk, causal)
    assert mask.any()
    assert not (mask & ~live).any(), "an unmasked pair lies in a skipped tile pair"
    if kind in ("contiguous_packing", "left_padding", "dead_rows"):
        # contiguous ascending segments: a pair of tiles runs iff it holds an unmasked pair
        tiles_needed = torch.nn.functional.max_pool2d(
            torch.nn.functional.pad(mask.float(), (0, (-mask.shape[2]) % T, 0, (-mask.shape[1]) % T))[:, None],
            T)[:, 0] > 0
        ranges_live = fa.live_tile_pairs(fa.tile_ranges(tq), fa.tile_ranges(tk), causal)
        assert torch.equal(ranges_live, tiles_needed)


def test_dead_tiles_meet_nothing_and_dead_rows_are_skipped_whole():
    seg = torch.zeros((1, 3 * T), dtype=torch.int32)
    seg[0, T : 2 * T] = 5
    rng_ = fa.tile_ranges(seg)
    assert rng_[0, 0].tolist() == [fa.INT32_MAX, fa.INT32_MIN]
    assert rng_[0, 1].tolist() == [5, 5]
    live = fa.live_tile_pairs(rng_, rng_, causal=False)
    assert live[0].tolist() == [[False, False, False], [False, True, False], [False, False, False]]
    neg = torch.tensor([[-3, 0, 4] + [0] * (T - 3)], dtype=torch.int32)  # any nonzero id is live
    assert fa.tile_ranges(neg)[0, 0].tolist() == [-3, 4]


def _update_vision_pack():
    """The update's vision pack: 8 images of 34 x 46 patches (1,564 each) in
    the uniform-window layout, padded to 16,384 patch slots."""
    vc = qwen25_vl_3b().vision
    aux = prepare_vision_aux([(1, 34, 46)] * 8, vc)
    patches = np.zeros((aux.num_patches, 1), np.float32)
    _, _, seg_full, _, _ = pad_vision_inputs(patches, aux, 16384, vc.spatial_merge_unit)
    return torch.from_numpy(seg_full.astype(np.int32))[None]


def test_update_vision_layout_live_tile_share_under_ten_percent():
    seg = _update_vision_pack()
    assert int((seg != 0).sum()) == 8 * 1564
    mask = fa.make_attention_mask(seg, seg, causal=False)
    pair_share = mask.float().mean().item()
    live = fa.live_tile_pairs(fa.tile_ranges(seg), fa.tile_ranges(seg), causal=False)
    tile_share = live.float().mean().item()
    assert 0.072 < pair_share < 0.074  # 8 * 1564^2 / 16384^2
    assert tile_share < 0.10, tile_share
    assert not (mask & ~_live_elements(seg, seg, False)).any()


@pytest.mark.parametrize("shape, want", [
    ((4, 1024, 2, 8), (4, 2)),     # update text rows: 128 CTAs -> four splits of two heads
    ((1, 16384, 16, 1), (1, 1)),   # vision full attention: 4,096 CTAs, G = 1
    ((256, 64, 16, 1), (1, 1)),    # vision windows
    ((1, 4096, 2, 7), (4, 2)),     # G = 7: the last split holds one head
    ((1, 128, 1, 16), (16, 1)),    # G = 16, two kv tiles: one head per split
])
def test_dkv_head_splits(shape, want):
    n_split, per = fa.dkv_splits(*shape, n_sms=132)
    assert (n_split, per) == want
    g = shape[3]
    assert (n_split - 1) * per < g <= n_split * per  # every split holds at least one head
