"""The port's own copies of the training path's host packers
(``data/text_packing.py``, and ``stack_vision_packs`` / ``empty_vision_pack``
/ ``patch_dim`` of ``data/packing.py``) give arrays equal to the JAX
package's originals. Host code on numpy: equality is exact.
"""

import numpy as np
import pytest

from spatialthinker_tpu.data import packing as jpk
from spatialthinker_tpu.data import text_packing as jtp
from spatialthinker_torch.data import packing as tpk
from spatialthinker_torch.data import text_packing as ttp
from tests.test_torch_parity import CFG, JAX_CFG


def _samples(seed, b=7, p=12, r=9):
    rng = np.random.default_rng(seed)
    plen = rng.integers(2, p + 1, size=b)
    rlen = rng.integers(1, r + 1, size=b)
    seg = (np.arange(p)[None, :] >= (p - plen)[:, None]).astype(np.int32)
    ids = (rng.integers(5, 500, size=(b, p)) * seg).astype(np.int32)
    pos = np.tile((np.cumsum(seg, -1) - 1).clip(0)[:, None, :], (1, 3, 1)).astype(np.int64)
    resp = rng.integers(5, 500, size=(b, r)).astype(np.int32)
    mask = (np.arange(r)[None, :] < rlen[:, None]).astype(np.int32)
    per_token = {k: rng.normal(size=(b, r)).astype(np.float32)
                 for k in ("old_log_probs", "ref_log_probs", "advantages")}
    return ids, seg, pos, resp, mask, plen.astype(np.int64), per_token


@pytest.mark.parametrize("seed,row_len", [(0, 24), (1, 32), (2, 64)])
def test_pack_train_rows_and_gather_equal_the_originals(seed, row_len):
    ids, seg, pos, resp, mask, gen_start, per_token = _samples(seed)
    ref, ref_map = jtp.pack_train_rows(ids, seg, pos, resp, mask, gen_start, per_token, row_len)
    got, got_map = ttp.pack_train_rows(ids, seg, pos, resp, mask, gen_start, per_token, row_len)
    for name, a, b in zip(ref._fields, ref, got):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("row", "dst_start", "prompt_len", "resp_len"):
        np.testing.assert_array_equal(getattr(ref_map, name), getattr(got_map, name))
    assert (ref_map.num_rows, ref_map.row_len) == (got_map.num_rows, got_map.row_len)
    # the scattered per-token values come back to the response layout
    back = ttp.gather_response_values(got.advantages, got_map, resp.shape[1])
    np.testing.assert_array_equal(back, per_token["advantages"] * mask)
    np.testing.assert_array_equal(
        back, jtp.gather_response_values(ref.advantages, ref_map, resp.shape[1]))
    for count in (got_map.num_rows, got_map.num_rows + 3):
        for a, b in zip(jtp.pad_rows_to_count(ref, count), ttp.pad_rows_to_count(got, count)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jtp.pad_rows_to_multiple(ref, 4), ttp.pad_rows_to_multiple(got, 4)):
        np.testing.assert_array_equal(a, b)


def test_pack_train_rows_refuses_a_sample_longer_than_a_row():
    ids, seg, pos, resp, mask, gen_start, _ = _samples(3)
    with pytest.raises(ValueError, match="exceeds row_len"):
        ttp.pack_train_rows(ids, seg, pos, resp, mask, gen_start, None, 8)


def test_stack_vision_packs_equals_the_original():
    rng = np.random.default_rng(4)
    vc, jvc = CFG.vision, JAX_CFG.vision
    dim = tpk.patch_dim(vc)
    assert dim == jpk.patch_dim(jvc)

    def pack(mod, cfg, grids):
        patches = [rng_local.normal(size=(t * h * w, dim)).astype(np.float32) for t, h, w in grids]
        return mod.pack_vision_batch(patches, [np.asarray([g]) for g in grids], cfg, granularity=64)

    packs = []
    for mod, cfg in ((jpk, jvc), (tpk, vc)):
        rng_local = np.random.default_rng(5)
        packs.append([pack(mod, cfg, [(1, 8, 12)]), None, pack(mod, cfg, [(1, 6, 6), (1, 16, 16)])])
    ref = jpk.stack_vision_packs(packs[0], jvc)
    got = tpk.stack_vision_packs(packs[1], vc)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(ref, name), getattr(got, name), err_msg=name)
    assert got.patches.shape[0] == 3 and not got.seg_full[1].any()
    assert tpk.stack_vision_packs([None, None], vc) is None
    for a, b in zip(jpk.empty_vision_pack(jvc, 64, dim)[:5], tpk.empty_vision_pack(vc, 64, dim)):
        np.testing.assert_array_equal(a, b)


def _images(seed, grids):
    """One image entry a grid list (an entry may hold several images)."""
    rng = np.random.default_rng(seed)
    dim = tpk.patch_dim(CFG.vision)
    return [(rng.normal(size=(sum(t * h * w for t, h, w in g), dim)).astype(np.float32), np.asarray(g))
            for g in grids]


ENTRIES = [[(1, 8, 12)], [(1, 6, 6), (1, 16, 16)], [(1, 4, 4)]]


@pytest.mark.parametrize("granularity,pad_to", [(64, None), (1024, None), (64, 4096)])
def test_distinct_pack_of_distinct_images_is_pack_vision_batch(granularity, pad_to):
    """No entry shown twice (one object per sample, a None between): the
    distinct pack is ``pack_vision_batch``'s, the port's and the JAX
    package's, byte for byte."""
    images = _images(6, ENTRIES)
    patches = [images[0][0], None, images[1][0], images[2][0]]
    grids = [images[0][1], None, images[1][1], images[2][1]]
    got = tpk.pack_distinct_vision_batch(patches, grids, CFG.vision, granularity, pad_to)
    for ref in (tpk.pack_vision_batch(patches, grids, CFG.vision, granularity, pad_to),
                jpk.pack_vision_batch(patches, grids, JAX_CFG.vision, granularity, pad_to)):
        for name in got._fields:
            a, b = getattr(got, name), np.asarray(getattr(ref, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert tpk.pack_distinct_vision_batch([None, None], [None, None], CFG.vision) is None


@pytest.mark.parametrize("granularity", [64, 1024])
def test_distinct_pack_holds_a_shared_entry_once(granularity):
    """Entries shown by several samples (one object, equal grids) are laid
    out once, in order of first use; ``reverse_index`` names each sample's
    merged tokens, repeats included, so the tokens it gathers are those of
    ``pack_vision_batch`` over every sample's copy; an equal copy in another
    object and the same object under another grid are entries of their own."""
    unit = CFG.vision.spatial_merge_unit
    (a, ga), (b, gb), (c, gc) = _images(7, ENTRIES)
    same_pixels = np.array(c)  # equal values, another object: not shared
    patches = [a, b, a, c, b, same_pixels, a]
    grids = [ga, gb, ga, gc, gb, gc, ga]
    got = tpk.pack_distinct_vision_batch(patches, grids, CFG.vision, granularity)
    once = tpk.pack_vision_batch([a, b, c, same_pixels], [ga, gb, gc, gc], CFG.vision, granularity)
    every = tpk.pack_vision_batch(patches, grids, CFG.vision, granularity)
    for name in ("patches", "pos_ids", "seg_full", "seg_window"):
        np.testing.assert_array_equal(getattr(got, name), getattr(once, name), err_msg=name)
    n_tokens = sum(len(p) for p in patches) // unit
    width = len(got.reverse_index)
    assert width % granularity == 0 and width >= max(n_tokens, len(got.patches) // unit)
    assert not got.reverse_index[n_tokens:].any()
    rows = lambda pack: pack.reverse_index[:n_tokens, None] * unit + np.arange(unit)  # noqa: E731
    np.testing.assert_array_equal(got.patches[rows(got)], every.patches[rows(every)])
    np.testing.assert_array_equal(got.pos_ids[rows(got)], every.pos_ids[rows(every)])
    # the same object under another grid is laid out again
    turned = tpk.pack_distinct_vision_batch([a, a], [ga, np.asarray([(1, 12, 8)])], CFG.vision, granularity)
    assert turned.seg_full.max() == 2 and tpk.held_patch_count(turned) == 2 * len(a)


def test_stack_vision_packs_pads_reverse_index_to_the_widest():
    """A distinct pack whose ``reverse_index`` is wider than its patch width
    over the merge unit, stacked with a pack of no repeats and a None: each
    ``reverse_index`` padded with zeros to the widest, the patches to the
    widest pack, the None all padding."""
    unit = CFG.vision.spatial_merge_unit
    (a, ga), (b, gb), _ = _images(8, ENTRIES)
    shared = tpk.pack_distinct_vision_batch([a] * 8, [ga] * 8, CFG.vision, 64)
    plain = tpk.pack_vision_batch([b], [gb], CFG.vision, 64)
    assert len(shared.reverse_index) > len(shared.patches) // unit
    assert len(plain.patches) > len(shared.patches)
    stacked = tpk.stack_vision_packs([shared, None, plain], CFG.vision)
    assert stacked.patches.shape == (3, len(plain.patches), a.shape[1])
    assert stacked.reverse_index.shape == (3, len(shared.reverse_index))
    for g, pack in ((0, shared), (2, plain)):
        for name in pack._fields:
            x = getattr(pack, name)
            np.testing.assert_array_equal(getattr(stacked, name)[g, :len(x)], x, err_msg=name)
            assert not getattr(stacked, name)[g, len(x):].any()
    assert not any(getattr(stacked, name)[1].any() for name in stacked._fields)
