"""The int4 modes of the dense decode kernel -- #5 (dots on the widened
nibbles) and #6 (int8 dots) -- on the split design
(``spatialthinker_torch/ops/decode_attention.py`` ``decode_plan`` and the
``decode_int4_kernel`` of ``csrc/decode_attention.cu``), held on the CPU.

- The plan, decoded as the kernel decodes its grid (rank, row, kv head), its
  producer's walk over the rank's blocks in groups of up to four tiles and its
  four consumer warps' byte rows, covers every block of every (row, kv head)
  stripe exactly once across the ranks and every byte row -- both its tokens --
  exactly once across the warps, and walks exactly the tiles that hold a
  valid cell in either half, at G 7, 8 and 16 and widths 200, 256, 512, 768,
  2,048 and 8,192 on the H100's 132 SMs; mode 3's ring holds every group it
  is sent. The plan splits only where the pairs leave CTA slots idle and
  refuses what the kernel cannot run.
- The constants the plan and the CUDA source share agree, read from the
  source text.
- A plain emulation of the split -- each rank over its whole blocks; mode 2
  each warp's 32 tokens of a tile with its own running max, bf16 weights and
  the -8 debias with the unrounded ones; mode 3 the block's scores kept, the
  warps' largest score and largest exp(s - it) * v_scale met once a block,
  the common running max, int8 weights against the block's pscale, the int
  dots debiased per tile; warps combined in warp order, then ranks in rank
  order -- at clusters 1, 2, 3 and 8 reaches ``decode_attention_plain``
  within ``DECODE_QUANT_ATOL`` (1e-2, the card's limit), JAX's
  ``_pallas_decode`` in interpret mode (both ``int4_i8dot`` settings) within
  the 2e-2 of ``tests/test_torch_decode_quant.py`` at widths 512, 768 and
  2,048 (the int4 widths the TPU kernel takes), and gives exact zeros on a
  row with no valid cell.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl import text as jt
from spatialthinker_tpu.ops.decode_attention import _pallas_decode, _pick_block
from spatialthinker_torch.ops import decode_attention as da

torch.set_num_threads(2)
H100_SMS = 132  # what ``device_sms`` reads on the H100 SXM
SOURCE = Path(da.__file__).resolve().parents[1] / "csrc" / "decode_attention.cu"
D = 128
SCALE = D**-0.5
DECODE_QUANT_ATOL = 1e-2  # chip_smoke.py's quantized decode limit
MODES = {"int4": da.MODE_INT4, "int4_i8": da.MODE_INT4_I8}


# ---- the plan, decoded as the kernel decodes it ----

def int4_walk(plan, seg_row, s):
    """(blocks each rank owns, live tiles each rank's producer sends with the
    live count of their group, token cells each (tile, warp) covers) for one
    (row, kv head) stripe, as ``decode_int4_kernel``'s producer and consumer
    warps walk them: rank r takes blocks r, r + n, ...; a block's tiles go in
    groups of ``BLOCK_TILES``, a tile with no valid cell in either half is
    skipped."""
    rows = s // 2
    n_tiles = -(-rows // da.SPLIT_TILE)
    tpb = -(-plan.block_rows // da.SPLIT_TILE)
    n_blocks = -(-n_tiles // tpb)
    owned, sent = [], []
    for rank in range(plan.cluster):
        mine = []
        for blk in range(rank, n_blocks, plan.cluster):
            owned.append(blk)
            t_end = min((blk + 1) * tpb, n_tiles)
            for g0 in range(blk * tpb, t_end, da.BLOCK_TILES):
                group = range(g0, min(g0 + da.BLOCK_TILES, t_end))
                live = [t for t in group
                        if any(seg_row[hf * rows + row] for hf in (0, 1)
                               for row in range(t * 64, min(t * 64 + 64, rows)))]
                mine += [(t, len(live)) for t in live]
        sent.append(mine)
    per_warp = da.SPLIT_TILE // da.SPLIT_CONSUMERS
    cells = [hf * rows + t * 64 + w * per_warp + r for t in range(n_tiles) for w in range(da.SPLIT_CONSUMERS)
             for r in range(per_warp) for hf in (0, 1) if t * 64 + w * per_warp + r < rows]
    return sorted(owned), sent, sorted(cells)


def _seg(rng, b, s):
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        lo = int(rng.integers(0, max(1, s // 3)))
        hi = int(rng.integers(lo, s + 1))
        seg[i, lo:hi] = 1
    seg[:, s // 4: s // 4 + 70] = 0  # a hole of more than a tile's low half
    seg[-1] = 0                      # a row with no valid cell
    return seg


@pytest.mark.parametrize("s", [200, 256, 512, 768, 2048, 8192])
@pytest.mark.parametrize("g", [7, 8, 16])
@pytest.mark.parametrize("kind", list(MODES))
def test_int4_plan_covers_every_block_and_row_once(kind, g, s):
    mode = MODES[kind]
    rng = np.random.default_rng(s + g)
    rows = s // 2
    for b in (1, 3, 20):
        seg = _seg(rng, b, s)
        plan = da.decode_plan(b, 2, g, s, mode, sms=H100_SMS)
        assert plan.block_rows == da.int4_block_rows(rows)
        n_tiles = -(-rows // 64)
        tpb = -(-plan.block_rows // 64)
        n_blocks = -(-n_tiles // tpb)
        assert 1 <= plan.cluster <= min(da.SPLIT_MAX_CLUSTER, n_blocks)
        assert plan.smem == da.split_smem(mode, g, plan.stages) <= da.KERNEL_MAX_SMEM
        if mode == da.MODE_INT4_I8:
            assert tpb <= da.BLOCK_TILES <= da.INT4_MAX_STAGES and plan.stages >= tpb
        for row in range(b):
            owned, sent, cells = int4_walk(plan, seg[row], s)
            assert owned == list(range(n_blocks))  # every block once across the ranks
            assert cells == list(range(s))         # every token once across a tile's warps
            walk = sorted(t for rank in sent for t, _ in rank)
            lo = [seg[row, t * 64:min(t * 64 + 64, rows)] for t in range(n_tiles)]
            hi = [seg[row, rows + t * 64:rows + min(t * 64 + 64, rows)] for t in range(n_tiles)]
            assert walk == [t for t in range(n_tiles) if lo[t].any() or hi[t].any()]
            assert all([t for t, _ in r] == sorted(t for t, _ in r) for r in sent)
            if mode == da.MODE_INT4_I8:  # a block's live tiles fit the ring together
                assert all(n <= plan.stages for rank in sent for _, n in rank)
        assert int4_walk(plan, seg[-1], s)[1] == [[]] * plan.cluster  # the empty row sends no tile


@pytest.mark.parametrize("kind,shape,cluster,stages,block_rows", [
    ("int4", (128, 768), 1, 4, 128), ("int4_i8", (128, 768), 1, 4, 128),  # chip_smoke.py's draw
    ("int4_i8", (136, 768), 1, 4, 128),                                   # path (g)'s lanes
    ("int4", (64, 8192), 3, 4, 256), ("int4_i8", (64, 8192), 2, 6, 256),   # the shipped int4 cache
])
def test_int4_plan_at_the_timed_shapes(kind, shape, cluster, stages, block_rows):
    """Three CTAs an SM at 4 slots (G = 8): 256-272 pairs take one rank; the
    shipped 128 pairs take three ranks in mode 2, and two in mode 3, whose
    256-row blocks want 6 slots (two CTAs an SM)."""
    b, s = shape
    mode = MODES[kind]
    plan = da.decode_plan(b, 2, 8, s, mode, sms=H100_SMS)
    assert (plan.cluster, plan.stages, plan.block_rows) == (cluster, stages, block_rows)
    tpb = block_rows // 64
    slots = da.cta_slots(mode, 8, H100_SMS, tpb)
    assert slots == H100_SMS * (2 if plan.stages > 4 else 3)
    assert plan.ctas == cluster * b * 2 and (plan.ctas <= slots or cluster == 1)
    assert plan.ctas + 2 * b > slots or cluster == -(-(s // 2) // block_rows)


def test_int4_plan_refuses_what_the_kernel_cannot_run():
    # mode 3 keeps a block's scores in registers: a single block of more than 256 rows is refused
    for s in (640, 6000):
        with pytest.raises(ValueError, match="one block"):
            da.decode_plan(2, 2, 8, s, da.MODE_INT4_I8, sms=H100_SMS)
        assert da.decode_plan(2, 2, 8, s, da.MODE_INT4, sms=H100_SMS).block_rows == s // 2
    for mode in MODES.values():
        with pytest.raises(ValueError):  # an odd token width has no packed rows
            da.decode_plan(2, 2, 8, 767, mode, sms=H100_SMS)
        with pytest.raises(ValueError):
            da.decode_plan(2, 2, 8, 768, mode, sms=H100_SMS, stages=da.INT4_MAX_STAGES + 1)
    with pytest.raises(ValueError, match="a block"):  # a ring shorter than a 256-row block
        da.decode_plan(2, 2, 8, 1024, da.MODE_INT4_I8, sms=H100_SMS, stages=3)
    # the widened-nibble mode runs any ring of 1 to 8 slots; the deepest fits a block at G = 16
    assert da.decode_plan(2, 2, 8, 1024, da.MODE_INT4, sms=H100_SMS, stages=1).stages == 1
    assert da.split_smem(da.MODE_INT4_I8, 16, da.INT4_MAX_STAGES) <= da.KERNEL_MAX_SMEM


def test_int4_constants_match_the_cuda_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BLOCK_TILES") == da.BLOCK_TILES
    assert const("INT4_MAX_STAGES") == da.INT4_MAX_STAGES
    assert const("KV4_BIAS") == da.KV4_BIAS
    assert const("QD") == da.D_KERNEL == D
    layout = re.search(r"inline SplitLayout split_layout\(.*?\n}", src, re.S).group(0)
    assert "round_up(2 * BOX_BYTES + 4 * TILE * 2, 1024)" in layout
    assert "int4 ? int4_region(g16, stages) : 0" in layout
    region = re.search(r"inline int int4_region\(.*?\n}", src, re.S).group(0)
    assert ("stages * 16 + g16 * Q8_STRIDE + 2 * g16 * 4 + 2 * CONSUMERS * g16 * 2 * 4 + CONSUMERS * g16 * 32"
            in region)
    assert "constexpr int Q8_STRIDE = QD + 16;" in src
    refused = re.search(r"int split_smem\(int mode.*?\n}", src, re.S).group(0)
    assert "stages > INT4_MAX_STAGES" in refused
    entry = re.search(r'extern "C" int st_decode_split\(.*?\n}', src, re.S).group(0)
    assert "tpb > BLOCK_TILES || stages < tpb" in entry
    assert "(block_rows % TILE != 0 && block_rows != rows)" in entry
    for gone in ("decode_quant_kernel", "st_decode_attention(", "QLayout", "load_tile"):
        assert gone not in src


# ---- the split's arithmetic, emulated ----

def _combine(states):
    """(m, l, acc) partials combined in order: M = max m, w = exp(m - M)."""
    m = torch.stack([st[0] for st in states])
    big = m.amax(dim=0)
    w = torch.exp(m - big)
    l = sum(st[1] * w[i] for i, st in enumerate(states))
    acc = sum(st[2] * w[i][..., None] for i, st in enumerate(states))
    return big, l, acc


def int4_split_emulation(q, k_cache, v_cache, kv_seg, layer, scale, k_scale, v_scale, plan, i8dot):
    """The kernel's function in fp32 tensor ops, rank by rank over its whole
    blocks, each warp over its 16 byte rows (32 tokens) of every tile:
    mode 2 (``i8dot`` False) each warp its own online softmax, weights
    p * v_scale rounded to bf16 for p . u, the -8 debias with the unrounded
    ones at the end; mode 3 the block's scores kept, the warps meeting once a
    block over (their largest score, their largest exp(s - it) * v_scale),
    from which the common running max and pscale follow, then int8 weights
    p8 = round(p * v_scale / pscale) and the int dot debiased by -8 sum(p8),
    restored by pscale, tile by tile. Warps combined in warp order, then ranks
    in rank order. A tile without a valid cell changes nothing (the producer
    skips it), so it is walked here masked."""
    b, hq, d = q.shape
    ku = torch.cat([k_cache[layer] & 15, k_cache[layer] >> 4], dim=2).float()  # (B, Hkv, S, D) stored nibbles
    vu = torch.cat([v_cache[layer] & 15, v_cache[layer] >> 4], dim=2).float()
    hkv, s = ku.shape[1], ku.shape[2]
    rows = s // 2
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    if i8dot:
        qscale = torch.clamp(qg.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        qg = torch.round(qg / qscale)
    sumq = da.KV4_BIAS * qg.sum(dim=-1)  # (B, Hkv, G)
    valid = kv_seg != 0
    kss = k_scale[layer].float() * scale  # (B, Hkv, S)
    vss = v_scale[layer].float()
    n_tiles = -(-rows // da.SPLIT_TILE)
    tpb = -(-plan.block_rows // da.SPLIT_TILE)
    n_blocks = -(-n_tiles // tpb)
    per_warp = da.SPLIT_TILE // da.SPLIT_CONSUMERS
    neg = da.NEG_INF

    def cells(t, w):  # the warp's token cells of tile t: its byte rows' low, then high tokens
        lo = [t * 64 + w * per_warp + r for r in range(per_warp) if t * 64 + w * per_warp + r < rows]
        return torch.tensor(lo + [rows + c for c in lo], dtype=torch.long)

    def scores(idx):
        sc = torch.einsum("bhgd,bhsd->bhgs", qg, ku[:, :, idx]) - sumq[..., None]
        if i8dot:
            sc = sc * qscale
        sc = sc * kss[:, :, None, idx]
        return torch.where(valid[:, None, None, idx], sc, torch.full_like(sc, neg))

    ranks = []
    for rank in range(plan.cluster):
        state = [(torch.full((b, hkv, g), neg), torch.zeros((b, hkv, g)), torch.zeros((b, hkv, g, d)))
                 for _ in range(da.SPLIT_CONSUMERS)]
        sv = [torch.zeros((b, hkv, g)) for _ in range(da.SPLIT_CONSUMERS)]
        for blk in range(rank, n_blocks, plan.cluster):
            tiles = range(blk * tpb, min((blk + 1) * tpb, n_tiles))
            if not i8dot:
                for t in tiles:
                    for w in range(da.SPLIT_CONSUMERS):
                        idx = cells(t, w)
                        if idx.numel() == 0:
                            continue
                        m, l, acc = state[w]
                        sc = scores(idx)
                        m_new = torch.maximum(m, sc.amax(dim=-1))
                        corr = torch.exp(m - m_new)
                        live = valid[:, None, None, idx]
                        p = torch.where(live, torch.exp(sc - m_new[..., None]), torch.zeros_like(sc))
                        pw = p * vss[:, :, None, idx]
                        pv = torch.einsum("bhgs,bhsd->bhgd", pw.to(torch.bfloat16).float(), vu[:, :, idx])
                        state[w] = (m_new, l * corr + p.sum(dim=-1), acc * corr[..., None] + pv)
                        sv[w] = sv[w] * corr + pw.sum(dim=-1)
                continue
            # mode 3: the block's scores, each warp's maxima, the one meeting
            blk_cells = [[idx for idx in (cells(t, w) for t in tiles) if idx.numel()]
                         for w in range(da.SPLIT_CONSUMERS)]
            blk_sc = [[scores(idx) for idx in per_t] for per_t in blk_cells]
            mw, pm = [], []
            for w in range(da.SPLIT_CONSUMERS):
                mx = torch.full((b, hkv, g), neg)
                for sc in blk_sc[w]:
                    mx = torch.maximum(mx, sc.amax(dim=-1))
                top = torch.zeros((b, hkv, g))
                for sc, idx in zip(blk_sc[w], blk_cells[w]):
                    live = valid[:, None, None, idx]
                    p = torch.where(live, torch.exp(sc - mx[..., None]) * vss[:, :, None, idx], torch.zeros_like(sc))
                    top = torch.maximum(top, p.amax(dim=-1))
                mw.append(mx)
                pm.append(top)
            big = torch.stack(mw).amax(dim=0)
            m_new = torch.maximum(state[0][0], big)  # the warps share one running max
            pmax = torch.stack([pm[w] * torch.exp(mw[w] - m_new) for w in range(da.SPLIT_CONSUMERS)]).amax(dim=0)
            pscale = torch.clamp(pmax, min=1e-20) * (1.0 / 127.0)
            for w in range(da.SPLIT_CONSUMERS):
                m, l, acc = state[w]
                corr = torch.exp(m - m_new)
                l, acc = l * corr, acc * corr[..., None]
                for sc, idx in zip(blk_sc[w], blk_cells[w]):
                    live = valid[:, None, None, idx]
                    p = torch.where(live, torch.exp(sc - m_new[..., None]), torch.zeros_like(sc))
                    l = l + p.sum(dim=-1)
                    p8 = torch.round(p * vss[:, :, None, idx] / pscale[..., None])
                    dot = torch.einsum("bhgs,bhsd->bhgd", p8, vu[:, :, idx])
                    acc = acc + (dot - da.KV4_BIAS * p8.sum(dim=-1)[..., None]) * pscale[..., None]
                state[w] = (m_new, l, acc)
        if not i8dot:
            state = [(m, l, acc - da.KV4_BIAS * sv[w][..., None]) for w, (m, l, acc) in enumerate(state)]
        ranks.append(_combine(state))
    _, l, acc = _combine(ranks)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / safe[..., None]).reshape(b, hq, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _case(hq, hkv, s, seed, b=3, n_layers=2):
    """Quantized and packed by the JAX package's own functions, as
    ``tests/test_torch_decode_quant.py`` does; ragged ``kv_seg`` (left padding,
    holes, an unwritten tail) and row 2 with no valid cell."""
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(2, n_layers, b, hkv, s, D)).astype(np.float32)
    q = jnp.asarray(rng.normal(size=(b, hq, D)).astype(np.float32), jnp.bfloat16)
    seg = (rng.random((b, s)) < 0.7).astype(np.int32)
    seg[:, s - s // 8:] = 0
    seg[0, : s // 4] = 0
    seg[:, s // 4] = 1
    seg[2] = 0
    k4, ks = jt._quantize_kv4(jnp.asarray(kv[0]))
    v4, vs = jt._quantize_kv4(jnp.asarray(kv[1]))
    half = s // 2
    kq = jt._pack_nibbles(k4[:, :, :, :half], k4[:, :, :, half:])
    vq = jt._pack_nibbles(v4[:, :, :, :half], v4[:, :, :, half:])

    def t(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.asarray(a).copy())

    return (t(q), t(kq), t(vq), torch.from_numpy(seg), t(ks), t(vs)), (q, kq, vq, jnp.asarray(seg), ks, vs)


@functools.lru_cache(maxsize=None)
def _pallas_ref(hq, hkv, s, layer, i8dot):
    """JAX's ``_pallas_decode`` in interpret mode on the case's inputs (once per
    case: the emulation's cluster sizes share it)."""
    _, (q, kq, vq, seg, ks, vs) = _case(hq, hkv, s, seed=s + hq)
    out = _pallas_decode(q, kq, vq, seg, jnp.asarray(layer, jnp.int32), ks, vs, SCALE, _pick_block(s // 2),
                         int4_i8dot=i8dot)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("hq,hkv", [(16, 2), (14, 2), (32, 2)], ids=["G8", "G7", "G16"])
@pytest.mark.parametrize("s", [200, 512, 768, 2048])
@pytest.mark.parametrize("kind", list(MODES))
def test_int4_split_emulation_matches_plain_and_pallas(kind, s, hq, hkv, cluster):
    (q, k, v, seg, ks, vs), _ = _case(hq, hkv, s, seed=s + hq)
    layer, i8 = 1, kind == "int4_i8"
    plan = da.decode_plan(q.shape[0], hkv, hq // hkv, s, MODES[kind], sms=H100_SMS, cluster=cluster)
    got = int4_split_emulation(q, k, v, seg, layer, SCALE, ks, vs, plan, i8)
    plain = da.decode_attention_plain(q, k, v, seg, layer, SCALE, ks, vs, i8)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=DECODE_QUANT_ATOL, rtol=0)
    if s % 256 == 0:  # an int4 width the TPU kernel takes
        np.testing.assert_allclose(got.float().numpy(), _pallas_ref(hq, hkv, s, layer, i8), atol=2e-2, rtol=0)
    assert torch.all(got[2] == 0) and got[0].abs().max() > 0


def test_int4_emulation_is_a_function_of_the_blocks():
    """Mode 3's weights round per block: the emulation at the rule's 128-row
    blocks and at one whole-width block disagree, and the plain version sits
    with the rule's blocks."""
    (q, k, v, seg, ks, vs), _ = _case(16, 2, 768, seed=5)
    rule = da.decode_plan(3, 2, 8, 768, da.MODE_INT4_I8, sms=H100_SMS)
    whole = da.DecodePlan(1, 4, rule.smem, 6, 256 * 3 // 2)  # one block of 384 rows (emulated only)
    got = int4_split_emulation(q, k, v, seg, 1, SCALE, ks, vs, rule, True)
    other = int4_split_emulation(q, k, v, seg, 1, SCALE, ks, vs, whole, True)
    plain = da.decode_attention_plain(q, k, v, seg, 1, SCALE, ks, vs, True)
    assert (other.float() - got.float()).abs().max() > 0
    assert (got.float() - plain.float()).abs().max() <= (other.float() - plain.float()).abs().max()
