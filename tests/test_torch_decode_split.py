"""The split of the dense decode kernel #4 in its bf16 and int8-scale modes
(``spatialthinker_torch/ops/decode_attention.py`` ``decode_plan`` and the
``decode_split_kernel`` of ``csrc/decode_attention.cu``), held on the CPU.

- The plan, decoded as the kernel decodes its grid (rank, row, kv head), its
  producer's tile walk and its four consumer warps' rows, covers every tile
  of every (row, kv head) stripe exactly once across the ranks and every
  cell of the width exactly once across the warps, and walks exactly the
  tiles that hold a valid cell, at ``path_a``, ``shipped_dense``,
  ``dense_int8`` and ``continuous_int8`` on the H100's 132 SMs, at G 7, 8 and
  16 and widths 1, 63, 64, 65, 200, 640 and 8,192. The plan splits only where
  the pairs leave CTA slots idle (the CTAs the SMs' shared memory holds at
  once: the measured rule) and refuses what the kernel cannot run.
- The constants the plan and the CUDA source share agree, read from the
  source text.
- A plain emulation of the split (each rank's live tiles, each warp's 16
  rows of a tile with its own running max and bf16 weights -- p in bf16
  mode, p * v_scale in int8 mode -- the warps combined in warp order, then the
  ranks in rank order) reaches ``decode_attention_plain`` within the card's
  limits (``OUT_ATOL`` 3e-2 bf16, ``DECODE_QUANT_ATOL`` 1e-2 int8) and JAX's
  ``_pallas_decode`` in interpret mode within 2e-2 at the widths it takes
  (multiples of 128; 200 against the plain version only; the tolerance of
  ``tests/test_torch_decode_attention.py`` / ``test_torch_decode_quant.py``),
  and gives exact zeros on a row with no valid cell. A warp's weights are
  rounded to bf16 against its own running max, the plain version's against
  the global max: the rounding points move, not the function.
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
OUT_ATOL = 3e-2           # chip_smoke.py's bf16 decode limit
DECODE_QUANT_ATOL = 1e-2  # chip_smoke.py's quantized decode limit


# ---- the plan, decoded as the kernel decodes it ----

def walked(plan, seg_row, s):
    """(tiles each rank owns, live tiles each rank walks in order, cells each
    (tile, warp) covers) for one (row, kv head) stripe, as
    ``decode_split_kernel``'s producer and consumer warps walk them."""
    n_tiles = -(-s // da.SPLIT_TILE)
    owned, live = [], []
    for rank in range(plan.cluster):
        mine = list(range(rank, n_tiles, plan.cluster))
        owned += mine
        live.append([t for t in mine if seg_row[t * da.SPLIT_TILE:(t + 1) * da.SPLIT_TILE].any()])
    rows = da.SPLIT_TILE // da.SPLIT_CONSUMERS
    cells = [t * da.SPLIT_TILE + w * rows + r for t in range(n_tiles) for w in range(da.SPLIT_CONSUMERS)
             for r in range(rows) if t * da.SPLIT_TILE + w * rows + r < s]
    return sorted(owned), live, sorted(cells)


def _seg(rng, b, s, kind="ragged"):
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        lo = int(rng.integers(0, max(1, s // 3)))
        hi = int(rng.integers(lo, s + 1))
        seg[i, lo:hi] = 1
    if kind == "ragged" and s > 8:
        seg[:, s // 2: s // 2 + 5] = 0  # a hole
    seg[-1] = 0  # a row with no valid cell
    return seg


SHAPES = {  # rows, width, mode: the shapes ``time_decode.py`` times
    "path_a": (20, 640, da.MODE_BF16),
    "shipped_dense": (64, 8192, da.MODE_BF16),
    "dense_int8": (128, 640, da.MODE_INT8),
    "continuous_int8": (72, 640, da.MODE_INT8),
}


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 640, 8192])
@pytest.mark.parametrize("g", [7, 8, 16])
@pytest.mark.parametrize("mode", [da.MODE_BF16, da.MODE_INT8], ids=["bf16", "int8"])
def test_plan_covers_every_tile_and_cell_once(mode, g, s):
    rng = np.random.default_rng(s + g)
    for b in (1, 3, 20):
        seg = _seg(rng, b, s)
        plan = da.decode_plan(b, 2, g, s, mode, sms=H100_SMS)
        n_tiles = -(-s // da.SPLIT_TILE)
        assert 1 <= plan.cluster <= min(da.SPLIT_MAX_CLUSTER, n_tiles)
        assert plan.smem == da.split_smem(mode, g, plan.stages) <= da.KERNEL_MAX_SMEM
        for row in range(b):
            owned, live, cells = walked(plan, seg[row], s)
            assert owned == list(range(n_tiles))  # every tile once across the ranks
            assert cells == list(range(s))        # every cell once across a tile's warps
            walk = sorted(t for rank in live for t in rank)
            assert walk == [t for t in range(n_tiles) if seg[row, t * 64:(t + 1) * 64].any()]
            assert all(r == sorted(r) for r in live)
        assert walked(plan, seg[-1], s)[1] == [[]] * plan.cluster  # the empty row walks no tile


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_at_the_timed_shapes(shape):
    """The CTA slots filled at every shape (two bf16 CTAs an SM, three int8):
    path (a)'s 40 (row, kv head) pairs take 6 ranks (240 CTAs of 264 slots),
    the shipped revert's 128 pairs 2 (256), ``dense_int8``'s 256 pairs one,
    ``continuous_int8``'s 144 pairs 2 (288 of 396); one rank more would
    overfill the slots."""
    b, s, mode = SHAPES[shape]
    plan = da.decode_plan(b, 2, 8, s, mode, sms=H100_SMS)
    slots = da.cta_slots(mode, 8, H100_SMS)
    assert slots == H100_SMS * (2 if mode == da.MODE_BF16 else 3)
    assert plan.ctas == plan.cluster * b * 2 and (plan.ctas <= slots or plan.cluster == 1)
    assert plan.ctas + 2 * b > slots
    assert 2 <= plan.stages <= da.ring_fit(mode, 8) and plan.smem <= da.SMEM_BUDGET_TWO
    rng = np.random.default_rng(len(shape))
    seg = _seg(rng, b, s)
    for row in range(b):
        owned, live, cells = walked(plan, seg[row], s)
        assert owned == list(range(-(-s // 64))) and cells == list(range(s))
    assert {"path_a": 6, "shipped_dense": 2, "dense_int8": 1, "continuous_int8": 2}[shape] == plan.cluster


@pytest.mark.parametrize("b,s,cluster", [(1, 640, 8), (3, 640, 8), (8, 640, 8), (9, 640, 8), (17, 640, 7),
                                         (20, 640, 6), (33, 8192, 4), (66, 8192, 2), (132, 8192, 1),
                                         (1, 200, 4), (2, 64, 1)])
def test_plan_splits_where_pairs_leave_cta_slots_idle(b, s, cluster):
    """The rule takes as many ranks as the idle CTA slots allow (264 in
    bf16), up to 8 and up to the stripe's tiles; a device of fewer SMs takes
    fewer ranks."""
    plan = da.decode_plan(b, 2, 8, s, da.MODE_BF16, sms=H100_SMS)
    assert plan.cluster == cluster and plan.ctas <= max(da.cta_slots(da.MODE_BF16, 8, H100_SMS), 2 * b)
    assert da.decode_plan(b, 2, 8, s, da.MODE_INT8, sms=b).cluster == 1  # 3 b slots for 2 b pairs


def test_plan_refuses_what_the_kernel_cannot_run():
    # mode 7 does not exist; an int4 width of 640 is one block of 320 byte rows, more than the int8-dot
    # mode takes; an odd width has no packed rows (the int4 plans: tests/test_torch_decode_split_int4.py)
    for mode, s in ((7, 640), (da.MODE_INT4_I8, 640), (da.MODE_INT4, 641)):
        with pytest.raises(ValueError):
            da.decode_plan(4, 2, 8, s, mode, sms=H100_SMS)
    for args in ((4, 2, 17, 640), (4, 2, 0, 640), (0, 2, 8, 640), (4, 0, 8, 640), (4, 2, 8, 0)):
        with pytest.raises(ValueError):
            da.decode_plan(*args, da.MODE_BF16, sms=H100_SMS)
    for bad in (dict(cluster=0), dict(cluster=9), dict(stages=0), dict(stages=5)):
        with pytest.raises(ValueError):
            da.decode_plan(4, 2, 8, 640, da.MODE_BF16, sms=H100_SMS, **bad)
    # the deepest bf16 ring at G = 16 still fits a block; no plan of the rule needs more
    assert da.split_smem(da.MODE_BF16, 16, 4) <= da.KERNEL_MAX_SMEM


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TILE") == da.SPLIT_TILE
    assert const("TILE") // const("WARP_ROWS") == da.SPLIT_CONSUMERS
    assert "constexpr int CONSUMERS = TILE / WARP_ROWS;" in src
    assert const("SPLIT_MAX_CLUSTER") == da.SPLIT_MAX_CLUSTER
    assert const("SPLIT_MAX_STAGES") == da.SPLIT_MAX_STAGES
    assert "constexpr int BOX_BYTES = TILE * 128;" in src and da.SPLIT_BOX_BYTES == da.SPLIT_TILE * 128
    assert "constexpr int PART_STRIDE = QD + 4;" in src and da.SPLIT_PART_STRIDE == D + 4
    assert const("MAX_SMEM") == da.KERNEL_MAX_SMEM
    assert const("QD") == D and const("GMAX") == da.KERNEL_MAX_GROUP
    layout = re.search(r"inline SplitLayout split_layout\(.*?\n}", src, re.S).group(0)
    for term in ("round_up((mode == MODE_BF16 ? 4 : 2) * BOX_BYTES + 2 * TILE * 2, 1024)",
                 "(CONSUMERS + 1) * g16 * PART_STRIDE * 4", "stages * 16",
                 "(3 * CONSUMERS + 2 + SPLIT_MAX_CLUSTER + 1) * g16 * 4", "round_up(off, 8)",
                 "2 * stages * 8 + 1024"):
        assert term in layout, term
    refused = re.search(r"int split_smem\(int mode.*?\n}", src, re.S).group(0)
    assert "n_split > SPLIT_MAX_CLUSTER" in refused and "stages > SPLIT_MAX_STAGES" in refused


# ---- the split's arithmetic, emulated ----

def split_emulation(q, k_cache, v_cache, kv_seg, layer, scale, k_scale, v_scale, plan):
    """The kernel's function in fp32 tensor ops: worker (rank, warp) takes
    rows 16 w .. 16 w + 15 of the rank's tiles that hold a valid cell, with
    its own (m, l, acc); scores = bf16 q . bf16 k (int8 k exact in bf16) times
    scale (int8: times k_scale * scale); weights p (int8: p * v_scale) rounded
    to bf16 for p . v, l from the unrounded p; workers combined in warp order,
    then ranks in rank order."""
    b, hq, d = q.shape
    k, v = k_cache[layer].float(), v_cache[layer].float()  # (B, Hkv, S, D)
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    valid = kv_seg != 0
    n_tiles = -(-s // da.SPLIT_TILE)
    rows = da.SPLIT_TILE // da.SPLIT_CONSUMERS
    neg = da.NEG_INF

    def combine(states):
        m = torch.stack([st[0] for st in states])            # (W, B, Hkv, G)
        big = m.amax(dim=0)
        w = torch.exp(m - big)
        l = sum(st[1] * w[i] for i, st in enumerate(states))
        acc = sum(st[2] * w[i][..., None] for i, st in enumerate(states))
        return big, l, acc

    ranks = []
    for rank in range(plan.cluster):
        workers = []
        for warp in range(da.SPLIT_CONSUMERS):
            m = torch.full((b, hkv, g), neg)
            l = torch.zeros((b, hkv, g))
            acc = torch.zeros((b, hkv, g, d))
            for t in range(rank, n_tiles, plan.cluster):
                lo = t * da.SPLIT_TILE + warp * rows
                hi = min(lo + rows, s)
                if lo >= s:
                    continue
                live_tile = valid[:, t * da.SPLIT_TILE:(t + 1) * da.SPLIT_TILE].any(dim=1)  # (B,)
                vv = valid[:, lo:hi] & live_tile[:, None]
                sc = torch.einsum("bhgd,bhsd->bhgs", qg, k[:, :, lo:hi])
                if k_scale is None:
                    sc = sc * scale
                else:
                    sc = sc * (k_scale[layer][:, :, lo:hi].float() * scale)[:, :, None, :]
                sc = torch.where(vv[:, None, None, :], sc, torch.full_like(sc, neg))
                m_new = torch.maximum(m, sc.amax(dim=-1))
                p = torch.where(vv[:, None, None, :], torch.exp(sc - m_new[..., None]), torch.zeros_like(sc))
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                if v_scale is not None:
                    p = p * v_scale[layer][:, :, lo:hi].float()[:, :, None, :]
                pv = torch.einsum("bhgs,bhsd->bhgd", p.to(torch.bfloat16).float(), v[:, :, lo:hi])
                acc = acc * corr[..., None] + pv
                m = m_new
            workers.append((m, l, acc))
        ranks.append(combine(workers))
    _, l, acc = combine(ranks)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / safe[..., None]).reshape(b, hq, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _bf16_case(hq, hkv, s, seed, b=3, n_layers=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, D)).astype(np.float32)
    k = rng.normal(size=(n_layers, b, hkv, s, D)).astype(np.float32)
    v = rng.normal(size=(n_layers, b, hkv, s, D)).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    seg[:, s - s // 4:] = 0       # unwritten decode tail
    seg[0, : s // 3] = 0           # left padding
    seg[1, s // 2: s // 2 + 7] = 0  # a hole
    seg[2] = 0                     # a row with no valid cell
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jx = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    return (bf(q), bf(k), bf(v), torch.from_numpy(seg)), (jx(q), jx(k), jx(v), jnp.asarray(seg))


@functools.lru_cache(maxsize=None)
def _int8_case(hq, hkv, s, seed, b=3, n_layers=2):
    """Quantized by the JAX package's own function, as test_torch_decode_quant.py does."""
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(2, n_layers, b, hkv, s, D)).astype(np.float32)
    q = jnp.asarray(rng.normal(size=(b, hq, D)).astype(np.float32), jnp.bfloat16)
    seg = (rng.random((b, s)) < 0.7).astype(np.int32)
    seg[:, s - s // 8:] = 0
    seg[0, : s // 4] = 0
    seg[:, s // 4] = 1
    seg[2] = 0
    kq, ks = jt._quantize_kv(jnp.asarray(kv[0]))
    vq, vs = jt._quantize_kv(jnp.asarray(kv[1]))

    def t(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.asarray(a).copy())

    return (t(q), t(kq), t(vq), torch.from_numpy(seg), t(ks), t(vs)), (q, kq, vq, jnp.asarray(seg), ks, vs)


@functools.lru_cache(maxsize=None)
def _pallas_ref(kind, hq, hkv, s, layer):
    """JAX's ``_pallas_decode`` in interpret mode on the case's inputs (once
    per case: the emulation's cluster sizes share it)."""
    if kind == "bf16":
        _, (q, k, v, seg) = _bf16_case(hq, hkv, s, seed=s + hq)
        out = _pallas_decode(q, k, v, seg, jnp.int32(layer), None, None, D**-0.5, 64)
    else:
        _, (q, k, v, seg, ks, vs) = _int8_case(hq, hkv, s, seed=s + hq)
        out = _pallas_decode(q, k, v, seg, jnp.asarray(layer, jnp.int32), ks, vs, D**-0.5, _pick_block(s))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("hq,hkv", [(16, 2), (14, 2), (32, 2)], ids=["G8", "G7", "G16"])
@pytest.mark.parametrize("s", [200, 256, 640])
def test_bf16_split_emulation_matches_plain_and_pallas(s, hq, hkv, cluster):
    (q, k, v, seg), _ = _bf16_case(hq, hkv, s, seed=s + hq)
    layer = 1
    plan = da.decode_plan(q.shape[0], hkv, hq // hkv, s, da.MODE_BF16, sms=H100_SMS, cluster=cluster)
    got = split_emulation(q, k, v, seg, layer, D**-0.5, None, None, plan)
    plain = da.decode_attention_plain(q, k, v, seg, layer, D**-0.5)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=OUT_ATOL, rtol=0)
    if s % 128 == 0:  # a width the TPU kernel takes (cache buckets are multiples of 128)
        np.testing.assert_allclose(got.float().numpy(), _pallas_ref("bf16", hq, hkv, s, layer), atol=2e-2,
                                   rtol=2e-2)
    assert torch.all(got[2] == 0) and got[0].abs().max() > 0


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("hq,hkv", [(16, 2), (14, 2), (32, 2)], ids=["G8", "G7", "G16"])
@pytest.mark.parametrize("s", [200, 256, 640])
def test_int8_split_emulation_matches_plain_and_pallas(s, hq, hkv, cluster):
    (q, k, v, seg, ks, vs), _ = _int8_case(hq, hkv, s, seed=s + hq)
    layer = 1
    plan = da.decode_plan(q.shape[0], hkv, hq // hkv, s, da.MODE_INT8, sms=H100_SMS, cluster=cluster)
    got = split_emulation(q, k, v, seg, layer, D**-0.5, ks, vs, plan)
    plain = da.decode_attention_plain(q, k, v, seg, layer, D**-0.5, ks, vs)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=DECODE_QUANT_ATOL, rtol=0)
    if s % 128 == 0:
        np.testing.assert_allclose(got.float().numpy(), _pallas_ref("int8", hq, hkv, s, layer), atol=2e-2,
                                   rtol=2e-2)
    assert torch.all(got[2] == 0) and got[0].abs().max() > 0


def test_emulation_is_a_function_of_the_split():
    """The split moves the bf16 rounding points (a warp's weights against its
    own running max), so the emulation at 1 and 8 ranks differs from the plain
    version in the last bits -- and by no more than the limits above."""
    (q, k, v, seg), _ = _bf16_case(16, 2, 640, seed=3)
    outs = [split_emulation(q, k, v, seg, 0, D**-0.5, None, None,
                            da.decode_plan(3, 2, 8, 640, da.MODE_BF16, sms=H100_SMS, cluster=c)) for c in (1, 8)]
    plain = da.decode_attention_plain(q, k, v, seg, 0, D**-0.5)
    diffs = [(o.float() - plain.float()).abs().max().item() for o in outs]
    assert max(diffs) > 0 and max(diffs) <= OUT_ATOL
