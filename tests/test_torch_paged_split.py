"""The split of the paged int4 kernel with int8 dots (#9,
``spatialthinker_torch/ops/paged_attention.py`` ``paged_plan`` and the
``paged_kernel_int4_i8`` of ``csrc/paged_attention.cu``), held on the CPU.

- The plan, decoded as the kernel decodes its grid (rank, slot, kv head) and
  its warps' blocks, covers every page of every slot exactly once across the
  ranks, every cell of a page exactly once across the warps (and the parts
  of a page of more than 1,024 cells), and the staging ring exactly once (the
  last rank), at path (b)'s and the shipped shapes, at G 7, 8 and 16, pages
  6, 130, 256, 1024, 2048, 2050 and 4096, lengths 0, 1, a page, a page + 1
  and longer; on the H100's 132 SMs the plan fills the SMs at path (b)'s and
  the shipped shapes with one CTA an SM or more, and splits a slot's pages
  where the pairs leave SMs idle; it refuses what the kernel cannot run.
- The constants the plan and the CUDA source share agree, read from the
  source text.
- A plain emulation of the split (each rank's pages through the plain
  version's per-page arithmetic with its own running max, the ring on the
  last rank, then the rank-order combine) reaches the sequential plain
  version within the card's tolerances (m, l 2e-3, o 1e-2) at every cluster
  size, and JAX's ``_paged_kernel_int4_i8`` in interpret mode, with and
  without ``staged=``, within ``tests/test_torch_paged_attention.py``'s int8-dot
  tolerances (m, l 1e-5, o 2e-3): a rank's weights are relative to its own
  running max, which the per-page int8 weights p / pscale do not see, so only
  the exp rounding moves.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops.paged_attention import _pallas_paged
from spatialthinker_torch.ops import paged_attention as pa

torch.set_num_threads(2)
H100_SMS = 132  # what ``device_sms`` reads on the H100 SXM
SOURCE = Path(pa.__file__).resolve().parents[1] / "csrc" / "paged_attention.cu"


# ---- the plan, decoded as the kernel decodes it ----

def covered(plan, lengths, page, p_max, ring):
    """(pages each slot's ranks walk, cells each page's warps cover, the ring's
    takers per slot) as ``paged_kernel_int4_i8`` walks them."""
    half = page // 2
    nblk = -(-half // pa.SPLIT_ROWS)
    pages, rings = [[] for _ in lengths], [0] * len(lengths)
    for rank in range(plan.cluster):
        for slot, ell in enumerate(lengths):
            npg = min(-(-ell // page), p_max)
            mine = -(-(npg - rank) // plan.cluster) if npg > rank else 0
            pages[slot] += [rank + i * plan.cluster for i in range(mine)]
            rings[slot] += int(ring > 0 and rank == plan.cluster - 1)
    cells, part_rows = [], plan.warps * plan.blocks_per_warp * pa.SPLIT_ROWS
    for part in range(plan.parts):
        row0 = part * part_rows
        for warp in range(plan.warps):
            for ib in range(plan.blocks_per_warp):
                b = warp + ib * plan.warps
                if row0 // pa.SPLIT_ROWS + b >= nblk:
                    break
                first = row0 + b * pa.SPLIT_ROWS
                for row in range(first, min(half, first + pa.SPLIT_ROWS)):
                    cells += [row, half + row]
    return pages, sorted(cells), rings


LENGTH_SETS = {
    "edges": lambda page: [0, 1, page, page + 1, 3 * page + 5],
    "one_slot_empty": lambda page: [0],
    "long": lambda page: [9 * page - 1, 2 * page, 1],
}


@pytest.mark.parametrize("ring", [0, 16])
@pytest.mark.parametrize("lengths", list(LENGTH_SETS))
@pytest.mark.parametrize("page", [6, 130, 256, 1024, 2048, 2050, 4096])
@pytest.mark.parametrize("g", [7, 8, 16])
def test_plan_covers_every_page_cell_and_ring_once(g, page, lengths, ring):
    lengths = LENGTH_SETS[lengths](page)
    p_max = max(-(-ell // page) for ell in lengths) + 1
    plan = pa.paged_plan(len(lengths), 2, g, page, p_max, ring, sms=H100_SMS)
    assert (plan.parts > 1) == (page > 1024) and (plan.parts == 1 or plan.stages == 1)
    pages, cells, rings = covered(plan, lengths, page, p_max, ring)
    for slot, ell in enumerate(lengths):
        assert sorted(pages[slot]) == list(range(-(-ell // page)))
    assert cells == list(range(page))
    assert rings == [int(ring > 0)] * len(lengths)
    assert plan.smem == pa.split_smem(g, page, ring, plan.warps, plan.blocks_per_warp, plan.stages)
    assert plan.smem <= pa.KERNEL_MAX_SMEM


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("shape", ["path_b", "shipped"])
def test_plan_covers_the_main_path_shapes(shape, cluster):
    """Path (b)'s decode call (64 slots + the trash lane, page 256, at most 3
    pages a slot) and the shipped scale (128 + 1 lanes, page 1024, prompt
    6,144 + response 2,048), under the rule's plan and other cluster sizes."""
    rng = np.random.default_rng(cluster)
    if shape == "path_b":
        lanes, page, p_max = 65, 256, 4
        lengths = list(rng.integers(422, 560, size=lanes - 1)) + [0]
    else:
        lanes, page, p_max = 129, 1024, 9
        lengths = list(rng.integers(6144, 8193, size=lanes - 1)) + [0]
    rule = pa.paged_plan(lanes, 2, 8, page, p_max, 16, sms=H100_SMS)
    # the SMs are filled (130 CTAs of 132 SMs at path (b), 258 at the shipped scale), and one more rank a
    # slot would give an SM a second CTA and its fixed cost
    assert rule.ctas >= 0.95 * H100_SMS and rule.ctas + 2 * lanes > H100_SMS
    plan = pa.paged_plan(lanes, 2, 8, page, p_max, 16, sms=H100_SMS, cluster=cluster)
    pages, cells, rings = covered(plan, lengths, page, p_max, 16)
    assert [sorted(p) for p in pages] == [list(range(-(-int(ell) // page))) for ell in lengths]
    assert cells == list(range(page)) and rings == [1] * lanes


@pytest.mark.parametrize("lanes,page,p_max,cluster", [(17, 256, 4, 3), (9, 1024, 9, 7), (1, 256, 4, 4),
                                                      (33, 256, 4, 2), (66, 256, 4, 1)])
def test_plan_splits_where_pairs_leave_sms_idle(lanes, page, p_max, cluster):
    """Small decode batches (16 lanes + the trash lane at path (b)'s page,
    one group of 8 + the trash lane at the shipped scale, one lane): the
    rule takes as many ranks as the idle SMs allow, up to the table's
    pages; at 66 lanes one rank; a device of fewer SMs takes fewer ranks."""
    plan = pa.paged_plan(lanes, 2, 8, page, p_max, 16, sms=H100_SMS)
    assert plan.cluster == cluster and plan.ctas <= max(H100_SMS, 2 * lanes)
    assert pa.paged_plan(lanes, 2, 8, page, p_max, 16, sms=2 * lanes).cluster == 1


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="parts"):
        pa.paged_plan(4, 2, 8, 2048, 3, sms=H100_SMS, stages=2)
    for bad in (dict(cluster=0), dict(cluster=9), dict(warps=0), dict(warps=9), dict(warps=1, stages=2),
                dict(stages=0), dict(stages=5)):
        with pytest.raises(ValueError):
            pa.paged_plan(65, 2, 8, 256, 4, sms=H100_SMS, **bad)
    for args in ((65, 2, 17, 256, 4), (65, 2, 8, 255, 4), (0, 2, 8, 256, 4), (65, 2, 8, 256, 0)):
        with pytest.raises(ValueError):
            pa.paged_plan(*args, sms=H100_SMS)
    with pytest.raises(ValueError, match="shared memory"):
        pa.paged_plan(65, 2, 16, 1024, 9, 16, sms=H100_SMS, stages=2)
    with pytest.raises(ValueError, match="shared memory"):  # the page's scale vectors alone outgrow a block
        pa.paged_plan(4, 2, 16, 65536, 2, sms=H100_SMS)


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("SPLIT_ROWS") == pa.SPLIT_ROWS
    assert const("SPLIT_MAX_CLUSTER") == pa.SPLIT_MAX_CLUSTER
    assert const("SPLIT_MAX_WARPS") == pa.SPLIT_MAX_WARPS
    assert const("SPLIT_MAX_STAGES") == pa.SPLIT_MAX_STAGES
    assert const("MAX_SMEM") == pa.KERNEL_MAX_SMEM
    assert const("D") == pa.KERNEL_HEAD_DIM and const("GMAX") == pa.KERNEL_MAX_GROUP
    built = {(int(nt), int(b), parts == "true")
             for nt, b, parts in re.findall(r"SPLIT_LAUNCH\((\d), (\d), (true|false)\)", src)}
    assert built == {(nt, b, False) for nt in (1, 2) for b in pa.SPLIT_BLOCKS} | {(1, 4, True), (2, 4, True)}
    refused = re.search(r"int split_smem\(.*?\n}", src, re.S).group(0)
    assert "p.bpw == 1 || p.bpw == 2 || p.bpw == 4" in refused
    assert "split_parts(page, p) && (p.bpw != 4 || p.stages != 1)" in refused
    assert "return p.warps * p.bpw < (page / 2 + SPLIT_ROWS - 1) / SPLIT_ROWS;" in src
    # the layout's terms, in the order split_smem adds them
    layout = re.search(r"inline SplitLayout split_layout\(.*?\n}", src, re.S).group(0)
    assert "L.kbytes = (rows < cover ? rows : cover) * D;" in layout
    for term in ("stages * L.kslot", "stages * L.kbytes", "2 * C * D", "(warps + 1) * g16 * D * 4 * 33 / 32",
                 "g16 * D;", "g16 * (D + 4) * 4 : 0", "warps * bpw * g16 * 32", "2 * warps * g16 * 4", "4 * g16 * 4",
                 "round_up(C * 4 * (3 + g16), 16)", "(2 * stages + 1) * 8"):
        assert term in layout, term


# ---- the split's arithmetic, emulated ----

def _rank_state(q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale, scale, cols):
    """(m, l, acc) of one rank over its page columns ``cols``, with the plain
    version's per-page arithmetic (``paged_attention_int4_i8_plain``)."""
    s_slots, hq, d = q.shape
    hkv, half = k_pool.shape[2], k_pool.shape[3]
    page, g = 2 * half, hq // hkv
    qf = q.reshape(s_slots, hkv, g, d).float()
    qscale = torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q_i8 = torch.round(qf / qscale)
    sumq = q_i8.sum(dim=-1, keepdim=True)
    m = torch.full((s_slots, hkv, g), pa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((s_slots, hkv, g, d))
    cell = torch.arange(page)
    for pi in cols:
        ids = table[:, pi].to(torch.int64)
        s = torch.einsum("shgd,shcd->shgc", q_i8, pa._page_nibbles(k_pool[layer][ids]))
        s = (s - pa.KV4_BIAS * sumq) * qscale * (k_scale[layer][ids].float() * scale)[:, :, None, :]
        valid = ((pi * page + cell)[None, :] < lengths.to(torch.int64)[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, pa.NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        p = p * v_scale[layer][ids].float()[:, :, None, :]
        pscale = torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-20) * (1.0 / 127.0)
        p_i8 = torch.round(p / pscale)
        pv = torch.einsum("shgc,shcd->shgd", p_i8, pa._page_nibbles(v_pool[layer][ids]))
        acc = acc * corr[..., None] + (pv - pa.KV4_BIAS * p_i8.sum(dim=-1, keepdim=True)) * pscale
        m = m_new
    return m, l, acc


def split_emulation(q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale, scale, staged, cluster):
    """The split kernel's order in plain torch: rank r takes page columns r,
    r + cluster, ...; the last rank also the staged block; then m = max m_r,
    w_r = exp(m_r - m), l = sum l_r w_r, o = sum acc_r w_r / l."""
    states = []
    for rank in range(cluster):
        cols = range(rank, table.shape[1], cluster)
        m, l, acc = _rank_state(q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale, scale, cols)
        if staged is not None and rank == cluster - 1:
            m, l, acc = pa._staged_update(q, m, l, acc, staged, layer, scale)
        states.append((m, l, acc))
    m = torch.stack([s[0] for s in states]).amax(dim=0)
    l, acc = torch.zeros_like(m), 0.0
    for m_r, l_r, acc_r in states:
        w = torch.exp(m_r - m)
        l, acc = l + l_r * w, acc + acc_r * w[..., None]
    safe = torch.where(l == 0, torch.ones_like(l), l)
    s_slots, hq, d = q.shape
    return (acc / safe[..., None]).reshape(s_slots, hq, d).to(q.dtype), m.reshape(s_slots, hq), l.reshape(s_slots, hq)


def _case(rng, page=256, g=8, hkv=2, lengths=(600, 256, 37, 0, 511, 1), n_layers=2, d=128):
    """Seeded int4 pools (packed, +8 biased), bf16 scales and bf16-exact q;
    each slot's pages scattered over the pool, unused table entries page 0."""
    s_slots = len(lengths)
    n_pages = sum(-(-ell // page) for ell in lengths) + 2
    shape = (n_layers, n_pages, hkv, page, d)
    vals = [rng.integers(-7, 8, size=shape).astype(np.int8) for _ in range(2)]
    half = page // 2
    k, v = (((a[:, :, :, :half] + 8).astype(np.uint8) & 0xF) | ((a[:, :, :, half:] + 8).astype(np.uint8) << 4)
            for a in vals)
    scales = [np.asarray(jnp.asarray(rng.uniform(0.01, 0.1, size=shape[:-1]), jnp.bfloat16), np.float32)
              for _ in range(2)]
    q = np.asarray(jnp.asarray(rng.normal(size=(s_slots, hkv * g, d)), jnp.bfloat16), np.float32)
    table = np.zeros((s_slots, max(-(-ell // page) for ell in lengths) + 1), np.int32)
    order = iter(rng.permutation(np.arange(1, n_pages)))
    for i, ell in enumerate(lengths):
        for c in range(-(-ell // page)):
            table[i, c] = next(order)
    return q, k, v, scales, table, np.asarray(lengths, np.int32)


def _ring(rng, n_layers, s_slots, hkv, c, d=128):
    """A staging ring (int4 values as int8 cells, bf16 scales), about half the
    cells live, slot 0 with none; as (torch, JAX) tuples."""
    shape = (n_layers, s_slots, hkv, c, d)
    k, v = (rng.integers(-7, 8, size=shape).astype(np.int8) for _ in range(2))
    ks, vs = (np.asarray(jnp.asarray(rng.uniform(0.01, 0.1, size=shape[:-1]), jnp.bfloat16), np.float32)
              for _ in range(2))
    seg = (rng.random((s_slots, c)) < 0.5).astype(np.int32)
    seg[0] = 0
    t = (torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ks).to(torch.bfloat16),
         torch.from_numpy(vs).to(torch.bfloat16), torch.from_numpy(seg))
    j = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16),
         jnp.asarray(seg))
    return t, j


def _torch_args(q, k, v, scales, table, lengths):
    return (torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(table), torch.from_numpy(lengths), 1,
            *(torch.from_numpy(s).to(torch.bfloat16) for s in scales))


def _np(x):
    return [a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32) for a in x]


@pytest.mark.parametrize("ring", [0, 16])
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("page,g", [(256, 8), (6, 7), (130, 16)])
def test_split_emulation_matches_the_plain_version(page, g, cluster, ring):
    """Every cluster size, a cluster wider than a slot's pages, the ring on
    the last rank: the card's tolerances."""
    rng = np.random.default_rng(page + g + cluster + ring)
    lengths = (3 * page + 7, page, 1, 0, 2 * page - 1, page + 1)
    args = _torch_args(*_case(rng, page=page, g=g, lengths=lengths))
    staged = _ring(rng, 2, len(lengths), 2, ring)[0] if ring else None
    o_ref, m_ref, l_ref = pa.paged_attention_int4_i8_plain(*args, 128**-0.5, staged)
    o, m, l = split_emulation(*args, 128**-0.5, staged, cluster)
    torch.testing.assert_close(m, m_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(l, l_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=1e-2)
    if staged is None or not staged[4][3].any():  # slot 3 has no cell at all
        assert torch.all(o[3] == 0) and torch.all(l[3] == 0) and torch.all(m[3] == pa.NEG_INF)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("cluster", [2, 3])
def test_split_emulation_matches_the_pallas_kernel(cluster, staged):
    """Against ``_paged_kernel_int4_i8`` in interpret mode (through
    ``_pallas_paged``, as ``tests/test_torch_paged_attention.py`` runs it),
    with and without the staged block: that file's int8-dot tolerances."""
    rng = np.random.default_rng(50 + cluster + staged)
    lengths = (600, 256, 37, 0, 511)
    case = _case(rng, page=256, g=8, lengths=lengths)
    args = _torch_args(*case)
    ring_t, ring_j = _ring(rng, 2, len(lengths), 2, 16) if staged else (None, None)
    o, m, l = _np(split_emulation(*args, 128**-0.5, ring_t, cluster))
    q, k, v, scales, table, lens = case
    o_k, m_k, l_k = _np(_pallas_paged(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(1, jnp.int32), *(jnp.asarray(s, jnp.bfloat16) for s in scales), 128**-0.5,
        int4_i8dot=True, staged=ring_j))
    np.testing.assert_allclose(m, m_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o, o_k, rtol=0, atol=2e-3)
    if not staged or not ring_t[4][3].any():  # slot 3 has no cell at all
        assert np.all(o[3] == 0) and np.all(l[3] == 0)
