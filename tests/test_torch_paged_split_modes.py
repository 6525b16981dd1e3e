"""The split kernel of the paged kernels #7 (bf16 and int8 pools) and #8 (int4
pools, dots on the widened nibbles): ``paged_plan(..., mode=)`` of
``spatialthinker_torch/ops/paged_attention.py`` and ``paged_kernel_split`` of
``csrc/paged_attention.cu``, held on the CPU.

- The plan, decoded as the kernel decodes its grid (rank, slot, kv head), its
  parts of a page (``warps`` blocks of 16 pool rows) and its warps' blocks,
  covers every page of every slot exactly once across the ranks, every valid
  cell of a page exactly once across the parts and warps (int4: both cells of
  a byte row), and every ring cell exactly once (the last rank), in modes 0,
  1 and 3, at pages 6, 130, 256, 1,024 and 2,050, lengths 0, 1, a page, a
  page + 1 and longer, rings of 0 and 16 cells, G 7, 8 and 16. The ring of
  slots issues every part's K rows before its wait and its V rows before
  theirs, and refills a slot only once its part is spent. At path (c)'s and
  the shipped shapes on 132 SMs the plan fits shared memory and splits where
  pairs leave SMs idle; it refuses what the kernel cannot run; its constants
  agree with the source text, from which the first design is gone.
- A plain emulation of the kernel's order (each rank's pages, the parts of a
  page, each part's online-softmax step with bf16 weights against the running
  max after it, the ring on the last rank in parts, the rank-order combine)
  reaches the plain versions within the card's tolerances (m, l 2e-3; o 3e-2
  bf16, 1e-2 int8 and int4) at cluster sizes 1, 2, 3 and 8, and JAX's
  ``_paged_kernel`` / ``_paged_kernel_int4`` in interpret mode (through
  ``_pallas_paged``), with and without ``staged=``, within the plain-vs-
  fallback envelopes of ``tests/test_torch_paged_attention.py`` (m, l 1e-5; o
  2e-3 for modes 0 and 1, 5e-3 for mode 3): a part's weights are rounded to
  bf16 against its own running max, not the page's, so only the weights'
  rounding and the exp move.
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
CSRC = Path(pa.__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "paged_attention.cu"
MODES = {"bf16": pa.MODE_BF16, "int8": pa.MODE_INT8, "int4": pa.MODE_INT4}
SCALE = 128**-0.5


def _rows(page, mode):
    return page // 2 if mode == pa.MODE_INT4 else page


# ---- the plan, decoded as the kernel decodes it ----

def units_of(plan, ell, page, p_max, rank, mode):
    """(page column, first row, live rows) of each part rank ``rank`` walks of
    a slot of length ``ell``, in order (``paged_kernel_split``'s loop)."""
    rows, part_rows = _rows(page, mode), plan.warps * pa.SPLIT_ROWS
    npg = min(-(-ell // page), p_max)
    out = []
    for col in range(rank, npg, plan.cluster):
        cells = min(page, ell - col * page)
        lr = min(rows, cells) if mode == pa.MODE_INT4 else cells
        out += [(col, row0, min(part_rows, lr - row0)) for row0 in range(0, lr, part_rows)]
    return out


def covered(plan, lengths, page, p_max, ring, mode):
    """(cells of each slot's pages, as (column, cell) pairs, the warps cover;
    ring cells of each slot, and by which ranks) as the kernel walks them."""
    half = page // 2
    cells = [[] for _ in lengths]
    rings = [[] for _ in lengths]
    for slot, ell in enumerate(lengths):
        for rank in range(plan.cluster):
            for col, row0, n in units_of(plan, ell, page, p_max, rank, mode):
                valid = min(page, ell - col * page)
                for warp in range(plan.warps):
                    for r in range(warp * pa.SPLIT_ROWS, min(n, (warp + 1) * pa.SPLIT_ROWS)):
                        row = row0 + r
                        cells[slot].append((col, row))
                        if mode == pa.MODE_INT4 and half + row < valid:
                            cells[slot].append((col, half + row))
            if ring and rank == plan.cluster - 1:
                part_rows = plan.warps * pa.SPLIT_ROWS
                for r0 in range(0, ring, part_rows):
                    for warp in range(plan.warps):
                        rings[slot] += [(rank, r0 + r) for r in range(warp * pa.SPLIT_ROWS, (warp + 1) * pa.SPLIT_ROWS)
                                        if r0 + r < ring]
    return cells, rings


LENGTH_SETS = {
    "edges": lambda page: [0, 1, page, page + 1, 3 * page + 5],
    "long": lambda page: [9 * page - 1, 2 * page, 1],
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ring", [0, 16])
@pytest.mark.parametrize("lengths", list(LENGTH_SETS))
@pytest.mark.parametrize("page", [6, 130, 256, 1024, 2050])
@pytest.mark.parametrize("g", [7, 8, 16])
def test_plan_covers_every_page_part_cell_and_ring_once(g, page, lengths, ring, mode):
    mode = MODES[mode]
    lengths = LENGTH_SETS[lengths](page)
    p_max = max(-(-ell // page) for ell in lengths) + 1
    plan = pa.paged_plan(len(lengths), 2, g, page, p_max, ring, sms=H100_SMS, mode=mode)
    blocks = -(-_rows(page, mode) // pa.SPLIT_ROWS)
    assert plan.blocks_per_warp == 1 and plan.warps == min(8, blocks) and plan.parts == -(-blocks // plan.warps)
    cells, rings = covered(plan, lengths, page, p_max, ring, mode)
    for slot, ell in enumerate(lengths):
        want = [(c, i) for c in range(-(-ell // page)) for i in range(min(page, ell - c * page))]
        assert sorted(cells[slot]) == want
        assert sorted(r for _, r in rings[slot]) == list(range(ring))
        assert {rank for rank, _ in rings[slot]} <= {plan.cluster - 1}
    assert plan.smem == pa.split_smem(g, page, ring, plan.warps, 1, plan.stages, mode) <= pa.KERNEL_MAX_SMEM


def ring_schedule(n_units, stages):
    """The kernel's slot ring for one CTA: the prologue issues parts 0 ..
    stages - 1 (K and V); part u waits for its K, meets the CTA barrier (then
    thread 0 issues K of part u + stages into u's K slot and V of part
    u - 1 + stages into u - 1's V slot), waits for its V. Asserts every wait
    finds its part issued and every refill finds its slot spent."""
    k_issued, v_issued = set(range(min(stages, n_units))), set(range(min(stages, n_units)))
    k_spent, v_spent = set(), set()
    for u in range(n_units):
        assert u in k_issued, f"part {u}'s K is waited for before it is issued"
        k_spent.add(u)  # scores done: every warp is past the barrier
        if u + stages < n_units:
            assert u in k_spent
            k_issued.add(u + stages)
        if u >= 1 and u - 1 + stages < n_units:
            assert u - 1 in v_spent
            v_issued.add(u - 1 + stages)
        assert u in v_issued, f"part {u}'s V is waited for before it is issued"
        v_spent.add(u)
    assert k_issued == v_issued == set(range(n_units))


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("n_units", [0, 1, 2, 3, 5, 16])
def test_ring_schedule_issues_before_waits_and_refills_spent_slots(n_units, stages):
    ring_schedule(n_units, stages)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("shape", ["path_c", "path_b", "shipped"])
def test_plan_covers_the_main_path_shapes(shape, cluster, mode):
    """Path (c)'s decode call (16 lanes + the trash lane, bf16 pools of page
    256), path (b)'s 65 lanes (the int8 and int4 knobs), and the shipped scale
    (128 + 1 lanes, page 1024, prompt 6,144 + response 2,048) under the rule's
    plan and other cluster sizes; the rule fits the card's shared memory and
    splits a slot's pages over 3 ranks at path (c), over one at 65 lanes and
    more."""
    mode = MODES[mode]
    rng = np.random.default_rng(cluster + mode)
    lanes, page, p_max = {"path_c": (17, 256, 4), "path_b": (65, 256, 4), "shipped": (129, 1024, 9)}[shape]
    lo, hi = (6144, 8193) if shape == "shipped" else (422, 560)
    lengths = [int(x) for x in rng.integers(lo, hi, size=lanes - 1)] + [0]
    rule = pa.paged_plan(lanes, 2, 8, page, p_max, 16, sms=H100_SMS, mode=mode)
    assert rule.cluster == (3 if shape == "path_c" else 1) and rule.smem <= pa.KERNEL_MAX_SMEM
    assert rule.ctas <= H100_SMS or rule.smem <= pa.SMEM_BUDGET_TWO  # two CTAs an SM where one wave is not enough
    plan = pa.paged_plan(lanes, 2, 8, page, p_max, 16, sms=H100_SMS, cluster=cluster, mode=mode)
    cells, rings = covered(plan, lengths, page, p_max, 16, mode)
    for slot, ell in enumerate(lengths):
        assert len(cells[slot]) == len(set(cells[slot])) == ell
        assert sorted(r for _, r in rings[slot]) == list(range(16))
    for slot, ell in enumerate(lengths):
        units = sum(len(units_of(plan, ell, page, p_max, rank, mode)) for rank in range(plan.cluster))
        assert units == sum(-(-min(_rows(page, mode), min(page, ell - c * page)) // (plan.warps * 16))
                            if mode == pa.MODE_INT4 else -(-min(page, ell - c * page) // (plan.warps * 16))
                            for c in range(-(-ell // page)))


def test_plan_refuses_what_the_kernel_cannot_run():
    for mode in MODES.values():
        for bad in (dict(cluster=0), dict(cluster=9), dict(warps=0), dict(warps=9), dict(stages=0),
                    dict(stages=5)):
            with pytest.raises(ValueError):
                pa.paged_plan(65, 2, 8, 256, 4, sms=H100_SMS, mode=mode, **bad)
        for args in ((65, 2, 17, 256, 4), (65, 2, 8, 255, 4), (0, 2, 8, 256, 4), (65, 2, 8, 256, 0)):
            with pytest.raises(ValueError):
                pa.paged_plan(*args, sms=H100_SMS, mode=mode)
    with pytest.raises(ValueError):
        pa.paged_plan(65, 2, 8, 256, 4, sms=H100_SMS, mode=7)
    with pytest.raises(ValueError, match="shared memory"):  # a bf16 ring of 512 cells outgrows a block
        pa.paged_plan(4, 2, 8, 256, 3, 512, sms=H100_SMS, mode=pa.MODE_BF16)
    with pytest.raises(ValueError, match="shared memory"):  # four bf16 slot pairs of 64 KB
        pa.paged_plan(4, 2, 8, 1024, 9, sms=H100_SMS, stages=4, mode=pa.MODE_BF16)
    # parts stream through any ring depth (mode 2 takes one slot pair)
    assert pa.paged_plan(4, 2, 8, 2048, 3, sms=H100_SMS, stages=2, mode=pa.MODE_INT4).stages == 2


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("SPLIT_ROWS") == pa.SPLIT_ROWS and const("SPLIT_MAX_WARPS") == pa.SPLIT_MAX_WARPS
    assert const("SPLIT_MAX_STAGES") == pa.SPLIT_MAX_STAGES and const("SPLIT_MAX_CLUSTER") == pa.SPLIT_MAX_CLUSTER
    assert const("MAX_SMEM") == pa.KERNEL_MAX_SMEM and const("D") == pa.KERNEL_HEAD_DIM
    assert re.search(r"MODE_BF16 = (\d), MODE_INT8 = (\d), MODE_INT4_I8 = (\d), MODE_INT4 = (\d);", src).groups() == (
        str(pa.MODE_BF16), str(pa.MODE_INT8), str(pa.MODE_INT4_I8), str(pa.MODE_INT4))
    assert "SMEM_BUDGET_TWO = 113 * 1024;" in src
    assert pa.SMEM_BUDGET_TWO == 113 * 1024
    built = set(re.findall(r"POOL_LAUNCH\((MODE_\w+), (\d), (true|false)\)", src))
    assert built == {(m, nt, two) for m in ("MODE_BF16", "MODE_INT8", "MODE_INT4")
                     for nt, two in (("1", "false"), ("1", "true"), ("2", "false"))}
    assert "const bool two = nt == 1 && smem <= SMEM_BUDGET_TWO;" in src
    refused = re.search(r"int split_smem\(int mode.*?\n}", src, re.S).group(0)
    assert ": p.bpw != 1" in refused
    layout = re.search(r"inline SplitLayout split_layout\(.*?\n}", src, re.S).group(0)
    for term in ("const int rb = mode == MODE_BF16 ? 2 * D : D;", "cover = warps * SPLIT_ROWS;",
                 "L.kbytes = cap * rb;",
                 "mode == MODE_BF16 ? 0 : mode == MODE_INT8 ? 2 * cap : page % 16 == 0 ? 4 * cap : round_up(2 * page, 16)",
                 "stages * L.kslot", "stages * L.kbytes", "2 * round_up(C, SPLIT_ROWS) * rb",
                 "(warps + 1) * g16 * D * 4 * 33 / 32", "2 * warps * g16 * 4", "2 * g16 * 4",
                 "round_up(C * 4 * 3, 16)", "(2 * stages + 1) * 8"):
        assert term in layout, term


def test_the_first_design_is_gone():
    """One kernel design in the file: the first template, its layout, tile
    loader, launcher and shared-memory entry point are deleted, and the
    library no longer binds the entry point."""
    src = SOURCE.read_text()
    for gone in ("paged_kernel<", "make_layout", "load_tile", "launch<MODE>", "st_paged_attention_smem"):
        assert gone not in src, gone
    assert "st_paged_attention_smem" not in (CSRC / "__init__.py").read_text()
    assert "return paged_kernel_split<MODE, NT, PARTS>;" in src and "return paged_kernel_int4_i8<NT, BPW, PARTS>;" in src


# ---- the split's arithmetic, emulated ----

def _step(m, l, acc, s, valid, vscale, v, debias):
    """One online-softmax step over a part's cells: s (S, Hkv, G, n) scores,
    valid (S, 1, 1, n), vscale (S, Hkv, 1, n) or None, v (S, Hkv, n, D); the
    weights times v_scale rounded to bf16 for p . v, ``debias`` the -8 sum of
    the unrounded ones (mode 3)."""
    s = torch.where(valid, s, torch.full_like(s, pa.NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    if vscale is not None:
        p = p * vscale
    pv = torch.einsum("shgc,shcd->shgd", p.to(torch.bfloat16).float(), v)
    if debias:
        pv = pv - pa.KV4_BIAS * p.sum(dim=-1, keepdim=True)
    return m_new, l, acc * corr[..., None] + pv


def _nibbles(packed):
    return torch.cat([packed & 15, packed >> 4], dim=2).float()


def split_emulation(q, k_pool, v_pool, table, lengths, layer, k_scale, v_scale, scale, staged, mode, plan):
    """``paged_kernel_split``'s order in plain torch: rank r takes page
    columns r, r + cluster, ...; each page passes in parts of ``warps`` x 16
    pool rows, one online-softmax step each; the last rank then the ring in
    parts of as many cells; then m = max m_r, w_r = exp(m_r - m), l = sum l_r
    w_r, o = sum acc_r w_r / l in rank order."""
    s_slots, hq, d = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    page = k_pool.shape[3] * (2 if mode == pa.MODE_INT4 else 1)
    half, rows, part_rows = page // 2, _rows(page, mode), plan.warps * pa.SPLIT_ROWS
    qg = q.reshape(s_slots, hkv, g, d).float()
    sumq = qg.sum(dim=-1, keepdim=True)
    lengths = lengths.to(torch.int64)
    states = []
    for rank in range(plan.cluster):
        m = torch.full((s_slots, hkv, g), pa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((s_slots, hkv, g, d))
        for col in range(rank, table.shape[1], plan.cluster):
            ids = table[:, col].to(torch.int64)
            k, v = k_pool[layer][ids], v_pool[layer][ids]  # (S, Hkv, rows, D)
            for row0 in range(0, rows, part_rows):
                r = torch.arange(row0, min(rows, row0 + part_rows))
                cell = torch.cat([r, half + r]) if mode == pa.MODE_INT4 else r
                valid = ((col * page + cell)[None, :] < lengths[:, None])[:, None, None, :]
                if mode == pa.MODE_INT4:
                    kp, vp = _nibbles(k[:, :, r]), _nibbles(v[:, :, r])
                    s = torch.einsum("shgd,shcd->shgc", qg, kp) - pa.KV4_BIAS * sumq
                else:
                    kp, vp = k[:, :, r].to(torch.bfloat16).float(), v[:, :, r].to(torch.bfloat16).float()
                    s = torch.einsum("shgd,shcd->shgc", qg, kp)
                if mode == pa.MODE_BF16:
                    s, vs = s * scale, None
                else:
                    s = s * (k_scale[layer][ids][:, :, cell].float() * scale)[:, :, None, :]
                    vs = v_scale[layer][ids][:, :, cell].float()[:, :, None, :]
                m, l, acc = _step(m, l, acc, s, valid, vs, vp, mode == pa.MODE_INT4)
        if staged is not None and rank == plan.cluster - 1:
            st_k, st_v, st_ks, st_vs, seg = staged
            c = st_k.shape[3]
            qb = qg.to(torch.bfloat16).float()
            for r0 in range(0, c, part_rows):
                r = torch.arange(r0, min(c, r0 + part_rows))
                kr = st_k[layer][:, :, r].to(torch.bfloat16).float()
                vr = st_v[layer][:, :, r].to(torch.bfloat16).float()
                s = torch.einsum("shgd,shcd->shgc", qb, kr)
                if st_ks is None:
                    s, vs = s * scale, None
                else:
                    s = s * (st_ks[layer][:, :, r].float() * scale)[:, :, None, :]
                    vs = st_vs[layer][:, :, r].float()[:, :, None, :]
                m, l, acc = _step(m, l, acc, s, (seg[:, r] != 0)[:, None, None, :], vs, vr, False)
        states.append((m, l, acc))
    m = torch.stack([st[0] for st in states]).amax(dim=0)
    l, acc = torch.zeros_like(m), 0.0
    for m_r, l_r, acc_r in states:
        w = torch.exp(m_r - m)
        l, acc = l + l_r * w, acc + acc_r * w[..., None]
    safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / safe[..., None]).reshape(s_slots, hq, d).to(q.dtype), m.reshape(s_slots, hq), l.reshape(s_slots, hq)


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _case(rng, kind, page=256, g=8, hkv=2, lengths=(600, 256, 37, 0, 511, 1), n_layers=2, d=128):
    """Seeded pools of ``kind`` (bf16-exact bf16 values; int8 in [-127, 127]
    with scales in [0.001, 0.02]; int4 packed, +8 biased, scales in [0.01,
    0.1]), bf16-exact q; each slot's pages scattered over the pool, unused
    table entries page 0. Numpy arrays: q, k, v, (k_scale, v_scale), table,
    lengths."""
    s_slots = len(lengths)
    n_pages = sum(-(-ell // page) for ell in lengths) + 2
    shape = (n_layers, n_pages, hkv, page, d)
    scales = (None, None)
    if kind == "bf16":
        k, v = (_bf16_exact(rng.normal(size=shape)) for _ in range(2))
    else:
        lim, lo, hi = (127, 0.001, 0.02) if kind == "int8" else (7, 0.01, 0.1)
        k, v = (rng.integers(-lim, lim + 1, size=shape).astype(np.int8) for _ in range(2))
        scales = tuple(_bf16_exact(rng.uniform(lo, hi, size=shape[:-1])) for _ in range(2))
        if kind == "int4":
            half = page // 2
            k, v = ((((a[:, :, :, :half] + 8).astype(np.uint8) & 0xF)
                     | ((a[:, :, :, half:] + 8).astype(np.uint8) << 4)).astype(np.uint8) for a in (k, v))
    q = _bf16_exact(rng.normal(size=(s_slots, hkv * g, d)))
    table = np.zeros((s_slots, max(-(-ell // page) for ell in lengths) + 1), np.int32)
    order = iter(rng.permutation(np.arange(1, n_pages)))
    for i, ell in enumerate(lengths):
        for c in range(-(-ell // page)):
            table[i, c] = next(order)
    return q, k, v, scales, table, np.asarray(lengths, np.int32)


def _ring(rng, kind, n_layers, s_slots, hkv, c, d=128):
    """A staging ring (bf16 cells under bf16 pools, int8 cells with bf16
    scales otherwise), about half the cells live, slot 0 with none and the
    last slot with some; as (torch, JAX) tuples."""
    shape = (n_layers, s_slots, hkv, c, d)
    if kind == "bf16":
        k, v = (_bf16_exact(rng.normal(size=shape)) for _ in range(2))
        scales = (None, None)
    else:
        lim, lo, hi = (127, 0.001, 0.02) if kind == "int8" else (7, 0.01, 0.1)
        k, v = (rng.integers(-lim, lim + 1, size=shape).astype(np.int8) for _ in range(2))
        scales = tuple(_bf16_exact(rng.uniform(lo, hi, size=shape[:-1])) for _ in range(2))
    seg = (rng.random((s_slots, c)) < 0.5).astype(np.int32)
    seg[0] = 0
    seg[-1, :2] = 1
    kv_t = torch.bfloat16 if kind == "bf16" else torch.int8
    t = (torch.from_numpy(k).to(kv_t), torch.from_numpy(v).to(kv_t),
         *(None if a is None else torch.from_numpy(a).to(torch.bfloat16) for a in scales), torch.from_numpy(seg))
    j = (jnp.asarray(k, jnp.bfloat16) if kind == "bf16" else jnp.asarray(k),
         jnp.asarray(v, jnp.bfloat16) if kind == "bf16" else jnp.asarray(v),
         *(None if a is None else jnp.asarray(a, jnp.bfloat16) for a in scales), jnp.asarray(seg))
    return t, j


def _torch_args(q, k, v, scales, table, lengths, kind, qdtype=torch.bfloat16):
    kv = (torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16)) if kind == "bf16" else (
        torch.from_numpy(k), torch.from_numpy(v))
    return (torch.from_numpy(q).to(qdtype), *kv, torch.from_numpy(table), torch.from_numpy(lengths), 1,
            *(None if s is None else torch.from_numpy(s).to(torch.bfloat16) for s in scales))


def _np(x):
    return [a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32) for a in x]


PLAIN = {"bf16": pa.paged_attention_plain, "int8": pa.paged_attention_plain, "int4": pa.paged_attention_int4_plain}
CARD_O_TOL = {"bf16": 3e-2, "int8": 1e-2, "int4": 1e-2}   # chip_smoke.py's PAGED_OUT_ATOL
PALLAS_O_TOL = {"bf16": 2e-3, "int8": 2e-3, "int4": 5e-3}  # the plain-vs-fallback envelopes


@pytest.mark.parametrize("kind", list(MODES))
@pytest.mark.parametrize("ring", [0, 16])
@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("page,g,warps", [(256, 8, None), (130, 16, None), (256, 7, 2)])
def test_split_emulation_matches_the_plain_version(kind, ring, cluster, page, g, warps):
    """Every cluster size, a cluster wider than a slot's pages, pages in 1,
    2, 5 or 8 parts, the ring on the last rank: the card's tolerances."""
    mode = MODES[kind]
    rng = np.random.default_rng(page + g + cluster + ring + mode)
    lengths = (3 * page + 7, page, 1, 0, 2 * page - 1, page + 1)
    args = _torch_args(*_case(rng, kind, page=page, g=g, lengths=lengths), kind)
    staged = _ring(rng, kind, 2, len(lengths), 2, ring)[0] if ring else None
    plan = pa.paged_plan(len(lengths), 2, g, page, args[3].shape[1], ring, sms=H100_SMS, cluster=cluster,
                         warps=warps, mode=mode)
    o_ref, m_ref, l_ref = PLAIN[kind](*args, SCALE, staged)
    o, m, l = split_emulation(*args, SCALE, staged, mode, plan)
    torch.testing.assert_close(m, m_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(l, l_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=CARD_O_TOL[kind], rtol=CARD_O_TOL[kind])
    if staged is None:  # slot 3 has no cell at all
        assert torch.all(o[3] == 0) and torch.all(l[3] == 0) and torch.all(m[3] == pa.NEG_INF)


@pytest.mark.parametrize("kind", list(MODES))
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("cluster", [1, 3])
def test_split_emulation_matches_the_pallas_kernel(kind, staged, cluster):
    """Against ``_paged_kernel`` (bf16 and int8 pools) and
    ``_paged_kernel_int4`` (int4 pools, ``int4_i8dot=False``) in interpret
    mode, through ``_pallas_paged`` as ``tests/test_torch_paged_attention.py``
    runs them, with and without the staged block, under the rule's plan of
    path (b)'s page and 1 or 3 ranks: m, l within 1e-5, o within 2e-3 (bf16,
    int8) or 5e-3 (int4). As that file holds them: bf16 and int8 pools with
    fp32 queries holding bf16-exact values (the same scores as the kernel's
    bf16 q, an fp32 output), int4 pools with bf16 queries."""
    mode = MODES[kind]
    rng = np.random.default_rng(60 + 2 * mode + staged + cluster)
    lengths = (600, 256, 37, 0, 511)
    case = _case(rng, kind, page=256, g=8, lengths=lengths)
    qdtype, jq = (torch.bfloat16, jnp.bfloat16) if kind == "int4" else (torch.float32, jnp.float32)
    args = _torch_args(*case, kind, qdtype)
    ring_t, ring_j = _ring(rng, kind, 2, len(lengths), 2, 16) if staged else (None, None)
    plan = pa.paged_plan(len(lengths), 2, 8, 256, args[3].shape[1], 16 if staged else 0, sms=H100_SMS,
                         cluster=cluster, mode=mode)
    o, m, l = _np(split_emulation(*args, SCALE, ring_t, mode, plan))
    q, k, v, scales, table, lens = case
    kv = (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)) if kind == "bf16" else (jnp.asarray(k),
                                                                                             jnp.asarray(v))
    kw = dict(int4_i8dot=False) if kind == "int4" else {}
    o_k, m_k, l_k = _np(_pallas_paged(
        jnp.asarray(q, jq), *kv, jnp.asarray(table), jnp.asarray(lens), jnp.asarray(1, jnp.int32),
        *(None if s is None else jnp.asarray(s, jnp.bfloat16) for s in scales), SCALE, staged=ring_j, **kw))
    np.testing.assert_allclose(m, m_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o, o_k, rtol=0, atol=PALLAS_O_TOL[kind])
    if not staged:  # slot 3 has no cell at all
        assert np.all(o[3] == 0) and np.all(l[3] == 0)
