"""The int4 MLP kernels' plan (``spatialthinker_torch/ops/int4_mlp.py``
``w4_plan``, the one source of truth for how ``csrc/int4_mlp.cu`` cuts a
call), held without a card.

- Coverage: the plan decoded as the kernel decodes its grid (row tile, n8
  block of wgmma's N and fragment column; column block, warp and fragment
  row; cluster rank, ring stage, half, k32 step and the thread's bytes) covers
  every row, every output column of every matrix and every group exactly
  once, at the 3B shapes on 132 SMs, groups 32 / 64 / 128, m from 2 to 512.
- Refusals: shapes and plans the kernel cannot run raise.
- Constants: those the plan shares with ``csrc/int4_mlp.cu`` agree with the
  source text.
- Summation order: a plain emulation of the kernel's order (each rank's
  groups stage by stage, the low half's before the high half's, each group's
  exact int32 dot times its scale added in fp32; the ranks in rank order;
  times xs) equals ``w4_matmul_plain`` within 1e-5 of the largest fp32
  output (only the order of fp32 sums differs) and ``w4_gateup_silu_plain``
  within one bf16 step, and JAX's ``w4_matmul`` / ``w4_gateup_silu`` in
  interpret mode as ``tests/test_torch_int4_mlp.py`` holds the plain
  versions (relative error <= 2e-3).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops import int4_mlp as ji
from spatialthinker_torch.ops import int4_mlp as ti

SOURCE = Path(ti.__file__).resolve().parent.parent / "csrc" / "int4_mlp.cu"
E3, I3 = 2048, 11008  # the 3B preset's widths
SMS = 132

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the grid as the kernel decodes it
# ---------------------------------------------------------------------------


def thread_bytes(tig: int, s: int) -> list:
    """The 8 packed bytes of a stage's weight row that fragment column
    ``tig`` reads for k32 step ``s``: 4 at 32 s + 4 tig (k slots 4 tig ..)
    and 4 at 32 s + 16 + 4 tig (slots 16 + 4 tig ..), wgmma's k order."""
    return [32 * s + 4 * tig + b for b in range(4)] + [32 * s + 16 + 4 * tig + b for b in range(4)]


def decode_rows(plan, m):
    """Global rows each (row tile, n8 block j of N, tig, e) stores."""
    count = np.zeros(m, np.int64)
    assert plan.tile_rows in ti.KERNEL_N
    for t in range(plan.row_tiles):
        rows = min(plan.tile_rows, m - t * plan.tile_rows)
        assert rows > 0
        for j in range(plan.tile_rows // 8):
            for tig in range(4):
                for e in range(2):
                    r = 8 * j + 2 * tig + e
                    if r < rows:
                        count[t * plan.tile_rows + r] += 1
    return count


def decode_columns(plan, n, gateup):
    """(matrix, column) each (column block, live warp, gid, sub) owns: gate_up
    gate (sub 0) and up (sub 1) column 8 w + gid, down column 16 w + gid + 8 sub."""
    nmat = 2 if gateup else 1
    cm = ti.WARP_COLS * plan.warps // nmat
    count = np.zeros((nmat, n), np.int64)
    for b in range(plan.col_blocks):
        col0 = b * cm
        for w in range(plan.warps):
            if col0 + (8 if gateup else 16) * w >= n:
                continue
            for gid in range(8):
                for sub in range(2):
                    c = 8 * w + gid if gateup else 16 * w + gid + 8 * sub  # row of its weight box
                    assert c < cm
                    count[sub if gateup else 0, col0 + c] += 1
    return count


def group_order(plan, k):
    """Per cluster rank, the groups it adds in the kernel's order, checking
    on the way that each k32 step's bytes lie in one group and that a
    stage-half's live bytes are read exactly once."""
    group, half = plan.group, k // 2
    hg, gps, spg = half // group, ti.STAGE_K // group, group // 32
    n_stages = -(-half // ti.STAGE_K)
    assert n_stages == plan.n_stages
    per, extra = divmod(n_stages, plan.ranks)
    order = []
    for q in range(plan.ranks):
        st0 = q * per + min(q, extra)
        stages = range(st0, st0 + per + (q < extra))
        assert stages == plan.rank_stages(q)
        groups = []
        for st in stages:
            steps = min(ti.STAGE_K, half - st * ti.STAGE_K) // 32
            seen = np.zeros(ti.STAGE_K, np.int64)
            for s in range(steps):
                for tig in range(4):
                    for b in thread_bytes(tig, s):
                        seen[b] += 1
                        assert b // group == s // spg  # step s lies in group s // spg of the stage
            assert (seen[: 32 * steps] == 1).all() and (seen[32 * steps:] == 0).all()
            for h in range(2):
                groups += [h * hg + st * gps + s // spg for s in range(0, steps, spg)]
        order.append(groups)
    return order


PLAN_SHAPES = [(gateup, m, group) for gateup in (True, False) for group in (32, 64, 128)
               for m in (2, 8, 136, 144, 146, 256, 512)]


@pytest.mark.parametrize("gateup,m,group", PLAN_SHAPES)
def test_plan_covers_every_row_column_and_group_once(gateup, m, group):
    k, n = (E3, I3) if gateup else (I3, E3)
    plan = ti.w4_plan(m, k, n, gateup, SMS, group)
    assert (decode_rows(plan, m) == 1).all()
    assert (decode_columns(plan, n, gateup) == 1).all()
    order = group_order(plan, k)
    visits = np.bincount(np.concatenate([np.asarray(g, np.int64) for g in order]), minlength=k // group)
    assert (visits == 1).all()
    assert plan.ctas == plan.ranks * plan.col_blocks * plan.row_tiles
    assert plan.smem_bytes <= ti.SMEM_LIMIT and plan.warps in ti.WARPS
    staged = ti.staged_offsets(m, k, plan)
    assert staged.unique().numel() == staged.numel()
    assert int(staged.max()) < plan.scratch_bytes - 4 * m


def test_plan_rule_at_the_decode_shapes():
    """One row tile at every decode m of the engines; three warpgroups a CTA;
    gate_up's column blocks fill one wave with no split, down's 11 split K
    over clusters of 8 (within two thirds of the SMs: 16 such clusters did not
    fit the GPCs at once); a ring of two stages; the SM count comes from the
    caller."""
    gu, dn = ti.w4_plan(136, E3, I3, True, SMS), ti.w4_plan(136, I3, E3, False, SMS)
    assert (gu.row_tiles, gu.ranks, gu.warps, gu.ctas) == (1, 1, 12, 115)
    assert (dn.row_tiles, dn.ranks, dn.warps, dn.ctas) == (1, 8, 12, 88)
    assert gu.tile_rows == dn.tile_rows == 144
    assert ti.w4_plan(128, E3, I3, True, SMS).tile_rows == 128
    assert ti.w4_plan(8, E3, I3, True, SMS).tile_rows == 8
    assert ti.w4_plan(144, E3, I3, True, SMS).row_tiles == 1
    assert ti.w4_plan(146, E3, I3, True, SMS).tile_rows == 96  # two row tiles
    assert ti.w4_plan(8, I3, E3, False, 32, warps=8).ranks == 2  # 32 SMs: two ranks for 16 column blocks
    assert ti.w4_plan(136, I3, E3, False, SMS, warps=8).ranks == 4  # 16 clusters of 8 would not fit
    for plan in (gu, dn):
        assert plan.stages == ti.PLAN_STAGES and plan.smem_bytes <= ti.SMEM_LIMIT
    assert gu.ctas <= SMS and dn.ctas <= SMS


@pytest.mark.parametrize("args,kw", [
    ((136, 2048, 11008, True), dict(group=16)),
    ((136, 2048, 11008, True), dict(group=256)),
    ((136, 2000, 11008, True), {}),          # K no multiple of 2 * group
    ((136, 2048, 11004, True), {}),          # n no multiple of 8
    ((136, 11008, 2056, False), {}),         # n no multiple of 16
    ((0, 2048, 11008, True), {}),
    ((136, 2048, 11008, True), dict(warps=16)),
    ((136, 2048, 11008, True), dict(warps=9)),
    ((136, 2048, 11008, True), dict(warps=6)),      # not whole warpgroups
    ((136, 2048, 11008, True), dict(warps=0)),
    ((136, 11008, 2048, False), dict(ranks=9)),
    ((8, 256, 128, False), dict(ranks=2)),   # more ranks than the one stage
    ((136, 2048, 11008, True), dict(stages=1)),
    ((136, 2048, 11008, True), dict(stages=7)),
    ((136, 2048, 11008, True), dict(stages=6)),  # six stages of 54 KB do not fit
    ((136, 2048, 11008, True), dict(tile_rows=12)),
    ((136, 2048, 11008, True), dict(tile_rows=136)),  # no wgmma N of 136 is built
    ((136, 2048, 11008, True), dict(tile_rows=152)),
])
def test_plan_refuses_what_the_kernel_cannot_run(args, kw):
    with pytest.raises(ValueError):
        ti.w4_plan(*args, SMS, **kw) if "group" not in kw else ti.w4_plan(*args, SMS, kw["group"])


def test_constants_agree_with_the_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("STAGE_K") == ti.STAGE_K and const("WARP_COLS") == ti.WARP_COLS
    assert const("MAX_TILE_ROWS") == ti.MAX_TILE_ROWS and const("MAX_WARPS") == ti.MAX_WARPS
    assert const("MAX_RANKS") == ti.MAX_RANKS and const("MAX_STAGES") == ti.MAX_STAGES
    assert const("PART_PAD") == ti.PART_PAD and const("SMEM_LIMIT") == ti.SMEM_LIMIT
    built = re.search(r"#define W4_N\(X\) (.*)", src).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", built)) == ti.KERNEL_N
    for n in ti.KERNEL_N:  # a wgmma for each built N
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8" in src
    layout = re.search(r"inline Layout stage_layout\(.*?\n}", src, re.S).group(0)
    for term in ("L.xq = 2 * tile_rows * STAGE_K;", "L.w = WARP_COLS * warps * STAGE_K;",
                 "L.sbox = round_up((STAGE_K / group) * (WARP_COLS * warps / nmat) * 4, 128);",
                 "L.stage = round_up(L.xq + L.w + 2 * nmat * L.sbox, 1024);",
                 "ranks > 1 ? tile_rows * (WARP_COLS * warps + PART_PAD) * 4 : 0",
                 "L.total = 1024 + L.body + 16 * stages;"):
        assert term in layout, term
    offset = re.search(r"inline size_t staged_offset\(.*?\n}", src, re.S).group(0)
    assert "((((size_t)t * n_stages + st) * 2 + h) * tile_rows + rl) * STAGE_K" in offset
    assert "(((b >> 4) ^ (rl & 7)) << 4)" in offset
    entry = re.search(r'extern "C" int st_int4_mlp\(.*?\n}', src, re.S).group(0)
    assert "xq + (size_t)row_tiles * n_stages * 2 * tile_rows * STAGE_K" in entry  # xs after the staged xq
    for refusal in ("warps % 4 != 0", "warps > MAX_WARPS", "tile_rows > MAX_TILE_ROWS", "!built_tile(tile_rows)",
                    "stages < 2", "stages > MAX_STAGES", "ranks > MAX_RANKS", "ranks > n_stages",
                    "L.total > SMEM_LIMIT"):
        assert refusal in entry, refusal
    # the kernel's split of the stages over the ranks is the plan's
    assert "const int st0 = rank * per + min(rank, extra);" in src
    # the plan's sizes at the decode shapes, by the same arithmetic
    gu = ti.w4_plan(136, E3, I3, True, SMS)
    assert ti.stage_layout(144, 8, 128, 3, 1, 2) == {"xq": 36864, "w": 16384, "sbox": 256, "stage": 54272,
                                                     "body": 162816, "total": 163888}
    assert gu.smem_bytes == ti.stage_layout(144, 12, 128, 2, 1, 2)["total"] == 128032


# ---------------------------------------------------------------------------
# the kernel's summation order, emulated
# ---------------------------------------------------------------------------


def emulate(x, w, plan, gateup):
    """The kernel's arithmetic in its order: per rank, stage by stage, the
    low then the high half's groups, acc += float(int32 dot) * gscale[g]
    (the int32 dot of xq with u - 8, wgmma's); the ranks summed in rank
    order; times xs; gate_up: silu(g) * u rounded to bf16."""
    m, k = x.shape
    xq, xs = ti.quantize_rows(x)
    u = torch.cat([w.q4 & 15, w.q4 >> 4], dim=1).double() - ti.BIAS  # (C, K) signed values
    group = plan.group
    xg = xq.double().reshape(m, k // group, group)
    dots = torch.einsum("mgk,cgk->gmc", xg, u.reshape(u.shape[0], k // group, group)).float()  # exact
    total = None
    for groups in group_order(plan, k):
        part = torch.zeros(dots.shape[1:], dtype=torch.float32)
        for g in groups:
            part = part + dots[g] * w.gscale[g][None]
        total = part if total is None else total + part
    acc = total * xs
    if not gateup:
        return acc
    n = acc.shape[1] // 2
    g, up = acc[:, :n], acc[:, n:]
    return ((g * (1.0 / (1.0 + torch.exp(-g)))) * up).to(torch.bfloat16)


def _case(m, k, n_cols, group, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    wt = torch.from_numpy((rng.normal(size=(n_cols, k)) * 0.02).astype(np.float32))
    return x, ti.Int4Weight.from_weight(wt, group)


def _within_one_bf16_step(a, b):
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs())
    step = torch.where(big > 0, 2.0 ** (torch.floor(torch.log2(big.clamp(min=1e-30))) - 7), torch.zeros_like(big))
    return bool(((a - b).abs() <= step).all())


EMULATION_CASES = [
    # gate_up?, m, K, n (per matrix), group, plan overrides
    (False, 8, I3, E3, 128, {}),                     # 3B down: 8 ranks over 43 stages
    (False, 6, 1024, 256, 64, dict(ranks=3)),        # 4 stages over 3 ranks, two groups a stage-half
    (False, 10, 192, 128, 32, dict(ranks=1)),        # a partial stage, four groups a full stage-half
    (True, 8, E3, I3, 128, {}),                      # 3B gate_up
    (True, 6, 512, 128, 32, dict(ranks=2)),          # the split at gate_up
]


@pytest.mark.parametrize("gateup,m,k,n,group,kw", EMULATION_CASES)
def test_emulated_order_matches_plain(gateup, m, k, n, group, kw):
    x, w = _case(m, k, 2 * n if gateup else n, group, seed=m + k)
    plan = ti.w4_plan(m, k, n, gateup, SMS, group, **kw)
    got = emulate(x, w, plan, gateup)
    if gateup:
        assert _within_one_bf16_step(got, ti.w4_gateup_silu_plain(x, w.q4, w.gscale))
    else:
        ref = ti.w4_matmul_plain(x, w.q4, w.gscale, out_dtype=torch.float32)
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-12)


@pytest.mark.parametrize("gateup,m,k,n,group,kw", [c for c in EMULATION_CASES if c[2] <= 1024])
def test_emulated_order_matches_jax_kernel(gateup, m, k, n, group, kw):
    x, w = _case(m, k, 2 * n if gateup else n, group, seed=m + k)
    plan = ti.w4_plan(m, k, n, gateup, SMS, group, **kw)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jw = {"q4": jnp.asarray(w.q4.numpy().T.copy()), "gscale": jnp.asarray(w.gscale.numpy())}
    ref = ji.w4_gateup_silu(jx, jw) if gateup else ji.w4_matmul(jx, jw, out_dtype=jnp.float32)
    assert ref is not None
    assert _rel(emulate(x, w, plan, gateup).float().numpy(), np.asarray(ref, np.float32)) <= 2e-3
