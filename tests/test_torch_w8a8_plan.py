"""The plan of kernel A, the fused W8A8 matmul (``spatialthinker_torch/ops/int8_matmul.py``
``w8a8_plan``), held on the CPU: the plan is what the card runs, so these
tests hold the card's cut of the work without the card.

- At every linear of the 3B and 7B presets and every m the engines and
  the regimes' edges give, the CTAs of the plan (decoded from the launch grid
  as the kernel decodes ``blockIdx``) cover every (row tile, column tile,
  k-step) exactly once; a decode plan puts all m rows in one row tile and
  launches at least ``MIN_DECODE_CTAS`` CTAs; K is split only within one CTA
  an SM and into splits of at least ``MIN_SPLIT_STEPS`` k-steps; each split's
  k range is a whole number of the kernel's k-step.
- The plan's split-K emulated in plain torch: int32 partial dots over the
  plan's k ranges, summed in int32 in a shuffled order, equal the whole dot
  (``torch._int_mm``) exactly, and after ``w8a8_epilogue`` the plain chain
  bit for bit. Exact because integer addition is associative: no tolerance.
- The constants the plan and the CUDA source share (k-step, split and stage
  limits, the tiles built, the shared-memory arithmetic) agree, read from the
  source text.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spatialthinker_torch.ops import int8_matmul as i8

LINEARS = {  # (K, N): the 3B and 7B presets' qkv, o, gate_up, down and tied head
    "qkv": (2048, 2560), "o": (2048, 2048), "gate_up": (2048, 22016), "down": (11008, 2048),
    "head": (2048, 151936),
    "qkv_7b": (3584, 4608), "o_7b": (3584, 3584), "gate_up_7b": (3584, 37888), "down_7b": (18944, 3584),
    "head_7b": (3584, 152064),
}
MS = [1, 15, 16, 17, 64, 65, 128, 129, 136, 255, 256, 257, 1024, 4096]
# every decode plan of these linears has at least this many CTAs: the 3B
# o_proj's 32 column tiles of 64 (a measured optimum; more CTAs with shallower
# rings ran slower, PERF.md §6)
MIN_DECODE_CTAS = 32
SOURCE = Path(i8.__file__).resolve().parents[1] / "csrc" / "int8_matmul.cu"


def kernel_blocks(plan, m, n, k):
    """(rows, columns, k-steps) of every CTA, decoded from blockIdx as
    ``w8a8_gemm_kernel`` decodes it (grid (splits * row tiles, column tiles);
    the split's first step and count from k_steps // splits and the rest)."""
    steps = -(-k // i8.K_STEP)
    per, extra = divmod(steps, plan.splits)
    for bx in range(plan.splits * plan.row_tiles):
        for by in range(plan.col_tiles):
            split, r = bx % plan.splits, bx // plan.splits
            step0 = split * per + min(split, extra)
            n_k = per + (split < extra)
            yield (range(r * plan.bm, min(m, (r + 1) * plan.bm)), range(by * plan.bn, min(n, (by + 1) * plan.bn)),
                   range(step0, step0 + n_k), split)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", list(LINEARS))
def test_plan_covers_every_tile_and_k_step_once(name, m):
    k, n = LINEARS[name]
    plan = i8.w8a8_plan(m, n, k)
    steps = -(-k // i8.K_STEP)
    assert (plan.mb, plan.bn) in i8.TILES
    assert 1 <= plan.splits <= min(i8.MAX_SPLITS, steps)
    assert 2 <= plan.stages <= i8.MAX_STAGES and plan.smem_bytes <= i8.SMEM_LIMIT
    assert plan.a_rows + plan.bn >= plan.bm and plan.a_rows >= min(m, plan.bm)  # every warpgroup reads its slot
    assert (plan.row_tiles - 1) * plan.bm < m <= plan.row_tiles * plan.bm
    assert (plan.col_tiles - 1) * plan.bn < n <= plan.col_tiles * plan.bn
    cover = np.zeros((plan.row_tiles, plan.col_tiles, steps), np.int32)
    for rows, cols, ksteps, split in kernel_blocks(plan, m, n, k):
        assert len(rows) and len(cols) and len(ksteps)  # no CTA without work
        # the kernel's own k range is the plan's, and a whole number of k-steps
        k0, k1 = plan.k_ranges[split]
        assert (k0, k1) == (ksteps.start * i8.K_STEP, min(ksteps.stop * i8.K_STEP, k))
        assert k0 % i8.K_STEP == 0 and (k1 - k0) % i8.K_STEP == 0
        cover[rows.start // plan.bm, cols.start // plan.bn, ksteps.start:ksteps.stop] += 1
    assert (cover == 1).all()
    assert plan.ctas == plan.splits * plan.row_tiles * plan.col_tiles
    if plan.splits > 1:  # K is split only within one CTA an SM, each split long enough
        assert plan.ctas <= i8.NUM_SMS and plan.splits <= i8.PLAN_MAX_SPLITS
        assert min(k1 - k0 for k0, k1 in plan.k_ranges) >= i8.MIN_SPLIT_STEPS * i8.K_STEP
    if m <= i8.DECODE_MAX_M:
        assert plan.regime == "decode" and plan.row_tiles == 1  # each weight byte read by one CTA
        assert plan.ctas >= MIN_DECODE_CTAS
    else:
        assert plan.regime == "prefill" and plan.bm == 128


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, size=(n, k), dtype=np.int8))
    ws = torch.from_numpy((rng.random(n) * 2e-3 + 1e-4).astype(np.float32))
    return x, w, ws, rng


@pytest.mark.parametrize("m", [1, 65, 136, 1024])
@pytest.mark.parametrize("name", list(LINEARS))
def test_split_k_of_the_plan_equals_the_whole_dot(name, m):
    """The plan's k ranges at the real shape, on 64 of its weight rows."""
    k, n = LINEARS[name]
    plan = i8.w8a8_plan(m, n, k)
    x, w, ws, rng = _inputs(m, k, 64, seed=k + n + m)
    xq, xs = i8.quantize_rows(x)
    partials = [torch._int_mm(xq[:, k0:k1].contiguous(), w[:, k0:k1].t().contiguous())
                for k0, k1 in plan.k_ranges]
    acc = torch.zeros((m, 64), dtype=torch.int32)
    for s in rng.permutation(len(partials)):
        acc += partials[s]
    assert acc.dtype == torch.int32
    assert torch.equal(acc, i8.int8_matmul(xq, w.t()))
    for out_dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(i8.w8a8_epilogue(acc, xs, ws, out_dtype),
                           i8.fused_w8a8_matmul_plain(x, w, ws, out_dtype))


@pytest.mark.parametrize("splits", [2, 3, 5, 8])
def test_split_k_with_a_ragged_k_tail(splits):
    """K = 1,056 (8 whole k-steps and 32 bytes): the last range ends at K."""
    m, k, n = 33, 1056, 40
    ranges = i8.split_k_ranges(k, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    x, w, ws, rng = _inputs(m, k, n, seed=splits)
    xq, _ = i8.quantize_rows(x)
    acc = torch.zeros((m, n), dtype=torch.int32)
    for s in rng.permutation(splits):
        k0, k1 = ranges[s]
        acc += torch._int_mm(xq[:, k0:k1].contiguous(), w[:, k0:k1].t().contiguous())
    assert torch.equal(acc, i8.int8_matmul(xq, w.t()))


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):
        i8.w8a8_plan(65, 2048, 2048, splits=9)  # more than a portable cluster
    with pytest.raises(ValueError):
        i8.w8a8_plan(65, 2048, 256, splits=4)  # more splits than k-steps
    with pytest.raises(ValueError):
        i8.w8a8_plan(200, 2048, 2048, bn=256)  # 256 x 256 is not built
    with pytest.raises(ValueError):
        i8.w8a8_plan(4096, 2048, 2048, bn=256, stages=8)  # the ring exceeds shared memory
    with pytest.raises(ValueError):
        i8.w8a8_plan(4096, 2048, 2048, regime="decode")  # one row tile holds at most 256 rows
    assert i8.w8a8_plan(65, 2048, 2048, splits=1).splits == 1
    assert i8.w8a8_plan(200, 2048, 2048, regime="prefill").row_tiles == 2


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("K_STEP") == i8.K_STEP
    assert const("MAX_SPLITS") == i8.MAX_SPLITS
    assert const("MAX_STAGES") == i8.MAX_STAGES
    assert const("PART_PAD") == i8.PART_PAD
    assert const("SMEM_LIMIT") == i8.SMEM_LIMIT
    tiles = re.search(r"#define W8A8_TILES\(X\)(.*)", src).group(1)
    assert {tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+)\)", tiles)} == set(i8.TILES)
    # Tile::smem_bytes: 1 KB alignment + the ring or the padded partial + 16 bytes a stage
    assert "return 1024 + body_bytes(stages, splits, a_bytes) + 16 * stages;" in src
    assert "const int ring = stages * (a_bytes + B_BYTES);" in src
    assert i8.smem_bytes(2, 64, 3, 8, 72) == 1024 + max(3 * (72 + 64) * 128, 128 * 68 * 4) + 48
    assert i8.smem_bytes(4, 128, 2, 8, 200) == 1024 + 256 * 132 * 4 + 32  # the partial outgrows the ring
    # xq's box: the live rows rounded up to 8 with one row tile (no fewer than 64 mb - bn), else the tile
    assert "const int a_rows = m <= 64 * mb ? max((m + 7) / 8 * 8, 64 * mb - bn) : 64 * mb;" in src
    assert [i8.xq_box_rows(m, mb, bn) for m, mb, bn in ((65, 2, 64), (136, 3, 64), (1, 1, 64), (20, 4, 64),
                                                         (4096, 2, 256))] == [72, 136, 8, 192, 128]
