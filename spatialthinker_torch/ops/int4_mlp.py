"""W4A8 decode MLP: int4 group-quantized weights, int8 per-row activations,
the silu junction fused — the CUDA kernels (``csrc/int4_mlp.cu``) and their
plain PyTorch versions.

Counterpart of ``spatialthinker_tpu/ops/int4_mlp.py``: ``w4_gateup_silu``
replaces the TPU kernel ``_gateup_kernel`` and ``w4_matmul`` replaces
``_matmul_kernel``. The int4 copies exist for decode only (the rollout copy
of ``ops.quant.quantize_model(mode="w4a8")``); prefill-sized m keeps the int8
path, because the eligibility rule below refuses it.

Packing (``pack_int4_grouped``, bytes bit-identical to the JAX package's):
symmetric int4 with one fp32 scale per (group of rows along K, output
column), ``gscale = max(amax, 1e-8) / 7``, values ``round(w / gscale)``
clipped to +-7 and stored +8 biased (unsigned nibbles 1..15). Split-half
along K: packed row r holds row r in its LOW nibble and row r + K/2 in its
HIGH nibble. The JAX layout is ``q4`` (K/2, N), ``gscale`` (K/group, N).
The port's model keeps ``q4`` transposed, (N, K/2) — one contiguous byte row
per output column, the (out, in) form of its other weights — so a kernel
thread reads eight consecutive packed rows of one column with one 8-byte
load; ``gscale`` keeps the JAX layout. ``Int4Weight`` holds the pair.

The function both kernels and plain versions compute:
- x (m, K) -> xq int8 per row: ``xs = max(amax_row |x|, 1e-8) / 127``,
  ``xq = clip(round_half_even(x / xs), +-127)``;
- per group g the exact int32 dot of xq with the UNSIGNED nibbles, minus
  ``8 * sum(xq over the group)`` (the bias folded out: x.(u - 8) = x.u - 8 sum x);
- times ``gscale[g]`` in fp32, summed over the groups in fp32;
- times ``xs``;
- gate_up: columns [gate | up], each I wide; ``h = silu(g) * u`` rounded to
  bf16 whatever x's dtype (the TPU kernel's output type). down: the output in
  ``out_dtype``.
Only the order of the fp32 group sums differs between a kernel and its plain
version.

``w4_swiglu`` is the MLP's entry point: it asks both kernels' rules once and
runs #13 then #14, or answers None for the int8 path.

Eligibility (``w4_eligible``) is the JAX package's ``_eligible_m`` plus
``_pick_bn``'s VMEM fit, copied as they are. The VMEM budget is a Mosaic
constraint of the TPU, but here it decides WHICH ARITHMETIC RUNS: where it
refuses a shape, the whole MLP takes the int8 weights instead of the int4
ones. So it is part of this path's semantics, kept for parity with the JAX
package (ROADMAP section C asks whether the port should keep it).

How the card cuts one call (``w4_plan``, the one source of truth;
``csrc/int4_mlp.cu`` refuses a plan it cannot run; the CPU tests hold it):
a prologue writes xs and xq in the order the main kernel stages it
(``staged_offsets``); each CTA owns a row tile of up to 144 rows and 16
weight columns per warp (one to three warpgroups of ``wgmma``), streams 128
packed bytes of K a ring stage (xq block, weight box, group scales) and,
where the column tiles leave SMs idle, splits the stages over a cluster
whose ranks sum their fp32 partials in rank order. Within a rank the groups are summed stage by stage, the low
half's groups of a stage before its high half's.

The wrappers run the plain versions for CPU tensors only; a CUDA tensor
launches the kernel or raises — nothing falls back.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from .. import csrc
from .int8_matmul import _stream, quantize_rows  # the row quantize: a true division on every device
from .paged_attention import device_sms

_EPS = 1e-8
GROUP = 128
BIAS = 8  # stored nibble = value + 8
_VMEM_BUDGET = 14 * 1024 * 1024
KERNEL_GROUPS = (32, 64, 128)  # whole k32 steps of wgmma inside one group, at most four a group

# ---- the plan: how the kernels cut one call over the card's CTAs (constants of csrc/int4_mlp.cu) ----
STAGE_K = 128          # packed bytes of K a ring stage: one 128-byte swizzled row
WARP_COLS = 16         # weight columns of a consumer warp: its m16 slice of the warpgroup's m64
MAX_TILE_ROWS = 144    # rows of a row tile (wgmma's N)
WARPS = (4, 8, 12)     # consumer warps of a CTA: one, two or three warpgroups
MAX_WARPS = 12
MAX_RANKS = 8          # CTAs of a cluster that split K (the portable cluster size)
CLUSTER8_SHARE = 2 / 3  # clusters of 8 at one CTA an SM: the H100 held 11 at once, not 16 (PERF.md)
MAX_STAGES = 6
PLAN_STAGES = 2        # the plan's ring depth: deeper rings measured no faster (PERF.md)
MIN_RANK_STAGES = 4    # a rank keeps at least this many stages (its combine costs two cluster barriers)
PART_PAD = 4           # floats of padding a row of a rank's partial tile
SMEM_LIMIT = 232_448   # bytes of shared memory a block may use
KERNEL_N = (8, 16, 32, 64, 96, 128, 144)  # the row tiles that are built (W4_N): wgmma's N
NUM_SMS = 132          # the H100 SXM's streaming multiprocessors


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def pack_int4_grouped(w: torch.Tensor, contract_axis: int, group: int = GROUP) -> Dict[str, torch.Tensor]:
    """Symmetric int4 with per-(group rows, output column) scales, in the JAX
    package's layout: w (..., K at contract_axis, ...) -> {"q4": uint8 (...,
    K/2, ...), "gscale": fp32 (..., K/group, ...)}. K must be a multiple of
    2 * group."""
    k = w.shape[contract_axis]
    if k % (2 * group):
        raise ValueError(f"K={k} is no multiple of 2 * group = {2 * group}")
    wf = w.float()
    shape = list(w.shape)
    shape[contract_axis:contract_axis + 1] = [k // group, group]
    amax = wf.reshape(shape).abs().amax(dim=contract_axis + 1)
    gscale = torch.clamp(amax, min=_EPS) / 7.0
    q = torch.clamp(torch.round(wf / gscale.repeat_interleave(group, dim=contract_axis)), -7, 7)
    q = (q + BIAS).to(torch.uint8)
    low, high = q.split(k // 2, dim=contract_axis)
    return {"q4": (low & 0xF) | (high << 4), "gscale": gscale}


class Int4Weight(nn.Module):
    """An int4 decode copy of one matmul weight: ``q4`` (N, K/2) uint8, one
    byte row per output column, and ``gscale`` (K/group, N) fp32."""

    def __init__(self, q4: torch.Tensor, gscale: torch.Tensor):
        super().__init__()
        self.register_buffer("q4", q4)
        self.register_buffer("gscale", gscale)

    @classmethod
    def from_weight(cls, w: torch.Tensor, group: int) -> "Int4Weight":
        """From an (out, in) weight, contracting ``in``."""
        p = pack_int4_grouped(w.detach(), 1, group)  # (N, K/2), (N, K/group)
        return cls(p["q4"].contiguous(), p["gscale"].t().contiguous())

    @property
    def group(self) -> int:
        return 2 * self.q4.shape[1] // self.gscale.shape[0]


# ---------------------------------------------------------------------------
# eligibility (the JAX package's rule, shape only)
# ---------------------------------------------------------------------------


def _pick_bn(m: int, k: int, n: int, streams: int) -> Optional[int]:
    """The JAX package's panel choice: the largest 128-multiple panel width
    whose blocks fit its VMEM budget (``spatialthinker_tpu/ops/int4_mlp.py``
    ``_pick_bn``, term for term)."""
    for bn in (1024, 512, 256, 128):
        if n % bn:
            continue
        used = (
            m * k + m * 128 * 4
            + m * k * 4
            + streams * (2 * (k // 2) * bn)
            + streams * (2 * (k // GROUP) * bn * 4)
            + streams * (4 * GROUP * bn * 5)
            + streams * (m * bn * 4)
            + 2 * (m * bn * 2)
        )
        if used <= _VMEM_BUDGET:
            return bn
    return None


def w4_eligible(m: int, k: int, n: int, group: int, streams: int) -> bool:
    """Whether the int4 function runs for an (m, k) input against a weight of
    ``n`` output columns per stream (gate_up: n = I with 2 streams; down: n =
    E with 1) at this group size — else the caller takes the int8 path."""
    if not (0 < m <= 512 and m % 2 == 0 and m * k <= 8 * 1024 * 1024):
        return False
    if group <= 0 or k % (2 * group) or n % 128 or group % 8:
        return False
    return _pick_bn(m, k, n, streams) is not None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _w4_acc(x: torch.Tensor, q4: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """sum_g (xq_g . u_g - 8 sum xq_g) * gscale[g], times xs: (m, N) fp32.
    The per-group integer dots run as fp32 products of integers below 2^24,
    exact in any order."""
    m, k = x.shape
    n_groups = gscale.shape[0]
    group = k // n_groups
    xq, xs = quantize_rows(x)
    u = torch.cat([q4 & 15, q4 >> 4], dim=1).float()  # (N, K) stored nibbles, k order
    xg = xq.float().reshape(m, n_groups, group)
    d = torch.einsum("mgk,ngk->mgn", xg, u.reshape(-1, n_groups, group))
    d = d - BIAS * xg.sum(dim=2, keepdim=True)
    return (d * gscale.float()[None]).sum(dim=1) * xs


def w4_gateup_silu_plain(x: torch.Tensor, q4: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x (m, E) against the int4 gate_up copy (2I columns, gate first) ->
    silu(gate) * up (m, I) bf16."""
    acc = _w4_acc(x, q4, gscale)
    i = acc.shape[1] // 2
    g, u = acc[:, :i], acc[:, i:]
    return ((g * torch.sigmoid(g)) * u).to(torch.bfloat16)


def w4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, gscale: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (m, K) against an int4 copy of N columns -> (m, N) in ``out_dtype``."""
    return _w4_acc(x, q4, gscale).to(out_dtype)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stage_layout(tile_rows: int, warps: int, group: int, stages: int, ranks: int, nmat: int) -> Dict[str, int]:
    """Bytes of a CTA's shared memory, as ``stage_layout`` in
    ``csrc/int4_mlp.cu`` computes them: a ring stage holds the xq block (the
    low then the high half's rows x 128 bytes), the weight box(es) and 2 x
    nmat scale boxes; a rank's partial tile reuses the ring."""
    xq = 2 * tile_rows * STAGE_K
    w = WARP_COLS * warps * STAGE_K
    sbox = _round_up((STAGE_K // group) * (WARP_COLS * warps // nmat) * 4, 128)
    stage = _round_up(xq + w + 2 * nmat * sbox, 1024)
    part = tile_rows * (WARP_COLS * warps + PART_PAD) * 4 if ranks > 1 else 0
    body = max(stages * stage, part)
    return {"xq": xq, "w": w, "sbox": sbox, "stage": stage, "body": body, "total": 1024 + body + 16 * stages}


class W4Plan(NamedTuple):
    """How one call runs: CTA (rank q, column block b, row tile r) for
    blockIdx (q + ranks * b, r) multiplies rows [r * tile_rows, (r + 1) *
    tile_rows) against ``warps`` x 16 weight columns (gate_up: each warp 8
    gate and the same 8 up columns; down: 16 adjacent ones) over the ring
    stages ``rank_stages(q)``; the ``ranks`` CTAs of a block form one cluster
    and sum their fp32 partials in rank order."""
    gateup: bool
    group: int
    warps: int             # consumer warps of a CTA
    ranks: int             # CTAs of a cluster that split K's stages
    stages: int            # depth of the ring
    tile_rows: int         # rows of a row tile: a built N of wgmma (KERNEL_N)
    row_tiles: int
    col_blocks: int
    n_stages: int          # ring stages of K: 128 packed bytes each, the last maybe partial
    smem_bytes: int
    scratch_bytes: int     # the staged xq, then xs

    @property
    def ctas(self) -> int:
        return self.ranks * self.col_blocks * self.row_tiles

    def rank_stages(self, rank: int) -> range:
        """The ring stages rank ``rank`` runs: the first n_stages % ranks
        ranks take one more."""
        per, extra = divmod(self.n_stages, self.ranks)
        start = rank * per + min(rank, extra)
        return range(start, start + per + (rank < extra))

    def describe(self) -> dict:
        return {"warps": self.warps, "ranks": self.ranks, "stages": self.stages, "tile_rows": self.tile_rows,
                "row_tiles": self.row_tiles, "col_blocks": self.col_blocks, "ctas": self.ctas,
                "smem_bytes": self.smem_bytes}


@functools.lru_cache(maxsize=4096)
def w4_plan(m: int, k: int, n: int, gateup: bool, sms: int = NUM_SMS, group: int = GROUP, *,
            warps: Optional[int] = None, ranks: Optional[int] = None, stages: Optional[int] = None,
            tile_rows: Optional[int] = None) -> W4Plan:
    """The plan the card runs for x (m, k) against ``n`` output columns per
    matrix (gate_up: n = I, two matrices; down: n = N) at this group size, on
    a device of ``sms`` streaming multiprocessors (``device_sms``).
    ``warps``, ``ranks``, ``stages`` and ``tile_rows`` override the choice
    (for measurements). The rule:

    - row tiles of at most MAX_TILE_ROWS rows, as few as hold m (one at every
      decode m of the engines), each the least built N (KERNEL_N) that holds
      its share of m;
    - one, two or three consumer warpgroups a CTA: the fewest waves of one
      CTA an SM, then the most warpgroups (they overlap each other's
      products and fp32 scaling);
    - K's ring stages split over the most CTAs of a cluster (8, 4, 2) that
      keep the call within ``sms`` CTAs (clusters of 8 within
      CLUSTER8_SHARE of them) and MIN_RANK_STAGES stages a rank;
    - a ring of PLAN_STAGES stages.

    Raises ValueError for a shape or plan the kernel cannot run."""
    if m < 1 or group not in KERNEL_GROUPS or k < 2 * group or k % (2 * group):
        raise ValueError(f"no int4 plan for m={m}, K={k} at group {group} (groups {KERNEL_GROUPS}, "
                         "K a multiple of 2 * group)")
    nmat = 2 if gateup else 1
    unit = WARP_COLS // nmat  # output columns of a warp
    if n < unit or n % unit:
        raise ValueError(f"the int4 {'gate_up' if gateup else 'down'} kernel takes n a multiple of {unit}, got {n}")
    if tile_rows is None:
        share = -(-m // -(-m // MAX_TILE_ROWS))
        tile_rows = min(t for t in KERNEL_N if t >= share)
    if tile_rows not in KERNEL_N:
        raise ValueError(f"row tiles of {tile_rows} rows: {KERNEL_N} are built")
    row_tiles = -(-m // tile_rows)
    units = n // unit
    n_stages = -(-(k // 2) // STAGE_K)

    def split(w: int) -> int:  # the ranks the rule gives w warps
        blocks = -(-units // w) * row_tiles
        return next(r for r in (8, 4, 2, 1) if r == 1 or (
            r <= n_stages // MIN_RANK_STAGES and blocks * r <= (sms * CLUSTER8_SHARE if r == 8 else sms)))

    def waves(w: int) -> int:
        return -(-(-(-units // w) * row_tiles * (ranks or split(w))) // sms)

    if warps is None:  # the fewest waves of one CTA an SM, then the most warpgroups a CTA
        warps = min(WARPS, key=lambda w: (waves(w), -w))
    if warps not in WARPS:
        raise ValueError(f"{warps} consumer warps: {WARPS} run")
    col_blocks = -(-units // warps)
    if ranks is None:
        ranks = split(warps)
    if not 1 <= ranks <= min(MAX_RANKS, n_stages):
        raise ValueError(f"{ranks} ranks of {n_stages} stages: 1 to {min(MAX_RANKS, n_stages)} run")
    stages = PLAN_STAGES if stages is None else stages
    smem = stage_layout(tile_rows, warps, group, stages, ranks, nmat)["total"]
    if not 2 <= stages <= MAX_STAGES or smem > SMEM_LIMIT:
        raise ValueError(f"a ring of {stages} stages ({smem} bytes) does not fit")
    scratch = row_tiles * n_stages * 2 * tile_rows * STAGE_K + 4 * m
    return W4Plan(gateup, group, warps, ranks, stages, tile_rows, row_tiles, col_blocks, n_stages, smem, scratch)


def staged_offsets(m: int, k: int, plan: W4Plan) -> torch.Tensor:
    """(m, k) int64: the byte offset of xq[r][c] in the scratch the prologue
    writes, as ``staged_offset`` in ``csrc/int4_mlp.cu`` computes it: row tile
    t, stage st (packed byte of c over 128), half h (c >= K/2); a block of
    tile_rows x 128 bytes each, 16-byte chunk b // 16 of row rl at chunk
    (b // 16) ^ (rl % 8)."""
    r = torch.arange(m, dtype=torch.int64)[:, None]
    c = torch.arange(k, dtype=torch.int64)[None, :]
    t, rl = r // plan.tile_rows, r % plan.tile_rows
    h = (c >= k // 2).long()
    p = c - h * (k // 2)
    st, b = p // STAGE_K, p % STAGE_K
    block = ((t * plan.n_stages + st) * 2 + h) * plan.tile_rows + rl
    return block * STAGE_K + (((b >> 4) ^ (rl & 7)) << 4) + (b & 15)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_cuda_inputs(x: torch.Tensor, w: Int4Weight, n_cols: int) -> None:
    m, k = x.shape
    group = k // w.gscale.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the int4 MLP kernels take bf16 activations, got {x.dtype}")
    if group not in KERNEL_GROUPS:
        raise ValueError(
            f"the int4 MLP kernels take group sizes {KERNEL_GROUPS} (whole k-steps of 32 "
            f"inside one group), got {group}")
    if tuple(w.q4.shape) != (n_cols, k // 2) or tuple(w.gscale.shape) != (k // group, n_cols):
        raise ValueError(f"int4 weight q4{tuple(w.q4.shape)} gscale{tuple(w.gscale.shape)} does not fit "
                         f"x{tuple(x.shape)} with {n_cols} columns")
    for name, t, dtype in (("x", x, torch.bfloat16), ("q4", w.q4, torch.uint8),
                           ("gscale", w.gscale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(x: torch.Tensor, w: Int4Weight, out: torch.Tensor, gateup: bool) -> torch.Tensor:
    """The prologue (row quantize into the staged layout) + the int4 kernel
    under ``w4_plan``, on the current stream; returns the scratch (staged xq,
    then xs)."""
    m, k = x.shape
    n_cols = w.q4.shape[0]
    group = k // w.gscale.shape[0]
    device = x.device
    plan = w4_plan(m, k, n_cols // 2 if gateup else n_cols, gateup, device_sms(device.index), group)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8, device=device)
    args = (x.data_ptr(), scratch.data_ptr(), w.q4.data_ptr(), w.gscale.data_ptr(), out.data_ptr(), m, k, n_cols,
            group, int(gateup), int(out.dtype == torch.float32), plan.warps, plan.ranks, plan.stages,
            plan.tile_rows)
    lib = csrc.library()
    if device.index == torch.cuda.current_device():
        rc = lib.st_int4_mlp(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            rc = lib.st_int4_mlp(*args, _stream(device))
    csrc.check_launch(rc, "int4 MLP")
    return scratch


def _gateup_eligible(m: int, k: int, w: Int4Weight) -> bool:
    return w4_eligible(m, k, w.q4.shape[0] // 2, k // w.gscale.shape[0], streams=2)


def _down_eligible(m: int, k: int, w: Int4Weight) -> bool:
    return w4_eligible(m, k, w.q4.shape[0], k // w.gscale.shape[0], streams=1)


def _gateup(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """#13 on an admitted shape: the kernel for a CUDA tensor, else the plain version."""
    if not x.is_cuda:
        return w4_gateup_silu_plain(x, w.q4, w.gscale)
    i = w.q4.shape[0] // 2
    _check_cuda_inputs(x, w, 2 * i)
    out = torch.empty((x.shape[0], i), dtype=torch.bfloat16, device=x.device)
    _launch(x, w, out, gateup=True)
    w4_gateup_silu.launches += 1
    return out


def _down(x: torch.Tensor, w: Int4Weight, out_dtype) -> torch.Tensor:
    """#14 on an admitted shape: the kernel for a CUDA tensor, else the plain version."""
    if not x.is_cuda:
        return w4_matmul_plain(x, w.q4, w.gscale, out_dtype)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the int4 down kernel writes bf16 or fp32, not {out_dtype}")
    n = w.q4.shape[0]
    _check_cuda_inputs(x, w, n)
    out = torch.empty((x.shape[0], n), dtype=out_dtype, device=x.device)
    _launch(x, w, out, gateup=False)
    w4_matmul.launches += 1
    return out


def w4_gateup_silu(x: torch.Tensor, w: Int4Weight) -> Optional[torch.Tensor]:
    """x (m, E) against the int4 gate_up copy (``q4`` (2I, E/2)) -> silu(gate)
    * up (m, I) bf16, or None where the JAX package's rule refuses the shape."""
    return _gateup(x, w) if _gateup_eligible(*x.shape, w) else None


def w4_matmul(x: torch.Tensor, w: Int4Weight, out_dtype=torch.bfloat16) -> Optional[torch.Tensor]:
    """x (m, K) against an int4 copy of N columns (``q4`` (N, K/2)) -> (m, N)
    in ``out_dtype``, or None where the JAX package's rule refuses the shape."""
    return _down(x, w, out_dtype) if _down_eligible(*x.shape, w) else None


def w4_swiglu(x: torch.Tensor, gate_up: Int4Weight, down: Int4Weight, out_dtype) -> Optional[torch.Tensor]:
    """Decode-path SwiGLU on an MLP's int4 copies: #13 (gate_up with the silu
    junction), then #14 (down with its per-row quantize). x is (..., E).
    Returns None when either kernel's rule refuses the shape (prefill-sized m,
    odd m), and the caller runs the whole MLP on the int8 path. The JAX
    package's ``w4_swiglu`` runs gate_up before it asks the down kernel and
    throws that ``h`` away on a refusal; both rules are shape-only, so asking
    both first gives the same function without the wasted launch (m = 256 at
    3B: gate_up fits, down does not)."""
    lead, e = x.shape[:-1], x.shape[-1]
    m, inter = math.prod(lead), gate_up.q4.shape[0] // 2
    if not (_gateup_eligible(m, e, gate_up) and _down_eligible(m, inter, down)):
        return None
    out = _down(_gateup(x.reshape(m, e), gate_up), down, out_dtype)
    return out.reshape(*lead, out.shape[-1])


w4_gateup_silu.launches = 0
w4_matmul.launches = 0
