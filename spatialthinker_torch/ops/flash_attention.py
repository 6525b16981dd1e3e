"""Flash attention: the CUDA kernels (``csrc/flash_attention.cu`` forward,
``csrc/flash_attention_bwd.cu`` pre-pass, dQ and dK/dV) and their plain
PyTorch versions, joined by a ``torch.autograd.Function``.

Counterpart of ``spatialthinker_tpu/ops/flash_attention.py``. ``flash_fwd``
returns the output and the per-row logsumexp, as ``_flash_fwd`` does;
``flash_bwd`` takes them back with dO and returns (dq, dk, dv), as
``_flash_bwd`` does; ``flash_attention`` is the differentiable entry point
(``_flash_attention_core``): its forward is ``flash_fwd`` and its backward
``flash_bwd``, so one call serves inference and training.

Contract (same as the TPU kernels): q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D),
segment ids (B, S) int32 where 0 = padding. A query attends a key iff their
segment ids are equal and nonzero and, when causal,
``kv_pos <= causal_offset + q_pos``. Fully masked rows give o = 0,
lse = -1e30 and exact zeros in every gradient. The backward takes
``causal_offset = 0`` only (cross-length chunked prefill is inference-only).

Both directions skip tile pairs by the segment-id range tables of q_seg
and kv_seg: int32 (B, ceil(S / RANGE_TILE), 2), per tile of RANGE_TILE rows
the smallest and largest NONZERO id, (INT32_MAX, INT32_MIN) for a tile of
padding only (``tile_ranges``). Disjoint ranges share no nonzero id, so the
skip is exact for any layout. The forward's C call first launches the
range kernel (counted on ``_launch_ranges``), then runs a (q tile, kv tile)
pair of ``FWD_Q_ROWS`` x ``FWD_KV_ROWS`` rows only when the ranges intersect
and, when causal, the kv tile starts at or before the diagonal of the q
tile's last row (``fwd_live_tiles``, right for Sq != Skv and any
causal_offset).
The backward's pre-pass writes delta = rowsum(dO * o) and the same tables;
its dQ and dK/dV kernels run a pair of RANGE_TILE-row tiles when the ranges
intersect and, when causal, the kv tile is not wholly above the diagonal
(``live_tile_pairs``; causal_offset 0 and Sq = Skv there).

The wrappers run the plain versions for CPU tensors only. A CUDA tensor
launches the kernels or raises -- nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import csrc

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (80, 128)  # vision and text heads of the 3B/7B presets
RANGE_TILE = 32               # rows per tile of the range tables
FWD_Q_ROWS = 64               # q rows of one warpgroup of the forward kernel (one wgmma M tile)
FWD_KV_ROWS = 64              # kv rows per tile the forward kernel streams
DKV_ROWS = 64                 # kv rows per CTA of the dK/dV kernel
INT32_MAX, INT32_MIN = 2**31 - 1, -(2**31)


def make_attention_mask(
    q_seg: torch.Tensor,  # (B, Sq)
    kv_seg: torch.Tensor,  # (B, Skv)
    causal: bool,
    causal_offset: int = 0,
) -> torch.Tensor:
    """Boolean (B, Sq, Skv) mask: same nonzero segment, and causal order."""
    mask = (q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] != 0)
    if causal:
        sq, skv = q_seg.shape[1], kv_seg.shape[1]
        q_pos = torch.arange(sq, device=q_seg.device)[:, None] + causal_offset
        kv_pos = torch.arange(skv, device=q_seg.device)[None, :]
        mask = mask & (kv_pos <= q_pos)
    return mask


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_seg: torch.Tensor, kv_seg: torch.Tensor,
    *, causal: bool, scale: float, causal_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference forward: fp32 scores and softmax over the whole row, the
    softmax weights cast to v's dtype for the PV product (as the kernels do).
    Returns (o (B, Sq, Hq, D) in q's dtype, lse (B, Hq, Sq) fp32)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = make_attention_mask(q_seg, kv_seg, causal, causal_offset)[:, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float()) / safe
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(safe))
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return o, lse.reshape(b, hq, sq)


def _check_cuda_inputs(q, k, v, q_seg, kv_seg, *, do=None, o=None, lse=None) -> None:
    """Shape, dtype, device and layout checks shared by the forward and the
    backward launch: both reject the same inputs with the same messages. The
    backward passes its extra tensors (dO and o shaped like q, lse (B, Hq, Sq))."""
    csrc.refuse_sharded(q=q, k=k, v=v, q_seg=q_seg, kv_seg=kv_seg, dO=do, o=o, lse=lse)
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not fit q {tuple(q.shape)}")
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of kv heads {hkv}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    if min(b, sq, skv) < 1:
        raise ValueError("flash kernel needs non-empty batch and sequences")
    if tuple(q_seg.shape) != (b, sq) or tuple(kv_seg.shape) != (b, skv):
        raise ValueError("segment ids must be (B, Sq) and (B, Skv)")
    tensors = [("q", q, torch.bfloat16), ("k", k, torch.bfloat16), ("v", v, torch.bfloat16),
               ("q_seg", q_seg, torch.int32), ("kv_seg", kv_seg, torch.int32)]
    if do is not None:
        if do.shape != q.shape or o.shape != q.shape:
            raise ValueError(f"dO/o shape {tuple(do.shape)}/{tuple(o.shape)} does not fit q {tuple(q.shape)}")
        if tuple(lse.shape) != (b, hq, sq):
            raise ValueError(f"lse must be (B, Hq, Sq) = {(b, hq, sq)}, got {tuple(lse.shape)}")
        tensors += [("dO", do, torch.bfloat16), ("o", o, torch.bfloat16), ("lse", lse, torch.float32)]
    for name, t, dtype in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


# ---------------------------------------------------------------------------
# range tables and tile skip
# ---------------------------------------------------------------------------


def tile_ranges(seg: torch.Tensor) -> torch.Tensor:
    """(B, S) segment ids -> int32 (B, ceil(S / RANGE_TILE), 2): the smallest
    and largest nonzero id of each tile, (INT32_MAX, INT32_MIN) where the tile
    holds padding only."""
    b, s = seg.shape
    n = -(-s // RANGE_TILE)
    tiles = torch.zeros((b, n * RANGE_TILE), dtype=torch.int64, device=seg.device)
    tiles[:, :s] = seg
    tiles = tiles.reshape(b, n, RANGE_TILE)
    live = tiles != 0
    lo = torch.where(live, tiles, INT32_MAX).amin(-1)
    hi = torch.where(live, tiles, INT32_MIN).amax(-1)
    return torch.stack([lo, hi], dim=-1).to(torch.int32).contiguous()


def live_tile_pairs(q_rng: torch.Tensor, kv_rng: torch.Tensor, causal: bool) -> torch.Tensor:
    """Bool (B, nQt, nKt): the (q tile, kv tile) pairs the backward kernels
    run -- ranges that intersect and, when causal, kv tile <= q tile."""
    lo = torch.maximum(q_rng[:, :, None, 0], kv_rng[:, None, :, 0])
    hi = torch.minimum(q_rng[:, :, None, 1], kv_rng[:, None, :, 1])
    live = lo <= hi
    if causal:
        nq, nk = q_rng.shape[1], kv_rng.shape[1]
        live &= torch.ones((nq, nk), dtype=torch.bool, device=live.device).tril()
    return live


def _coarse_ranges(rng: torch.Tensor, rows: int) -> torch.Tensor:
    """A range table of RANGE_TILE-row tiles -> the table of ``rows``-row tiles
    (a multiple of RANGE_TILE): each the union of its RANGE_TILE-row ranges."""
    b, n, _ = rng.shape
    per = rows // RANGE_TILE
    m = -(-n // per)
    lo = torch.full((b, m * per), INT32_MAX, dtype=torch.int32, device=rng.device)
    hi = torch.full((b, m * per), INT32_MIN, dtype=torch.int32, device=rng.device)
    lo[:, :n], hi[:, :n] = rng[..., 0], rng[..., 1]
    return torch.stack([lo.reshape(b, m, per).amin(-1), hi.reshape(b, m, per).amax(-1)], dim=-1)


def fwd_live_tiles(
    q_rng: torch.Tensor, kv_rng: torch.Tensor, causal: bool, causal_offset: int, sq: int, skv: int,
    q_rows: int = FWD_Q_ROWS, kv_rows: int = FWD_KV_ROWS,
) -> torch.Tensor:
    """Bool (B, ceil(sq / q_rows), ceil(skv / kv_rows)): the (q tile, kv tile)
    pairs the forward kernel runs -- ranges that intersect and, when causal, a
    kv tile that starts at or before the diagonal of the q tile's last row
    (``kv_start <= causal_offset + min(q_end, sq) - 1``)."""
    if q_rows % RANGE_TILE or kv_rows % RANGE_TILE:
        raise ValueError(f"tile rows must be multiples of {RANGE_TILE}")
    if q_rng.shape[1] != -(-sq // RANGE_TILE) or kv_rng.shape[1] != -(-skv // RANGE_TILE):
        raise ValueError("range tables do not fit sq / skv")
    qr, kr = _coarse_ranges(q_rng, q_rows), _coarse_ranges(kv_rng, kv_rows)
    live = (torch.maximum(qr[:, :, None, 0], kr[:, None, :, 0])
            <= torch.minimum(qr[:, :, None, 1], kr[:, None, :, 1]))
    if causal:
        dev = live.device
        last = torch.clamp((torch.arange(qr.shape[1], device=dev) + 1) * q_rows, max=sq) - 1
        start = torch.arange(kr.shape[1], device=dev) * kv_rows
        live &= start[None, :] <= causal_offset + last[:, None]
    return live


def _launch_ranges(q_seg: torch.Tensor, kv_seg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The range tables of q_seg and kv_seg on the card (``st_flash_ranges``);
    ``tile_ranges`` is its plain version. ``flash_fwd`` launches the same
    kernel ahead of every forward from its own C call and adds to this
    function's count."""
    b, sq = q_seg.shape
    skv = kv_seg.shape[1]
    q_rng = torch.empty((b, -(-sq // RANGE_TILE), 2), dtype=torch.int32, device=q_seg.device)
    kv_rng = torch.empty((b, -(-skv // RANGE_TILE), 2), dtype=torch.int32, device=q_seg.device)
    with torch.cuda.device(q_seg.device):
        rc = csrc.library().st_flash_ranges(
            q_seg.data_ptr(), kv_seg.data_ptr(), q_rng.data_ptr(), kv_rng.data_ptr(), b, sq, skv,
            torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "flash range tables")
    _launch_ranges.launches += 1
    return q_rng, kv_rng


_launch_ranges.launches = 0


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_seg: torch.Tensor, kv_seg: torch.Tensor,
    *, causal: bool, scale: float, causal_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) through the CUDA kernels for CUDA tensors (the range tables,
    then the forward, from one C call; each counts its launch), the plain
    version for CPU tensors."""
    if not q.is_cuda:
        return flash_fwd_plain(
            q, k, v, q_seg, kv_seg, causal=causal, scale=scale, causal_offset=causal_offset
        )
    _check_cuda_inputs(q, k, v, q_seg, kv_seg)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    # the range tables of q_seg, then of kv_seg: one buffer, written by the first of the C call's two launches
    ranges = torch.empty((b * (-(-sq // RANGE_TILE) - (-skv // RANGE_TILE)), 2), dtype=torch.int32,
                         device=q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = csrc.library().st_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(),
            ranges.data_ptr(), o.data_ptr(), lse.data_ptr(), b, sq, skv, hq, hkv, d,
            int(causal), int(causal_offset), float(scale), torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "flash forward")
    _launch_ranges.launches += 1
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def flash_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_seg: torch.Tensor, kv_seg: torch.Tensor,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference backward: the kernels' arithmetic in fp32 tensor ops from
    (q, k, v, o, lse, dO) -- ``p = exp(scale q.k - lse)`` SELECTED to 0 outside
    the mask (a fully masked row has lse = -1e30; a multiplied mask would give
    NaN there), ``delta = rowsum(dO * o)``, ``ds = p (dO.v - delta)``, the
    three products, and the sum over the G query heads of a kv group.
    Returns (dq, dk, dv) in the dtypes of (q, k, v)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    kf, vf = k.float(), v.float()
    qg = q.reshape(b, sq, hkv, g, d).float() * scale
    dog = do.reshape(b, sq, hkv, g, d).float()
    delta = (dog * o.reshape(b, sq, hkv, g, d).float()).sum(-1)       # (B, Sq, Hkv, G)
    delta = delta.permute(0, 2, 3, 1)[..., None]                       # (B, Hkv, G, Sq, 1)
    mask = make_attention_mask(q_seg, kv_seg, causal)[:, None, None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, g, sq, 1)), 0.0)
    del s
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dog, vf) - delta)
    del p
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_prep_plain(do: torch.Tensor, o: torch.Tensor, q_seg: torch.Tensor, kv_seg: torch.Tensor):
    """The pre-pass in tensor ops: (delta (B, Hq, Sq) fp32, q ranges, kv ranges)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return delta, tile_ranges(q_seg), tile_ranges(kv_seg)


def dkv_splits(b: int, skv: int, hkv: int, g: int, n_sms: int) -> Tuple[int, int]:
    """(n_split, heads_per_split) of the dK/dV grid: the G heads of a kv group
    are cut into splits (powers of two, at most G) until the grid holds two
    CTAs per SM, so a short batch (text rows: 128 CTAs) still fills the card."""
    ctas = -(-skv // DKV_ROWS) * hkv * b
    n = 1
    while n < g and ctas * n < 2 * n_sms:
        n *= 2
    per = -(-g // min(n, g))
    return -(-g // per), per


def _launch_bwd_prep(do, o, q_seg, kv_seg):
    b, sq, hq, d = do.shape
    skv = kv_seg.shape[1]
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=do.device)
    q_rng = torch.empty((b, -(-sq // RANGE_TILE), 2), dtype=torch.int32, device=do.device)
    kv_rng = torch.empty((b, -(-skv // RANGE_TILE), 2), dtype=torch.int32, device=do.device)
    with torch.cuda.device(do.device):
        rc = csrc.library().st_flash_bwd_prep(
            do.data_ptr(), o.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), delta.data_ptr(),
            q_rng.data_ptr(), kv_rng.data_ptr(), b, sq, skv, hq, d,
            torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "flash backward pre-pass")
    _launch_bwd_prep.launches += 1
    return delta, q_rng, kv_rng


def _launch_bwd_dq(q, k, v, do, lse, delta, q_seg, kv_seg, q_rng, kv_rng, causal, scale) -> torch.Tensor:
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = csrc.library().st_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), q_rng.data_ptr(), kv_rng.data_ptr(),
            dq.data_ptr(), b, sq, skv, hq, hkv, d, int(causal), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "flash backward dQ")
    _launch_bwd_dq.launches += 1
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, q_rng, kv_rng, causal, scale):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    n_split, per = dkv_splits(b, skv, hkv, hq // hkv,
                              torch.cuda.get_device_properties(q.device).multi_processor_count)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # fp32 partials of the head splits, summed in split order by the kernel's second pass
    part_dk = part_dv = None
    if n_split > 1:
        part_dk, part_dv = torch.empty((2, n_split) + tuple(k.shape), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = csrc.library().st_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), q_rng.data_ptr(), kv_rng.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), part_dk.data_ptr() if n_split > 1 else None,
            part_dv.data_ptr() if n_split > 1 else None,
            b, sq, skv, hq, hkv, d, n_split, per, int(causal), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "flash backward dK/dV")
    _launch_bwd_dkv.launches += 1
    return dk, dv


_launch_bwd_prep.launches = 0
_launch_bwd_dq.launches = 0
_launch_bwd_dkv.launches = 0


def flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_seg: torch.Tensor, kv_seg: torch.Tensor,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through the three CUDA kernels (pre-pass, dQ, dK/dV) for
    CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, q_seg, kv_seg, o, lse, do, causal=causal, scale=scale)
    _check_cuda_inputs(q, k, v, q_seg, kv_seg, do=do, o=o, lse=lse)
    delta, q_rng, kv_rng = _launch_bwd_prep(do, o, q_seg, kv_seg)
    args = (q, k, v, do, lse, delta, q_seg, kv_seg, q_rng, kv_rng, causal, scale)
    dq = _launch_bwd_dq(*args)
    dk, dv = _launch_bwd_dkv(*args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward = ``flash_fwd`` (saves q, k, v, segment ids, o, lse), backward =
    ``flash_bwd``. Segment ids are integer tensors and get no gradient; the
    non-tensor arguments return None."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale, causal_offset):
        o, lse = flash_fwd(q, k, v, q_seg, kv_seg, causal=causal, scale=scale,
                           causal_offset=causal_offset)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, o, lse)
        ctx.causal, ctx.scale, ctx.causal_offset = causal, scale, causal_offset
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.causal_offset:
            raise NotImplementedError(
                "flash backward with causal_offset (chunked-prefill cross attention) "
                "is inference-only"
            )
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, q_seg, kv_seg, o, lse, do.contiguous(),
                               causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_seg: torch.Tensor, kv_seg: torch.Tensor,
    *, causal: bool, scale: float, causal_offset: int = 0,
) -> torch.Tensor:
    """Differentiable attention output (B, Sq, Hq, D)."""
    return _FlashAttention.apply(q, k, v, q_seg, kv_seg, bool(causal), float(scale),
                                 int(causal_offset))
