"""Sequence-length balancing: Karmarkar–Karp largest-differencing partition of
per-sequence token counts into k equal-count groups, plus a greedy fallback.

Parity with verl/utils/seqlen_balancing.py:97-255. The trainer balances
micro-batch token loads with it before the log-prob and update forwards (the
reference reorders across DP ranks; one process reorders within the global
batch, grouping correctness survives via uid keys)."""

from __future__ import annotations

import heapq
from typing import List, Tuple


def karmarkar_karp(seqlens: List[int], k_partitions: int, equal_size: bool = True) -> List[List[int]]:
    """Partition indices into k groups minimizing the max-sum difference.

    equal_size=False: classic Karmarkar-Karp largest-differencing on k-slot
    states. equal_size=True (the trainer's mode — micro-batch shapes must be
    static): serpentine deal by descending length, then pairwise-swap
    refinement, which guarantees exactly len/k items per group.
    """
    n = len(seqlens)
    if equal_size:
        if n % k_partitions != 0:
            raise ValueError(f"{n} items not divisible into {k_partitions} equal groups")
        return _serpentine_refined(seqlens, k_partitions)

    heap: List[Tuple[int, int, List[Tuple[int, List[int]]]]] = []
    for tie, (length, idx) in enumerate(
        sorted([(l, i) for i, l in enumerate(seqlens)], reverse=True)
    ):
        parts = [(length, [idx])] + [(0, []) for _ in range(k_partitions - 1)]
        heap.append((-length, tie, parts))
    heapq.heapify(heap)
    tiebreak = len(heap)
    while len(heap) > 1:
        _, _, parts_a = heapq.heappop(heap)
        _, _, parts_b = heapq.heappop(heap)
        merged = [
            (sa + sb, ia + ib) for (sa, ia), (sb, ib) in zip(parts_a, reversed(parts_b))
        ]
        merged.sort(reverse=True, key=lambda x: x[0])
        spread = merged[0][0] - merged[-1][0]
        tiebreak += 1
        heapq.heappush(heap, (-spread, tiebreak, merged))
    return [sorted(idx) for _, idx in heap[0][2]]


def _serpentine_refined(seqlens: List[int], k: int, refine_passes: int = 4) -> List[List[int]]:
    order = sorted(range(len(seqlens)), key=lambda i: -seqlens[i])
    groups: List[List[int]] = [[] for _ in range(k)]
    for rank, idx in enumerate(order):
        row, pos = divmod(rank, k)
        g = pos if row % 2 == 0 else k - 1 - pos  # serpentine
        groups[g].append(idx)
    sums = [sum(seqlens[i] for i in g) for g in groups]
    # pairwise swap refinement between heaviest and lightest groups
    for _ in range(refine_passes):
        hi = max(range(k), key=lambda g: sums[g])
        lo = min(range(k), key=lambda g: sums[g])
        if hi == lo:
            break
        gap = sums[hi] - sums[lo]
        best = None
        for ai, a in enumerate(groups[hi]):
            for bi, b in enumerate(groups[lo]):
                delta = seqlens[a] - seqlens[b]
                if 0 < delta < gap:
                    improvement = gap - abs(gap - 2 * delta)
                    if best is None or improvement > best[0]:
                        best = (improvement, ai, bi, delta)
        if best is None:
            break
        _, ai, bi, delta = best
        groups[hi][ai], groups[lo][bi] = groups[lo][bi], groups[hi][ai]
        sums[hi] -= delta
        sums[lo] += delta
    return [sorted(g) for g in groups]


def greedy_partition(seqlens: List[int], k_partitions: int, equal_size: bool = True) -> List[List[int]]:
    """Greedy largest-first into the lightest bin (with size caps when equal)."""
    cap = len(seqlens) // k_partitions if equal_size else len(seqlens)
    bins = [[0, []] for _ in range(k_partitions)]
    for length, idx in sorted([(l, i) for i, l in enumerate(seqlens)], reverse=True):
        eligible = [b for b in bins if len(b[1]) < cap] if equal_size else bins
        best = min(eligible, key=lambda b: b[0])
        best[0] += length
        best[1].append(idx)
    return [sorted(b[1]) for b in bins]


def get_seqlen_balanced_partitions(
    seqlens: List[int], k_partitions: int, equal_size: bool = True
) -> List[List[int]]:
    """KK partition with greedy fallback; every index appears exactly once
    (parity with reference entry point)."""
    if k_partitions > len(seqlens):
        raise ValueError(f"cannot split {len(seqlens)} items into {k_partitions} groups")
    try:
        groups = karmarkar_karp(seqlens, k_partitions, equal_size)
    except Exception:
        groups = greedy_partition(seqlens, k_partitions, equal_size)
    seen = sorted(i for g in groups for i in g)
    assert seen == list(range(len(seqlens))), "partition must cover all indices exactly once"
    return groups


def balance_order(seqlens: List[int], k_partitions: int) -> List[int]:
    """Flattened reorder: concatenated balanced groups (the reference's
    _balance_batch reorder, ray_trainer.py:526-541)."""
    groups = get_seqlen_balanced_partitions(seqlens, k_partitions, equal_size=True)
    return [i for g in groups for i in g]
