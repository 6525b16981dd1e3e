"""Pack per-sample vision patches into one static-shape ``VisionInputs`` for
the batch, with bucketed padding. A copy of
``spatialthinker_tpu/data/packing.py``, unchanged in behaviour (that module
imports the JAX model package), plus ``pack_distinct_vision_batch``, the
training path's pack that holds an image its samples share once."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..models.qwen2_5_vl.config import VisionConfig
from ..models.qwen2_5_vl.host import (
    VisionInputs, apply_patch_layout, pad_vision_inputs, prepare_vision_aux, window_patch_len,
)


def bucket_size(n: int, granularity: int = 1024) -> int:
    """Round up to the bucket granularity."""
    return max(granularity, int(math.ceil(n / granularity)) * granularity)


def pack_vision_batch(
    patch_arrays: Sequence[Optional[np.ndarray]],
    grid_arrays: Sequence[Optional[np.ndarray]],
    cfg: VisionConfig,
    granularity: int = 1024,
    pad_to: Optional[int] = None,
) -> Optional[VisionInputs]:
    """Concatenate every image in the batch (sample order, image order) into a
    single packed vision sequence. Returns None if the batch has no images."""
    patches, grids = [], []
    for p, g in zip(patch_arrays, grid_arrays):
        if p is None or g is None or len(g) == 0:
            continue
        patches.append(p)
        grids.extend(tuple(int(v) for v in row) for row in np.asarray(g))
    if not patches:
        return None
    all_patches = np.concatenate(patches, axis=0)
    aux = prepare_vision_aux(grids, cfg)
    layout = apply_patch_layout(all_patches, aux)
    wlen = window_patch_len(cfg)
    if pad_to is None:
        pad_to = bucket_size(aux.num_patches, max(granularity * cfg.spatial_merge_unit, wlen))
    pad_to = -(-pad_to // wlen) * wlen  # whole windows only
    p, pid, sf, sw, rev = pad_vision_inputs(layout, aux, pad_to, cfg.spatial_merge_unit)
    return VisionInputs(
        patches=p.astype(np.float32),
        pos_ids=pid,
        seg_full=sf,
        seg_window=sw,
        reverse_index=rev,
    )


def distinct_images(patch_arrays: Sequence[Optional[np.ndarray]],
                    grid_arrays: Sequence[Optional[np.ndarray]]):
    """The samples' distinct image entries, in order of first use, as
    ``(patches, grid)`` pairs (the grid a tuple of ``(t, h, w)`` rows), and
    each sample with an image's index into them. One entry is one
    ``patches`` array object under one grid: samples that share the object
    share the entry, an equal copy in another object is an entry of its own."""
    slot_of, distinct, uses = {}, [], []
    for p, g in zip(patch_arrays, grid_arrays):
        if p is None or g is None or len(g) == 0:
            continue
        grid = tuple(tuple(int(v) for v in row) for row in np.asarray(g))
        slot = slot_of.setdefault((id(p), grid), len(distinct))
        if slot == len(distinct):
            distinct.append((p, grid))
        uses.append(slot)
    return distinct, uses


def pack_distinct_vision_batch(
    patch_arrays: Sequence[Optional[np.ndarray]],
    grid_arrays: Sequence[Optional[np.ndarray]],
    cfg: VisionConfig,
    granularity: int = 1024,
    pad_to: Optional[int] = None,
) -> Optional[VisionInputs]:
    """``pack_vision_batch`` with each distinct image entry laid out once.
    Samples whose ``patches`` entry is one array object, with equal grids,
    share its slots (GRPO's ``n`` samples of a prompt hold one object); the
    pack lays the distinct entries out in order of first use, under the same
    layout, bucketing and ``pad_to`` rules. ``reverse_index`` has one entry
    per merged image token of the samples, in order, repeats included, so
    the tower runs once per image and the merge is unchanged (its
    ``index_select`` backward sums the samples' gradients); padded to a
    whole bucket of its own, never narrower than the patch width over the
    merge unit. With no entry repeated this is ``pack_vision_batch``'s pack."""
    distinct, uses = distinct_images(patch_arrays, grid_arrays)
    pack = pack_vision_batch([p for p, _ in distinct], [g for _, g in distinct], cfg, granularity, pad_to)
    if len(distinct) == len(uses):
        return pack
    merged = [sum(t * h * w for t, h, w in g) // cfg.spatial_merge_unit for _, g in distinct]
    start = np.concatenate([[0], np.cumsum(merged)])
    reverse = np.concatenate([pack.reverse_index[start[s]:start[s + 1]] for s in uses])
    width = max(bucket_size(len(reverse), granularity), pack.patches.shape[0] // cfg.spatial_merge_unit)
    return pack._replace(reverse_index=np.pad(reverse, (0, width - len(reverse))))


def empty_vision_pack(cfg: VisionConfig, pad_to: int, patch_dim: int) -> VisionInputs:
    """All-padding vision pack (segment id 0 everywhere) for text-only
    micro-batches that must stack with multimodal ones."""
    merged = pad_to // cfg.spatial_merge_unit
    return VisionInputs(
        patches=np.zeros((pad_to, patch_dim), np.float32),
        pos_ids=np.zeros((pad_to, 2), np.int32),
        seg_full=np.zeros((pad_to,), np.int32),
        seg_window=np.zeros((pad_to,), np.int32),
        reverse_index=np.zeros((merged,), np.int32),
    )


def held_patch_count(vision: Optional[VisionInputs]) -> int:
    """The patch rows a vision pack (or a stack of them) holds, bucket and
    window padding left out: each image once a pack."""
    return 0 if vision is None else int(np.count_nonzero(vision.seg_full))


def patch_dim(cfg: VisionConfig) -> int:
    return cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size * cfg.patch_size


def stack_vision_packs(packs: Sequence[Optional[VisionInputs]],
                       cfg: VisionConfig) -> Optional[VisionInputs]:
    """Stack per-micro-batch packs into arrays with a leading micro-batch
    dim, all padded to the widest pack, ``reverse_index`` to the widest
    ``reverse_index``; a None pack is all padding (``empty_vision_pack``).
    Returns None if no pack has any image."""
    present = [p for p in packs if p is not None]
    if not present:
        return None
    pad_to = max(p.patches.shape[0] for p in present)
    rev_to = max(p.reverse_index.shape[0] for p in present)
    out = []
    for field in VisionInputs._fields:
        parts = [getattr(p, field) for p in present]
        width = rev_to if field == "reverse_index" else pad_to
        stacked = np.zeros((len(packs), width, *parts[0].shape[1:]), np.result_type(*parts))
        for i, p in enumerate(packs):
            if p is not None:
                x = getattr(p, field)
                stacked[i, :len(x)] = x
        out.append(stacked)
    return VisionInputs(*out)
