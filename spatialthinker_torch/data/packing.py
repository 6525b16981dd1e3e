"""Pack per-sample vision patches into one static-shape ``VisionInputs`` for
the batch, with bucketed padding. A copy of
``spatialthinker_tpu/data/packing.py``, unchanged in behaviour (that module
imports the JAX model package)."""

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


def patch_dim(cfg: VisionConfig) -> int:
    return cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size * cfg.patch_size


def stack_vision_packs(packs: Sequence[Optional[VisionInputs]],
                       cfg: VisionConfig) -> Optional[VisionInputs]:
    """Stack per-micro-batch packs into arrays with a leading micro-batch
    dim, all padded to the widest pack. Returns None if no pack has any image."""
    if all(p is None for p in packs):
        return None
    sizes = [p.patches.shape[0] for p in packs if p is not None]
    pad_to = max(sizes)
    dim = next(p.patches.shape[1] for p in packs if p is not None)
    fixed = []
    for p in packs:
        if p is None:
            fixed.append(empty_vision_pack(cfg, pad_to, dim))
        elif p.patches.shape[0] != pad_to:
            grow = pad_to - p.patches.shape[0]
            merged_grow = pad_to // cfg.spatial_merge_unit - p.reverse_index.shape[0]
            fixed.append(
                VisionInputs(
                    patches=np.pad(p.patches, ((0, grow), (0, 0))),
                    pos_ids=np.pad(p.pos_ids, ((0, grow), (0, 0))),
                    seg_full=np.pad(p.seg_full, (0, grow)),
                    seg_window=np.pad(p.seg_window, (0, grow)),
                    reverse_index=np.pad(p.reverse_index, (0, merged_grow)),
                )
            )
        else:
            fixed.append(p)
    return VisionInputs(*(np.stack([getattr(p, f) for p in fixed]) for f in VisionInputs._fields))
