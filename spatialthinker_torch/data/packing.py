"""Pack per-sample vision patches into one static-shape ``VisionInputs`` for
the batch, with bucketed padding. A copy of ``pack_vision_batch`` and
``bucket_size`` from ``spatialthinker_tpu/data/packing.py``, unchanged in
behaviour (that module imports the JAX model package)."""

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
