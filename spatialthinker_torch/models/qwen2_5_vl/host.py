"""Host-side (numpy) helpers of the Qwen2.5-VL slice.

Copies of the framework-free helpers of the JAX package, unchanged in
behaviour (tests/test_torch_host.py pins them equal to the originals): the
JAX modules that hold them import jax at module top, so the port cannot
import them. Sources: ``get_mrope_position_ids`` from
``spatialthinker_tpu/models/qwen2_5_vl/rope.py``; ``VisionAux``,
``prepare_vision_aux``, ``apply_patch_layout``, ``window_patch_len``,
``layout_patch_count`` and ``pad_vision_inputs`` from ``vision.py``;
``VisionInputs`` from ``model.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .config import VisionConfig


class VisionInputs(NamedTuple):
    """Static-shape packed vision inputs (see ``prepare_vision_aux``): numpy
    arrays from the host packer, torch tensors once moved to the device
    (``model.vision_to_device``)."""

    patches: Any        # (N, C*T*P*P)
    pos_ids: Any        # (N, 2)
    seg_full: Any       # (N,)
    seg_window: Any     # (N,)
    reverse_index: Any  # (R,): N/unit, or more where a training pack repeats a shared image's slots


def get_mrope_position_ids(
    input_ids: np.ndarray,  # (seqlen,) — one sample, already attention-masked
    image_grid_thw: Optional[np.ndarray],  # (num_images, 3)
    *,
    spatial_merge_size: int,
    image_token_id: int,
    video_token_id: int,
    vision_start_token_id: int,
    tokens_per_second: int = 2,
    video_grid_thw: Optional[np.ndarray] = None,
    second_per_grid_ts: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int]:
    """Returns ((3, seqlen) position ids, mrope_delta).

    mrope_delta = (max position id + 1) - seqlen; decode continues text
    positions from max+1, so new tokens at sequence index i take position
    i + delta.
    """
    input_ids = np.asarray(input_ids)
    seqlen = input_ids.shape[0]
    if image_grid_thw is None and video_grid_thw is None:
        pos = np.arange(seqlen, dtype=np.int64)
        return np.tile(pos, (3, 1)), 0

    vision_starts = np.flatnonzero(input_ids == vision_start_token_id)
    next_tokens = input_ids[np.minimum(vision_starts + 1, seqlen - 1)]
    image_nums = int(np.sum(next_tokens == image_token_id))
    video_nums = int(np.sum(next_tokens == video_token_id))

    tokens = input_ids.tolist()
    pos_chunks = []
    st = 0
    image_index, video_index = 0, 0
    remain_images, remain_videos = image_nums, video_nums

    def _find(token_id, start):
        try:
            return tokens.index(token_id, start)
        except ValueError:
            return len(tokens) + 1

    for _ in range(image_nums + video_nums):
        ed_image = _find(image_token_id, st) if remain_images > 0 else len(tokens) + 1
        ed_video = _find(video_token_id, st) if remain_videos > 0 else len(tokens) + 1
        if ed_image < ed_video:
            t, h, w = (int(x) for x in image_grid_thw[image_index])
            second_per_grid_t = 0.0
            image_index += 1
            remain_images -= 1
            ed = ed_image
        else:
            t, h, w = (int(x) for x in video_grid_thw[video_index])
            if second_per_grid_ts is not None:
                second_per_grid_t = float(second_per_grid_ts[video_index])
            else:
                second_per_grid_t = 1.0
            video_index += 1
            remain_videos -= 1
            ed = ed_video

        llm_t = t
        llm_h = h // spatial_merge_size
        llm_w = w // spatial_merge_size
        text_len = ed - st
        st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
        if text_len > 0:
            text_pos = np.arange(text_len, dtype=np.int64) + st_idx
            pos_chunks.append(np.tile(text_pos, (3, 1)))

        t_index = (
            (np.arange(llm_t, dtype=np.float64)[:, None] * second_per_grid_t * tokens_per_second)
            .astype(np.int64)
            .repeat(llm_h * llm_w, axis=1)
            .reshape(-1)
        )
        h_index = np.tile(np.repeat(np.arange(llm_h, dtype=np.int64), llm_w), llm_t)
        w_index = np.tile(np.arange(llm_w, dtype=np.int64), llm_t * llm_h)
        pos_chunks.append(np.stack([t_index, h_index, w_index]) + text_len + st_idx)
        st = ed + llm_t * llm_h * llm_w

    if st < len(tokens):
        st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
        text_len = len(tokens) - st
        text_pos = np.arange(text_len, dtype=np.int64) + st_idx
        pos_chunks.append(np.tile(text_pos, (3, 1)))

    positions = np.concatenate(pos_chunks, axis=1)
    delta = int(positions.max()) + 1 - seqlen
    return positions, delta


@dataclass
class VisionAux:
    """Everything the device tower needs besides the pixels, in the
    UNIFORM-WINDOW layout: every window occupies exactly
    spatial_merge_unit * vit_window^2 consecutive patch slots (image-edge
    windows are padded in place), so windowed blocks run as a dense
    (num_windows, window_len, ...) batched attention with no cross-window
    masking — the TPU-shaped replacement for variable-size window segments."""

    patch_perm: np.ndarray     # (N',) source patch index per layout slot, -1 = pad
    pos_ids: np.ndarray        # (N', 2) h/w rotary ids (0 on pads)
    seg_full: np.ndarray       # (N',) frame id per slot (full-attn blocks), 0 on pads
    seg_window: np.ndarray     # (N',) window id per slot, 0 on pads
    reverse_index: np.ndarray  # (num_merged_natural,) layout merged slot per natural position
    num_patches: int           # N' = layout size (incl. intra-window pads)
    num_merged: int            # natural merged token count (pre-padding)


def prepare_vision_aux(grid_thw: Sequence[Tuple[int, int, int]], cfg: VisionConfig) -> VisionAux:
    """Compute the uniform-window layout + segment ids + rotary pos ids for a
    batch of images (all concatenated into one packed vision sequence)."""
    merge = cfg.spatial_merge_size
    unit = cfg.spatial_merge_unit
    win = cfg.window_size // merge // cfg.patch_size

    merged_src_parts: List[np.ndarray] = []  # layout -> natural merged idx (-1 pad)
    window_counts: List[int] = []            # windows per image (x frames)
    frame_of_merged_parts: List[np.ndarray] = []
    pos_ids_natural: List[np.ndarray] = []
    merged_offset = 0
    frame_id = 0
    frame_of_layout_parts: List[np.ndarray] = []
    for t, h, w in grid_thw:
        t, h, w = int(t), int(h), int(w)
        llm_h, llm_w = h // merge, w // merge
        index = np.arange(t * llm_h * llm_w).reshape(t, llm_h, llm_w)
        pad_h = (-llm_h) % win
        pad_w = (-llm_w) % win
        index = np.pad(index, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-1)
        nh, nw = (llm_h + pad_h) // win, (llm_w + pad_w) // win
        index = index.reshape(t, nh, win, nw, win).transpose(0, 1, 3, 2, 4)
        flat = index.reshape(-1)  # (t * nh * nw * win * win,), -1 on pads
        merged_src_parts.append(np.where(flat >= 0, flat + merged_offset, -1))
        window_counts.append(t * nh * nw)
        # frame id for every layout merged slot of this image (valid slots only)
        frames = np.repeat(np.arange(frame_id + 1, frame_id + t + 1), nh * nw * win * win)
        frame_of_layout_parts.append(np.where(flat >= 0, frames, 0))
        frame_id += t
        merged_offset += t * llm_h * llm_w

        # h/w position ids in NATURAL patch order, grouped by merge blocks
        # (patch rows inside a merged 2x2 block are consecutive).
        hpos = np.arange(h).reshape(h, 1).repeat(w, axis=1)
        wpos = np.arange(w).reshape(1, w).repeat(h, axis=0)

        def _block_order(x):
            x = x.reshape(h // merge, merge, w // merge, merge)
            return x.transpose(0, 2, 1, 3).reshape(-1)

        per_frame = np.stack([_block_order(hpos), _block_order(wpos)], axis=-1)
        pos_ids_natural.append(np.tile(per_frame, (t, 1)))

    merged_src = np.concatenate(merged_src_parts)        # (layout_merged,)
    frame_of_layout = np.concatenate(frame_of_layout_parts)
    pos_natural = np.concatenate(pos_ids_natural)        # (N_natural, 2)
    num_merged = merged_offset
    layout_merged = merged_src.shape[0]
    num_patches = layout_merged * unit

    # patch-level source map: merged slot expands to `unit` consecutive patches
    patch_src = np.where(
        merged_src[:, None] >= 0,
        merged_src[:, None] * unit + np.arange(unit)[None, :],
        -1,
    ).reshape(-1)

    pos_ids = np.zeros((num_patches, 2), dtype=np.int64)
    valid = patch_src >= 0
    pos_ids[valid] = pos_natural[patch_src[valid]]

    seg_full = np.repeat(frame_of_layout, unit)

    # window ids: every window is exactly win*win merged slots, consecutive
    total_windows = sum(window_counts)
    seg_window_merged = np.repeat(np.arange(1, total_windows + 1), win * win)
    seg_window = np.repeat(np.where(merged_src >= 0, seg_window_merged, 0), unit)

    # natural merged position m lives at layout slot reverse_index[m]
    reverse_index = np.zeros(num_merged, dtype=np.int64)
    layout_positions = np.arange(layout_merged)
    sel = merged_src >= 0
    reverse_index[merged_src[sel]] = layout_positions[sel]

    return VisionAux(
        patch_perm=patch_src.astype(np.int32),
        pos_ids=pos_ids.astype(np.int32),
        seg_full=seg_full.astype(np.int32),
        seg_window=seg_window.astype(np.int32),
        reverse_index=reverse_index.astype(np.int32),
        num_patches=num_patches,
        num_merged=num_merged,
    )


def apply_patch_layout(patches: np.ndarray, aux: VisionAux) -> np.ndarray:
    """Scatter natural-order patch rows into the uniform-window layout
    (pad slots zero)."""
    out = np.zeros((aux.patch_perm.shape[0], patches.shape[1]), dtype=patches.dtype)
    valid = aux.patch_perm >= 0
    out[valid] = patches[aux.patch_perm[valid]]
    return out


def window_patch_len(cfg: VisionConfig) -> int:
    win = cfg.window_size // cfg.spatial_merge_size // cfg.patch_size
    return cfg.spatial_merge_unit * win * win


def layout_patch_count(grid_thw, cfg: VisionConfig) -> int:
    """Uniform-window layout size (patches) for one image grid."""
    t, h, w = (int(v) for v in grid_thw)
    merge = cfg.spatial_merge_size
    win = cfg.window_size // merge // cfg.patch_size
    llm_h, llm_w = h // merge, w // merge
    nh = -(-llm_h // win)
    nw = -(-llm_w // win)
    return t * nh * nw * win * win * cfg.spatial_merge_unit


def pad_vision_inputs(
    patches: np.ndarray, aux: VisionAux, pad_to: int, merge_unit: int = 4
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad (already permuted) patch rows + aux vectors to a static bucket size.
    Returns (patches, pos_ids, seg_full, seg_window, reverse_index_padded)."""
    n = aux.num_patches
    assert pad_to >= n and pad_to % merge_unit == 0
    pad = pad_to - n
    patches = np.pad(patches, ((0, pad), (0, 0)))
    pos_ids = np.pad(aux.pos_ids, ((0, pad), (0, 0)))
    seg_full = np.pad(aux.seg_full, (0, pad))  # pads with 0 = no attention
    seg_window = np.pad(aux.seg_window, (0, pad))
    merged_pad_to = pad_to // merge_unit
    reverse = np.pad(aux.reverse_index, (0, merged_pad_to - aux.num_merged))
    return patches, pos_ids, seg_full, seg_window, reverse
