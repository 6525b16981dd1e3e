"""Sequence packing for the training path (padding-free batching). The port's
own copy of ``spatialthinker_tpu/data/text_packing.py``: host code on numpy
arrays, unchanged in behaviour.

First-fit-decreasing bin-packing of each sample's valid tokens (prompt tail +
response head) into fixed-length rows with per-sample segment ids: attention
keeps a static shape, the flash kernels' segment masking keeps samples
independent, and padded positions all but disappear.

Per-token response quantities (old/ref log-probs, advantages) are scattered
onto each response token's PREDICTION slot (the position whose hidden state
predicts it, one to the left), so the packed loss is computed directly on
(rows, L) arrays with a loss mask -- token-weighted masked means make it
numerically identical to the unpacked loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class PackedRows(NamedTuple):
    input_ids: np.ndarray      # (rows, L)
    segment_ids: np.ndarray    # (rows, L) 0 pad, 1..k per sample within a row
    position_ids: np.ndarray   # (3, rows, L) mRoPE carried from the samples
    labels: np.ndarray         # (rows, L) next-token labels (0 where unused)
    loss_mask: np.ndarray      # (rows, L) 1 on response prediction slots
    old_log_probs: np.ndarray  # (rows, L)
    ref_log_probs: np.ndarray  # (rows, L)
    advantages: np.ndarray     # (rows, L)


@dataclass
class SlotMap:
    """Where each sample landed: used to gather packed per-position values
    back to (B, R) response layout."""

    row: np.ndarray          # (B,)
    dst_start: np.ndarray    # (B,) offset of the sample's first valid token
    prompt_len: np.ndarray   # (B,) valid prompt tokens
    resp_len: np.ndarray     # (B,) valid response tokens
    num_rows: int
    row_len: int

    def response_slot_indices(self, i: int) -> Tuple[int, np.ndarray]:
        """(row, positions) of sample i's response PREDICTION slots."""
        start = int(self.dst_start[i] + self.prompt_len[i] - 1)
        return int(self.row[i]), start + np.arange(int(self.resp_len[i]))


def pack_train_rows(
    input_ids: np.ndarray,       # (B, P) left-padded prompts
    segment_ids: np.ndarray,     # (B, P)
    position_ids: np.ndarray,    # (B, 3, P)
    responses: np.ndarray,       # (B, R)
    response_mask: np.ndarray,   # (B, R)
    gen_pos_start: np.ndarray,   # (B,)
    per_token: Optional[Dict[str, np.ndarray]] = None,  # each (B, R)
    row_len: int = 4096,
) -> Tuple[PackedRows, SlotMap]:
    b, p = input_ids.shape
    r = responses.shape[1]
    prompt_lens = segment_ids.sum(-1).astype(np.int64)
    resp_lens = response_mask.sum(-1).astype(np.int64)
    totals = prompt_lens + resp_lens
    if totals.max() > row_len:
        raise ValueError(f"sample of {int(totals.max())} tokens exceeds row_len {row_len}")

    # first-fit-decreasing
    order = np.argsort(-totals)
    rows: List[int] = []  # used length per row
    assign_row = np.zeros(b, dtype=np.int64)
    assign_off = np.zeros(b, dtype=np.int64)
    for i in order:
        need = int(totals[i])
        for ridx in range(len(rows)):
            if rows[ridx] + need <= row_len:
                assign_row[i] = ridx
                assign_off[i] = rows[ridx]
                rows[ridx] += need
                break
        else:
            assign_row[i] = len(rows)
            assign_off[i] = 0
            rows.append(need)
    num_rows = len(rows)

    L = row_len
    out_ids = np.zeros((num_rows, L), dtype=input_ids.dtype)
    out_seg = np.zeros((num_rows, L), dtype=np.int32)
    out_pos = np.ones((3, num_rows, L), dtype=position_ids.dtype)
    labels = np.zeros((num_rows, L), dtype=input_ids.dtype)
    loss_mask = np.zeros((num_rows, L), dtype=np.float32)
    per_token = per_token or {}
    scattered = {k: np.zeros((num_rows, L), dtype=np.float32) for k in
                 ("old_log_probs", "ref_log_probs", "advantages")}
    seg_counter = np.zeros(num_rows, dtype=np.int32)

    for i in range(b):
        ridx, off = int(assign_row[i]), int(assign_off[i])
        pl, rl = int(prompt_lens[i]), int(resp_lens[i])
        seg_counter[ridx] += 1
        seg_id = int(seg_counter[ridx])

        tokens = np.concatenate([input_ids[i, p - pl :], responses[i, :rl]])
        out_ids[ridx, off : off + pl + rl] = tokens
        out_seg[ridx, off : off + pl + rl] = seg_id
        out_pos[:, ridx, off : off + pl] = position_ids[i, :, p - pl :]
        gen_positions = gen_pos_start[i] + np.arange(rl)
        out_pos[:, ridx, off + pl : off + pl + rl] = gen_positions[None, :]

        # prediction slots: position j predicts tokens[j+1] within the sample
        labels[ridx, off : off + pl + rl - 1] = tokens[1:]
        pred_start = off + pl - 1
        loss_mask[ridx, pred_start : pred_start + rl] = 1.0
        for key, arr in per_token.items():
            scattered[key][ridx, pred_start : pred_start + rl] = arr[i, :rl]

    packed = PackedRows(
        input_ids=out_ids,
        segment_ids=out_seg,
        position_ids=out_pos,
        labels=labels,
        loss_mask=loss_mask,
        old_log_probs=scattered["old_log_probs"],
        ref_log_probs=scattered["ref_log_probs"],
        advantages=scattered["advantages"],
    )
    slot_map = SlotMap(
        row=assign_row, dst_start=assign_off, prompt_len=prompt_lens,
        resp_len=resp_lens, num_rows=num_rows, row_len=row_len,
    )
    return packed, slot_map


def gather_response_values(
    packed_values: np.ndarray,  # (rows, L)
    slot_map: SlotMap,
    response_length: int,
) -> np.ndarray:
    """Packed per-position values -> (B, R) response layout (0 where padded)."""
    b = slot_map.row.shape[0]
    out = np.zeros((b, response_length), dtype=np.asarray(packed_values).dtype)
    for i in range(b):
        ridx, slots = slot_map.response_slot_indices(i)
        out[i, : slots.shape[0]] = packed_values[ridx, slots]
    return out


def pad_rows_to_multiple(packed: PackedRows, multiple: int) -> PackedRows:
    """Pad the row count so it divides the micro-batch/device layout."""
    rows = packed.input_ids.shape[0]
    return pad_rows_to_count(packed, rows + (-rows) % multiple)


def pad_rows_to_count(packed: PackedRows, count: int) -> PackedRows:
    """Pad with empty rows (segment ids 0 -> masked everywhere) up to
    ``count``."""
    pad = count - packed.input_ids.shape[0]
    if pad <= 0:
        return packed
    def padrow(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        if x.ndim == 3:  # position_ids (3, rows, L)
            widths = [(0, 0), (0, pad), (0, 0)]
        return np.pad(x, widths)
    return PackedRows(*[padrow(np.asarray(x)) for x in packed])
