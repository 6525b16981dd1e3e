"""Rows -> tokenized, image-processed, position-id-annotated samples, collated
into a ``RolloutBatch``.

A copy of the row->item and collate logic of
``spatialthinker_tpu/data/dataset.py`` (``RLHFDataset.__getitem__``,
``collate_fn``), unchanged in behaviour, for in-memory rows (the eval
provider's path); that module imports the JAX model package. Loading
parquet/HF sources, the shuffling (threaded) loader and ``limit_images``
are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.batch import RolloutBatch
from ..core.config import DataConfig
from ..models.qwen2_5_vl.config import Qwen25VLConfig
from ..models.qwen2_5_vl.host import get_mrope_position_ids
from .image import process_image
from .template import IMAGE_PLACEHOLDER, build_chat_text, normalize_image_placement


class RLHFDataset:
    """Map-style dataset over in-memory rows; __getitem__ returns a dict of
    numpy arrays + strings."""

    def __init__(
        self,
        rows: List[Dict[str, Any]],
        tokenizer,
        config: DataConfig,
        model_config: Qwen25VLConfig,
        system_prompt: Optional[str] = None,
    ):
        self.tokenizer = tokenizer
        self.config = config
        self.model_config = model_config
        self.system_prompt = system_prompt
        self.rows = rows
        self.prompt_key = config.prompt_key
        self.answer_key = config.answer_key
        self.image_key = config.image_key
        self.format_prompt = config.format_prompt

    @classmethod
    def from_rows(cls, rows, tokenizer, config, model_config, system_prompt=None):
        return cls(rows, tokenizer, config, model_config, system_prompt)

    def __len__(self) -> int:
        return len(self.rows)

    def _images_for_row(self, row, index: int) -> List[Any]:
        if self.config.text_only:
            return []
        if self.config.mixed_data and index % 2 == 0:
            return []
        images = row.get(self.image_key)
        if images is None:
            return []
        if not isinstance(images, (list, tuple)):
            images = [images]
        return list(images)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        row = dict(self.rows[index])
        prompt = str(row[self.prompt_key])
        if self.format_prompt:
            prompt = prompt + " " + self.format_prompt.strip()

        images = self._images_for_row(row, index)
        mc = self.model_config
        vc = mc.vision

        patch_list, grids, merged_counts = [], [], []
        for img in images:
            patches, grid = process_image(
                img, self.config.min_pixels, self.config.max_pixels,
                patch_size=vc.patch_size, merge_size=vc.spatial_merge_size,
                temporal_patch_size=vc.temporal_patch_size,
            )
            patch_list.append(patches)
            grids.append(grid)
            merged_counts.append(int(np.prod(grid)) // vc.spatial_merge_unit)

        if images:
            prompt_text = normalize_image_placement(
                prompt if IMAGE_PLACEHOLDER in prompt else IMAGE_PLACEHOLDER + prompt,
                len(images),
            )
        else:
            prompt_text = prompt.replace(IMAGE_PLACEHOLDER, "")

        chat_text = build_chat_text(prompt_text, merged_counts, system_prompt=self.system_prompt)
        input_ids = np.asarray(self.tokenizer.encode(chat_text), dtype=np.int32)

        # truncate from the left (keep generation-prompt tail) if over budget
        max_len = self.config.max_prompt_length
        if input_ids.shape[0] > max_len:
            input_ids = input_ids[-max_len:]

        grid_arr = np.asarray(grids, dtype=np.int64) if grids else None
        position_ids, delta = get_mrope_position_ids(
            input_ids, grid_arr,
            spatial_merge_size=vc.spatial_merge_size,
            image_token_id=mc.image_token_id,
            video_token_id=mc.video_token_id,
            vision_start_token_id=mc.vision_start_token_id,
            tokens_per_second=vc.tokens_per_second,
        )
        gen_pos_start = int(position_ids.max()) + 1

        # left pad
        pad = max_len - input_ids.shape[0]
        padded_ids = np.full((max_len,), mc.pad_token_id, dtype=np.int32)
        padded_ids[pad:] = input_ids
        segment = np.zeros((max_len,), dtype=np.int32)
        segment[pad:] = 1
        padded_pos = np.ones((3, max_len), dtype=np.int32)
        padded_pos[:, pad:] = position_ids

        return {
            "input_ids": padded_ids,
            "segment_ids": segment,
            "position_ids": padded_pos,
            "gen_pos_start": np.int32(gen_pos_start),
            "raw_prompt_ids": input_ids,
            "patches": np.concatenate(patch_list, axis=0) if patch_list else None,
            "image_grid_thw": grid_arr,
            "ground_truth": str(row.get(self.answer_key, "")),
            "problem": prompt,
        }


def collate_fn(items: Sequence[Dict[str, Any]]) -> RolloutBatch:
    """Stack fixed-shape arrays; keep ragged payloads as object arrays."""
    tensors = {
        "input_ids": np.stack([it["input_ids"] for it in items]),
        "segment_ids": np.stack([it["segment_ids"] for it in items]),
        "position_ids": np.stack([it["position_ids"] for it in items]),  # (B, 3, P)
        "gen_pos_start": np.asarray([it["gen_pos_start"] for it in items], dtype=np.int32),
    }
    non_tensors = {
        "raw_prompt_ids": _obj([it["raw_prompt_ids"] for it in items]),
        "patches": _obj([it["patches"] for it in items]),
        "image_grid_thw": _obj([it["image_grid_thw"] for it in items]),
        "ground_truth": _obj([it["ground_truth"] for it in items]),
        "problem": _obj([it["problem"] for it in items]),
    }
    return RolloutBatch(tensors=tensors, non_tensors=non_tensors)


def _obj(values: List[Any]) -> np.ndarray:
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr
