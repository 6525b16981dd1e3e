"""Rows -> tokenized, image-processed, position-id-annotated samples, collated
into a ``RolloutBatch``.

The port's own copy of ``spatialthinker_tpu/data/dataset.py`` (that module
imports the JAX model package), unchanged in behaviour: ``load_rows``
(parquet globs, json/jsonl, hub names with an ``@split`` suffix; the
``datasets`` package is imported only when a path is loaded),
``RLHFDataset`` over a path or in-memory rows, ``collate_fn`` and the
stateful shuffling ``DataLoader`` (one process: no ``process_shard``).
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.batch import RolloutBatch
from ..core.config import DataConfig
from ..models.qwen2_5_vl.config import Qwen25VLConfig
from ..models.qwen2_5_vl.host import get_mrope_position_ids
from .image import process_image
from .template import IMAGE_PLACEHOLDER, build_chat_text, normalize_image_placement


def _parse_files(path: str) -> Tuple[str, Optional[str]]:
    """'name@split' -> (name, split)."""
    if "@" in path:
        name, _, split = path.rpartition("@")
        return name, split
    return path, None


def load_rows(path: str):
    """Load rows from a local parquet glob, a json / jsonl file or a hub dataset."""
    import datasets

    name, split = _parse_files(path)
    if os.path.isdir(name) or name.endswith(".parquet") or glob.glob(os.path.join(name, "*.parquet")):
        files = [name] if name.endswith(".parquet") else sorted(
            glob.glob(os.path.join(name, f"{split or 'train'}-*.parquet"))
            or glob.glob(os.path.join(name, "*.parquet"))
        )
        return datasets.load_dataset("parquet", data_files=files, split="train")
    if name.endswith(".json") or name.endswith(".jsonl"):
        return datasets.load_dataset("json", data_files=name, split="train")
    return datasets.load_dataset(name, split=split or "train")


class RLHFDataset:
    """Map-style dataset; __getitem__ returns a dict of numpy arrays + strings."""

    def __init__(
        self,
        data_path: Optional[str],
        tokenizer,
        config: DataConfig,
        model_config: Qwen25VLConfig,
        system_prompt: Optional[str] = None,
        rows: Optional[List[Dict[str, Any]]] = None,
        limit_images: int = 0,
    ):
        self.tokenizer = tokenizer
        # __getitem__ runs concurrently on the loader's pool threads, and a
        # fast tokenizer's backend is not thread-safe; encoding is cheap next
        # to image patchify, so a lock is enough
        self._tokenizer_lock = threading.Lock()
        self.config = config
        self.model_config = model_config
        self.system_prompt = system_prompt
        self.rows = rows if rows is not None else load_rows(data_path)
        self.prompt_key = config.prompt_key
        self.answer_key = config.answer_key
        self.image_key = config.image_key
        self.format_prompt = config.format_prompt
        self.limit_images = limit_images  # 0 = unlimited (rollout.limit_images)

    @classmethod
    def from_rows(cls, rows, tokenizer, config, model_config, system_prompt=None):
        return cls(None, tokenizer, config, model_config, system_prompt, rows=rows)

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
        images = list(images)
        if self.limit_images > 0:
            images = images[: self.limit_images]
        return images

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
        with self._tokenizer_lock:
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


class DataLoader:
    """Stateful shuffling loader with checkpointable iteration state (parity:
    the reference's 8-worker StatefulDataLoader, ray_trainer.py:241-265 and
    :483-524). ``num_workers`` > 0 prefetches: __getitem__ (smart-resize +
    patchify, pure numpy/PIL) runs on a thread pool and ``prefetch_batches``
    collated batches are staged ahead, so host-side image prep overlaps the
    device step instead of sitting on the trainer thread between steps."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 1,
                 drop_last: bool = True, num_workers: int = 0, prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_batches = max(1, prefetch_batches)
        self.epoch = 0
        self.position = 0  # batch index within epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.dataset))
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(len(self.dataset))

    def _batch_indices(self, order: np.ndarray, position: int) -> np.ndarray:
        start = position * self.batch_size
        return order[start : start + self.batch_size]

    def __iter__(self):
        if self.num_workers > 0:
            yield from self._iter_prefetch()
            return
        order = self._order()
        nb = len(self)
        while self.position < nb:
            idx = self._batch_indices(order, self.position)
            self.position += 1
            yield collate_fn([self.dataset[int(i)] for i in idx])
        self.epoch += 1
        self.position = 0

    def _iter_prefetch(self):
        """Background-threaded epoch: every item of the next
        ``prefetch_batches`` batches loads on the pool concurrently (patchify
        is pure numpy/PIL — GIL-released in the hot parts). Checkpoint state
        (epoch/position) advances only when a batch is YIELDED, so resume
        stays exact."""
        from concurrent.futures import ThreadPoolExecutor

        order = self._order()
        nb = len(self)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            pending = []  # list of per-batch future lists
            next_pos = self.position

            def submit(pos):
                idx = self._batch_indices(order, pos)
                return [pool.submit(self.dataset.__getitem__, int(i)) for i in idx]

            while next_pos < nb and len(pending) < self.prefetch_batches:
                pending.append(submit(next_pos))
                next_pos += 1
            while pending:
                futures = pending.pop(0)
                batch = collate_fn([f.result() for f in futures])
                if next_pos < nb:
                    pending.append(submit(next_pos))
                    next_pos += 1
                self.position += 1
                yield batch
        finally:
            # non-blocking: an abandoned iterator (max_steps hit, exception)
            # must not stall the trainer waiting on in-flight image prep
            pool.shutdown(wait=False, cancel_futures=True)
        self.epoch += 1
        self.position = 0

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "position": self.position, "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = state["epoch"]
        self.position = state["position"]
        self.seed = state.get("seed", self.seed)
