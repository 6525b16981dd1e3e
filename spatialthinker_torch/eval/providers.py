"""Eval-harness provider running the port's model and dense rollout engine
(counterpart of ``JaxProvider`` in ``spatialthinker_tpu/eval/providers.py``)."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core.batch import pad_to_divisor, trim_prompt_padding
from ..core.config import DataConfig
from ..data.dataset import RLHFDataset, collate_fn
from ..data.packing import pack_vision_batch
from ..models.qwen2_5_vl.host import window_patch_len
from ..models.qwen2_5_vl.model import vision_to_device
from ..rollout.engine import generate as engine_generate
from ..rollout.sampling import SamplingParams


class Provider:
    """generate(prompts, images_per_prompt) -> list of output texts."""

    def generate(self, prompts: List[str], images: List[List[Any]]) -> List[str]:
        raise NotImplementedError


class TorchProvider(Provider):
    """Evaluate with the port's model + dense rollout engine (greedy by
    default), on the device that holds the model's weights.

    Shapes are bucketed as ``JaxProvider`` buckets them: prompts trim to
    ``prompt_bucket`` multiples, rows pad cyclically up to the largest batch
    seen, and the vision pack width rounds up to whole 16-window buckets."""

    def __init__(self, params, model_cfg, tokenizer, max_new_tokens: int = 2048,
                 temperature: float = 0.0, max_prompt_length: int = 6144,
                 min_pixels: int = 262_144, max_pixels: int = 4_194_304,
                 prompt_bucket: int = 512):
        self.params = params  # a Qwen25VL module
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.sampling = SamplingParams(temperature=temperature)
        self._data_cfg = DataConfig(
            max_prompt_length=max_prompt_length, min_pixels=min_pixels, max_pixels=max_pixels
        )
        self.device = params.text.norm.weight.device
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._prompt_bucket = prompt_bucket
        self._row_bucket = 0  # grows to the largest batch seen; never shrinks

    def prepare_host(self, prompts: List[str], images: List[List[Any]]) -> Dict[str, Any]:
        """Host (numpy) inputs for a batch of requests: tokenized, left-padded,
        bucketed prompts and each prompt's image patches and grids — what the
        paged engine takes as they are."""
        self._row_bucket = max(self._row_bucket, len(prompts))
        rows = [
            {"problem": ("<image>" * len(imgs)) + p, "answer": "", "image": imgs}
            for p, imgs in zip(prompts, images)
        ]
        ds = RLHFDataset.from_rows(rows, self.tokenizer, self._data_cfg, self.model_cfg)
        batch = collate_fn([ds[i] for i in range(len(rows))])
        batch = trim_prompt_padding(batch, bucket=self._prompt_bucket)
        batch, _ = pad_to_divisor(batch, self._row_bucket)
        t = batch.tensors
        return {
            "input_ids": t["input_ids"],
            "segment_ids": t["segment_ids"],
            "position_ids": np.transpose(t["position_ids"], (1, 0, 2)),
            "gen_pos_start": t["gen_pos_start"],
            "patches_list": list(batch.non_tensors["patches"]),
            "grids_list": list(batch.non_tensors["image_grid_thw"]),
        }

    def prepare(self, prompts: List[str], images: List[List[Any]]) -> Dict[str, Any]:
        """The dense engine's inputs for a batch of requests, on the model's
        device: the prompts of ``prepare_host`` and the packed vision input."""
        host = self.prepare_host(prompts, images)
        patches, grids = host["patches_list"], host["grids_list"]
        vision = pack_vision_batch(patches, grids, self.model_cfg.vision)
        if vision is not None:
            gran = window_patch_len(self.model_cfg.vision) * 16
            pad_to = -(-vision.patches.shape[0] // gran) * gran
            if pad_to != vision.patches.shape[0]:
                vision = pack_vision_batch(patches, grids, self.model_cfg.vision, pad_to=pad_to)

        def dev(a):
            return torch.as_tensor(np.asarray(a), device=self.device)

        return {
            "input_ids": dev(host["input_ids"]),
            "prompt_segment_ids": dev(host["segment_ids"]),
            "position_ids": dev(host["position_ids"]),
            "gen_pos_start": dev(host["gen_pos_start"]),
            "vision": vision_to_device(vision, self.device),
        }

    def generate(self, prompts: List[str], images: List[List[Any]]) -> List[str]:
        n_real = len(prompts)
        result = engine_generate(
            self.params, **self.prepare(prompts, images),
            max_new_tokens=self.max_new_tokens, sampling=self.sampling, generator=self._generator,
        )
        responses = result.responses[:n_real].cpu().numpy()
        lengths = result.response_mask.sum(-1).cpu().numpy()
        return self.tokenizer.batch_decode(
            [responses[i, : lengths[i]] for i in range(n_real)], skip_special_tokens=True
        )
