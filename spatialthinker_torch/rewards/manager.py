"""Reward manager: decode responses, score them host-side in parallel, place the
scalar reward on the last valid response token.

Parity: verl/workers/reward/custom.py:33-73, with two changes the JAX
package made and this copy keeps: (1) scoring fans out over a thread pool
(the scorers are numpy/regex-bound and release the GIL in the hot parts; the
reference loops serially), and (2) the manager is a pure host function — the
(bs, response_length) reward array stays numpy until the trainer needs it.
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from ..core.batch import RolloutBatch
from .registry import get_score_function


class RewardManager:
    def __init__(
        self,
        tokenizer: Any,
        compute_score: str,
        skip_special_tokens: bool = True,
        num_workers: int = 8,
    ):
        self.tokenizer = tokenizer
        self.compute_score_name = compute_score
        self.compute_score: Callable = get_score_function(compute_score)
        self.skip_special_tokens = skip_special_tokens
        self.num_workers = max(1, num_workers)

    def _score_one(self, args) -> Dict[str, float]:
        response_str, ground_truth, problem = args
        if self.compute_score_name == "spatial_sgg":
            return self.compute_score(response_str, ground_truth, problem)
        return self.compute_score(response_str, ground_truth)

    def __call__(self, batch: RolloutBatch) -> Tuple[np.ndarray, Dict[str, List[float]]]:
        """Returns (reward_tensor (bs, response_length), metrics dict of per-sample lists)."""
        response_ids = batch.tensors["responses"]
        response_mask = batch.tensors["response_mask"]
        bs, response_length = response_ids.shape

        valid_lengths = response_mask.sum(axis=-1).astype(np.int64)
        response_strs = self.tokenizer.batch_decode(
            [response_ids[i, : valid_lengths[i]] for i in range(bs)],
            skip_special_tokens=self.skip_special_tokens,
        )
        ground_truths = batch.non_tensors["ground_truth"]
        problems = batch.non_tensors.get("problem", np.array([""] * bs, dtype=object))

        jobs = list(zip(response_strs, ground_truths, problems))
        if self.num_workers > 1 and bs > 1:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                scores = list(pool.map(self._score_one, jobs))
        else:
            scores = [self._score_one(j) for j in jobs]

        reward_tensor = np.zeros((bs, response_length), dtype=np.float32)
        metrics: Dict[str, List[float]] = defaultdict(list)
        for i, score in enumerate(scores):
            if valid_lengths[i] > 0:
                reward_tensor[i, valid_lengths[i] - 1] = score["overall"]
            for key, value in score.items():
                metrics[key].append(float(value))
        return reward_tensor, dict(metrics)
