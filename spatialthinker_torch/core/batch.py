"""RolloutBatch: the host-side batch container of the port (its own copy of
the JAX package's ``core/batch.py``, trimmed to what the port's data pipeline,
providers and trainer use). Arrays are plain numpy on the host; ``non_tensors`` holds
ragged python payloads (raw prompt ids, images) as object ndarrays.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Array = np.ndarray


@dataclass
class RolloutBatch:
    tensors: Dict[str, Array] = field(default_factory=dict)
    non_tensors: Dict[str, Array] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    def __len__(self) -> int:
        for v in self.tensors.values():
            return int(v.shape[0])
        for v in self.non_tensors.values():
            return int(v.shape[0])
        return 0

    def split(self, split_size: int) -> List["RolloutBatch"]:
        """Consecutive pieces of at most ``split_size`` rows."""
        n = len(self)
        return [self.select(slice(start, min(start + split_size, n)))
                for start in range(0, n, split_size)]

    def reorder(self, indices: np.ndarray) -> None:
        """Permute the rows in place."""
        self.tensors = {k: v[indices] for k, v in self.tensors.items()}
        self.non_tensors = {k: v[indices] for k, v in self.non_tensors.items()}

    def repeat(self, repeat_times: int, interleave: bool = True) -> "RolloutBatch":
        """Repeat each row ``repeat_times`` times (interleave=True gives
        [a, a, b, b] — the GRPO n-samples layout)."""
        n = len(self)
        idx = np.repeat(np.arange(n), repeat_times) if interleave else np.tile(np.arange(n), repeat_times)
        return self.select(idx)

    def select(self, rows) -> "RolloutBatch":
        """The rows picked by a slice or an index array, in that order."""
        return RolloutBatch(
            tensors={k: v[rows] for k, v in self.tensors.items()},
            non_tensors={k: v[rows] for k, v in self.non_tensors.items()},
            meta=copy.copy(self.meta),
        )


def pad_to_divisor(batch: RolloutBatch, divisor: int) -> Tuple[RolloutBatch, int]:
    """Cyclically self-repeat rows until len is divisible."""
    n = len(batch)
    if divisor <= 1 or n % divisor == 0:
        return batch, 0
    pad = divisor - (n % divisor)
    idx = np.concatenate([np.arange(n), np.arange(pad) % n])
    padded = RolloutBatch(
        tensors={k: v[idx] for k, v in batch.tensors.items()},
        non_tensors={k: v[idx] for k, v in batch.non_tensors.items()},
        meta=copy.copy(batch.meta),
    )
    return padded, pad


def unpad(batch: RolloutBatch, pad_size: int) -> RolloutBatch:
    if pad_size == 0:
        return batch
    return batch.select(slice(0, len(batch) - pad_size))


def trim_prompt_padding(batch: RolloutBatch, bucket: int = 512,
                        negotiated_max: Optional[int] = None) -> RolloutBatch:
    """Left-padded prompts are padded to the config max; trim to the batch's
    longest prompt rounded up to `bucket`.
    Safe because position ids / segment ids travel with the tokens.
    ``negotiated_max`` carries a cross-process max where one was negotiated."""
    seg = batch.tensors["segment_ids"]
    max_len = negotiated_max if negotiated_max is not None else int(seg.sum(-1).max())
    p = seg.shape[1]
    keep = min(p, max(bucket, ((max_len + bucket - 1) // bucket) * bucket))
    if keep >= p:
        return batch
    out = RolloutBatch(
        tensors=dict(batch.tensors), non_tensors=batch.non_tensors, meta=batch.meta
    )
    out.tensors["input_ids"] = batch.tensors["input_ids"][:, p - keep:]
    out.tensors["segment_ids"] = seg[:, p - keep:]
    out.tensors["position_ids"] = batch.tensors["position_ids"][:, :, p - keep:]
    return out


def trim_response_padding(batch: RolloutBatch, bucket: int = 256,
                          negotiated_max: Optional[int] = None) -> RolloutBatch:
    """Right-trim the response buffer to the longest valid response rounded
    up to `bucket` (responses usually hit EOS well before max_new_tokens);
    ``negotiated_max`` carries a cross-process max where one was negotiated."""
    mask = batch.tensors["response_mask"]
    r = mask.shape[1]
    max_len = negotiated_max if negotiated_max is not None else int(mask.sum(-1).max())
    keep = min(r, max(bucket, ((max_len + bucket - 1) // bucket) * bucket))
    if keep >= r:
        return batch
    out = RolloutBatch(
        tensors=dict(batch.tensors), non_tensors=batch.non_tensors, meta=batch.meta
    )
    p = batch.tensors["input_ids"].shape[1]
    for key in ("responses", "response_mask", "token_level_scores", "rollout_log_probs"):
        if key in out.tensors:
            out.tensors[key] = out.tensors[key][:, :keep]
    for key in ("full_input_ids", "full_segment_ids"):
        out.tensors[key] = out.tensors[key][:, : p + keep]
    return out
