"""Checkpoint / resume: parameters + optimizer state + dataloader iterator
state + RNG state, written with ``torch.save``.

The directory contract of ``spatialthinker_tpu/trainer/checkpoint.py`` (and of
the reference's FSDPCheckpointManager,
verl/utils/checkpoint/fsdp_checkpoint_manager.py:82-131):
``{save_path}/global_step_{N}/`` holding ``params.pt`` (the model's state
dict under its parameter names), ``opt_state.pt`` (the ``AdamW`` state: count,
moments and compensation buffers by parameter name) and ``extra_state.pkl``
(step, dataloader state, generator state); a ``latest_global_step.txt``
tracker file; ``save_limit`` pruning of obsolete checkpoints."""

from __future__ import annotations

import os
import pickle
import re
import shutil
from typing import Any, Dict, Optional

import torch

TRACKER_FILE = "latest_global_step.txt"


class CheckpointManager:
    def __init__(self, save_path: Optional[str], save_limit: int = -1):
        self.save_path = save_path
        self.save_limit = save_limit

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.save_path, f"global_step_{step}")

    def save(self, step: int, *, params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
             dataloader_state: Dict, rng_state) -> None:
        if not self.save_path:
            return
        path = os.path.abspath(self._step_dir(step))
        os.makedirs(path, exist_ok=True)
        torch.save(params, os.path.join(path, "params.pt"))
        torch.save(opt_state, os.path.join(path, "opt_state.pt"))
        extra = {"dataloader_state": dataloader_state, "rng_state": rng_state, "step": step}
        with open(os.path.join(path, "extra_state.pkl"), "wb") as f:
            pickle.dump(extra, f)
        with open(os.path.join(self.save_path, TRACKER_FILE), "w") as f:
            f.write(str(step))
        self._prune(step)

    def _prune(self, current_step: int) -> None:
        if self.save_limit <= 0:
            return
        pattern = re.compile(r"global_step_(\d+)$")
        steps = []
        for name in os.listdir(self.save_path):
            m = pattern.match(name)
            if m:
                steps.append(int(m.group(1)))
        for old in sorted(steps)[: max(0, len(steps) - self.save_limit)]:
            if old != current_step:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def latest_step(self, base_path: Optional[str] = None) -> Optional[int]:
        base = base_path or self.save_path
        tracker = os.path.join(base, TRACKER_FILE)
        if os.path.exists(tracker):
            with open(tracker) as f:
                return int(f.read().strip())
        return None

    def load(self, path: str, *, map_location="cpu") -> Optional[Dict[str, Any]]:
        """`path` is either a global_step_* dir or a base dir with a tracker
        file. Tensors load onto ``map_location``; the caller copies them into
        its own parameters and moments."""
        if not os.path.basename(path).startswith("global_step_"):
            step = self.latest_step(path)
            if step is None:
                return None
            path = os.path.join(path, f"global_step_{step}")
        if not os.path.isdir(path):
            return None
        path = os.path.abspath(path)
        step = int(os.path.basename(path).split("_")[-1])
        params = torch.load(os.path.join(path, "params.pt"), map_location=map_location,
                            weights_only=True)
        opt_state = torch.load(os.path.join(path, "opt_state.pt"), map_location=map_location,
                               weights_only=True)
        extra_path = os.path.join(path, "extra_state.pkl")
        extra = {}
        if os.path.exists(extra_path):
            with open(extra_path, "rb") as f:
                extra = pickle.load(f)
        return {
            "params": params,
            "opt_state": opt_state,
            "step": extra.get("step", step),
            "dataloader_state": extra.get("dataloader_state"),
            "rng_state": extra.get("rng_state"),
        }
