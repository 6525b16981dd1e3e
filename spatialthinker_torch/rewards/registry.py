"""Score-function registry (parity: verl/workers/reward/custom.py:33-46)."""

from __future__ import annotations

from typing import Callable, Dict

from .math_reward import math_compute_score
from .r1v import r1v_compute_score
from .r1v_scene import r1v_scene_compute_score
from .spatial_sgg import spatial_sgg_compute_score

_REGISTRY: Dict[str, Callable] = {
    "math": math_compute_score,
    "r1v": r1v_compute_score,
    "r1v_scene": r1v_scene_compute_score,
    "spatial_sgg": spatial_sgg_compute_score,
}


def register_score_function(name: str, fn: Callable) -> None:
    _REGISTRY[name] = fn


def get_score_function(name: str) -> Callable:
    if name not in _REGISTRY:
        raise NotImplementedError(f"Unknown score function: {name!r} (have {sorted(_REGISTRY)})")
    return _REGISTRY[name]
