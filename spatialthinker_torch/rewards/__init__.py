from .manager import RewardManager
from .math_reward import math_compute_score
from .r1v import r1v_compute_score
from .r1v_scene import r1v_scene_compute_score
from .registry import get_score_function
from .spatial_sgg import spatial_sgg_compute_score

__all__ = [
    "RewardManager",
    "math_compute_score",
    "r1v_compute_score",
    "r1v_scene_compute_score",
    "get_score_function",
    "spatial_sgg_compute_score",
]
