from .engine import RolloutResult, generate
from .sampling import SamplingParams

__all__ = ["RolloutResult", "SamplingParams", "generate"]
