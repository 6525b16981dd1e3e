from .batch import RolloutBatch, pad_to_divisor, trim_prompt_padding
from .config import DataConfig

__all__ = ["RolloutBatch", "pad_to_divisor", "trim_prompt_padding", "DataConfig"]
