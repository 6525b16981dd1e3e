from .batch import RolloutBatch, pad_to_divisor, trim_prompt_padding, trim_response_padding, unpad
from .config import DataConfig, PPOConfig, build_config, config_summary

__all__ = ["RolloutBatch", "pad_to_divisor", "trim_prompt_padding", "trim_response_padding", "unpad",
           "DataConfig", "PPOConfig", "build_config", "config_summary"]
