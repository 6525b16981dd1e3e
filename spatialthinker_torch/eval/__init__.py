"""The eval harness (counterpart of ``spatialthinker_tpu/eval``): benchmarks,
prompt templates, answer extraction, metrics, providers, and the CLI
``python3 -m spatialthinker_torch.eval``."""

from .extraction import judge_answer, repair_answer_tags, to_option_letter
from .harness import EvalConfig, load_benchmark, run_evaluation
from .metrics import accuracy_with_stderr, per_task_accuracy, summarize, view_consistency
from .providers import (
    AnthropicProvider, HFProvider, OpenAIProvider, Provider, TorchProvider, post_with_retry,
)
from .registry import REGISTRY, DatasetSpec, get_dataset_spec
from .templates import SPATIAL_THINKER_TEMPLATE, format_instruction

__all__ = [
    "judge_answer", "repair_answer_tags", "to_option_letter",
    "EvalConfig", "load_benchmark", "run_evaluation",
    "accuracy_with_stderr", "per_task_accuracy", "summarize", "view_consistency",
    "AnthropicProvider", "HFProvider", "OpenAIProvider", "Provider", "TorchProvider",
    "post_with_retry",
    "REGISTRY", "DatasetSpec", "get_dataset_spec",
    "SPATIAL_THINKER_TEMPLATE", "format_instruction",
]
