"""The offline data-synthesis pipeline (counterpart of
``spatialthinker_tpu/data_gen``): LLM-generated spatial VQA over Visual Genome
scene graphs, balanced, shuffled, cross-validated and split. Host code only
(no torch); the CLI is ``python3 -m spatialthinker_torch.data_gen``."""

from .lemma import expand_question_words, map_objects, map_relationships, normalize_token
from .pipeline import (
    build_hf_dataset,
    compute_data_stats,
    correct_count_answer,
    cross_validate,
    easy_hard_splits,
    extract_json_from_output,
    generate_questions,
    shuffle_options_deterministic,
)

__all__ = [
    "expand_question_words", "map_objects", "map_relationships", "normalize_token",
    "build_hf_dataset", "compute_data_stats", "correct_count_answer", "cross_validate",
    "easy_hard_splits", "extract_json_from_output", "generate_questions",
    "shuffle_options_deterministic",
]
