"""Math reward: <think> + \\boxed{} format (0.1) + graded accuracy (0.9)
(parity: verl/utils/reward_score/math.py)."""

from __future__ import annotations

import re
from typing import Dict

from .grading import extract_boxed_content, grade_answer

_FORMAT_RE = re.compile(r"<think>.*</think>.*\\boxed\{.*\}.*", re.DOTALL)


def math_format_reward(predict_str: str) -> float:
    return 1.0 if _FORMAT_RE.fullmatch(predict_str) else 0.0


def math_acc_reward(predict_str: str, ground_truth: str) -> float:
    answer = extract_boxed_content(predict_str)
    return 1.0 if grade_answer(answer, ground_truth) else 0.0


def math_compute_score(predict_str: str, ground_truth: str) -> Dict[str, float]:
    # normalize spacing inside tags (qwen2.5vl-32b emits "< think >")
    predict_str = re.sub(r"\s*(<|>|/)\s*", r"\1", predict_str)
    format_score = math_format_reward(predict_str)
    accuracy = math_acc_reward(predict_str, ground_truth)
    return {
        "overall": 0.9 * accuracy + 0.1 * format_score,
        "format": format_score,
        "accuracy": accuracy,
    }
