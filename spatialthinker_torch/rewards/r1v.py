"""Vanilla GRPO baseline reward: <think></think><answer></answer> format +
graded answer accuracy (parity: verl/utils/reward_score/r1v.py)."""

from __future__ import annotations

import re
from typing import Dict

from .grading import grade_answer

_FORMAT_RE = re.compile(r"<think>.*?</think>\s*<answer>.*?</answer>", re.DOTALL)
_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)


def r1v_format_reward(predict_str: str) -> float:
    return 1.0 if _FORMAT_RE.fullmatch(predict_str) else 0.0


def r1v_accuracy_reward(predict_str: str, ground_truth: str) -> float:
    try:
        if "<answer>" in ground_truth and "</answer>" in ground_truth:
            gt_match = re.search(r"<answer>(.*?)</answer>", ground_truth)
            ground_truth_clean = gt_match.group(1).strip() if gt_match else ground_truth.strip()
        else:
            ground_truth_clean = ground_truth.strip()
        pred_match = _ANSWER_RE.search(predict_str)
        predicted = pred_match.group(1).strip() if pred_match else predict_str.strip()
        if grade_answer(predicted, ground_truth_clean):
            return 1.0
    except Exception:
        pass
    return 0.0


def r1v_compute_score(predict_str: str, ground_truth: str) -> Dict[str, float]:
    format_score = r1v_format_reward(predict_str)
    accuracy_score = r1v_accuracy_reward(predict_str, ground_truth)
    return {
        "overall": 0.5 * accuracy_score + 0.5 * format_score,
        "format": format_score,
        "accuracy": accuracy_score,
    }
