"""Scene-gated sparse reward: <observe><scene><think><answer> order enforced,
zero overall when format fails (parity: verl/utils/reward_score/r1v_scene.py)."""

from __future__ import annotations

import re
from typing import Dict

_FORMAT_RE = re.compile(
    r"<observe>.*?</observe>\s*<scene>.*?</scene>\s*<think>.*?</think>\s*<answer>.*?</answer>",
    re.DOTALL,
)
_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)


def r1v_scene_format_reward(predict_str: str) -> float:
    return 1.0 if _FORMAT_RE.fullmatch(predict_str) else 0.0


def _extract_answer(text: str) -> str:
    match = _ANSWER_RE.search(text)
    return match.group(1).strip() if match else ""


def r1v_scene_accuracy_reward(predict_str: str, ground_truth: str) -> float:
    pred = _extract_answer(predict_str)
    gt = _extract_answer(ground_truth)
    return float(pred.strip().lower() == gt.strip().lower())


def r1v_scene_compute_score(predict_str: str, ground_truth: str) -> Dict[str, float]:
    format_score = r1v_scene_format_reward(predict_str)
    if format_score == 0.0:
        return {"overall": 0.0, "format": 0.0, "accuracy": 0.0}
    accuracy_score = r1v_scene_accuracy_reward(predict_str, ground_truth)
    return {
        "overall": 0.5 * accuracy_score + 0.5 * format_score,
        "format": format_score,
        "accuracy": accuracy_score,
    }
