"""Answer extraction + grading for the eval harness: <answer> tag repair,
option-letter mapping against choice lists, math-equivalence fallback
(the port's own copy of ``spatialthinker_tpu/eval/extraction.py``)."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from ..rewards.grading import grade_answer

OPTION_LETTERS = [chr(65 + i) for i in range(10)]


def repair_answer_tags(text: str) -> str:
    """Extract the <answer>...</answer> span, repairing missing tags:
    trailing 'Answer:' prefixes, missing open/close tags."""
    answer = text
    if "Answer:" in answer:
        answer = answer.split("Answer:")[-1].strip()
    if "<answer>" not in answer and "</answer>" not in answer:
        return answer.strip()
    if "<answer>" not in answer and "</answer>" in answer:
        return answer.split("</answer>")[0].strip()
    tail = answer.split("<answer>")[-1]
    if "</answer>" in tail:
        tail = tail.split("</answer>")[0]
    return tail.strip()


def extract_reasoning(text: str) -> str:
    m = re.search(r"<think>(.*?)</think>", text, re.DOTALL)
    return m.group(1).strip() if m else ""


def strip_option_prefix(answer: str) -> str:
    """'(A) cat' -> 'cat'; 'A) cat' -> 'cat'."""
    out = re.sub(r"^\([A-Za-z]\)\s*", "", answer)
    if out == answer:
        out = re.sub(r"^[A-Za-z]\)\s*", "", answer)
    return out.replace("{", "").replace("}", "")


def to_option_letter(answer: str, choices: List[str]) -> str:
    """Map a predicted answer to its choice letter: by content match first,
    then by detecting an explicit letter in the text."""
    lowered = [c.lower() for c in choices]
    content = strip_option_prefix(answer).strip().lower()
    if content in lowered:
        return OPTION_LETTERS[lowered.index(content)]
    for j in range(len(choices)):
        letter = OPTION_LETTERS[j]
        if re.search(rf"(?:^|[\s(\[]){letter}(?:[)\].\s]|$)", answer):
            return letter
    return answer.strip()


def normalize_ground_truth(response: str, choices: Optional[List[str]] = None,
                           yes_no_numeric: bool = False) -> str:
    """Reference ground truths are '(A)'-style for MCQ sets; strip braces.
    HallusionBench encodes yes/no as 1/0 -> A/B."""
    out = response.replace("(", "").replace(")", "").strip()
    if yes_no_numeric:
        out = out.replace(".", "")
        out = "A" if out == "1" else "B"
    return out


def judge_answer(
    prediction_text: str,
    ground_truth: str,
    choices: Optional[List[str]] = None,
    yes_no_numeric: bool = False,
    strip_gt_braces: bool = True,
) -> Tuple[bool, str, str]:
    """Full pipeline: repair tags -> option mapping -> compare with string
    equality, then math grading, then letter-tolerant matching.
    Returns (correct, extracted_pred, processed_gt)."""
    answer = repair_answer_tags(prediction_text)
    if strip_gt_braces:
        gt = normalize_ground_truth(ground_truth, choices, yes_no_numeric)
    else:
        gt = ground_truth.strip()
    if yes_no_numeric and choices is None:
        choices = ["Yes", "No"]
    if choices:
        answer = to_option_letter(answer, choices)
        if len(gt) > 1:
            gt = gt[0]
    correct = (
        answer.strip().lower() == gt.strip().lower()
        or grade_answer(answer, gt)
        or _paren_tolerant_match(answer, gt)
    )
    return bool(correct), answer, gt


def _paren_tolerant_match(pred: str, gt: str) -> bool:
    """'(A)' == 'a', trailing-dot tolerant."""
    p = pred
    if "(" in p and ")" in p:
        p = p.split("(")[1].split(")")[0]
    p = p.rstrip(".")
    return p.strip().lower() == gt.strip().lower()
