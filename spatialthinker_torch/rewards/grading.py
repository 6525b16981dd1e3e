"""Math answer grading: normalization + symbolic/numeric equivalence.

Stands in for the external ``mathruler.grader`` used by the reference
(verl/utils/reward_score/math.py:18, r1v.py:18). When
mathruler is installed we defer to it for exact parity; otherwise this
in-repo grader covers the same contract: LaTeX-ish normalization,
\\boxed{...} extraction, fraction/percent/numeric equivalence.
"""

from __future__ import annotations

import re
from typing import Optional

try:  # optional exact-parity path
    from mathruler.grader import extract_boxed_content as _mr_extract
    from mathruler.grader import grade_answer as _mr_grade

    _HAS_MATHRULER = True
except Exception:
    _HAS_MATHRULER = False


def extract_boxed_content(text: str) -> str:
    """Extract the last \\boxed{...} with balanced-brace scanning."""
    if _HAS_MATHRULER:
        return _mr_extract(text)
    idx = text.rfind("\\boxed{")
    if idx == -1:
        return "None"
    depth = 0
    start = idx + len("\\boxed{")
    for i in range(start - 1, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text[start:i]
    return "None"


_UNITS_RE = re.compile(
    r"\\(?:text|mbox|mathrm|hbox)\s*\{[^{}]*\}"
)


def _normalize(answer: Optional[str]) -> Optional[str]:
    if answer is None:
        return None
    s = answer.strip()
    # strip layout latex
    s = _UNITS_RE.sub("", s)
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\!", "").replace("\\,", "").replace("\\ ", " ").replace("\\;", "")
    s = s.replace("\\$", "").replace("$", "")
    s = s.replace("\\%", "").replace("%", "")
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\dfrac", "\\frac").replace("\\tfrac", "\\frac")
    # \frac{a}{b} -> a/b
    s = re.sub(r"\\frac\{([^{}]+)\}\{([^{}]+)\}", r"\1/\2", s)
    s = re.sub(r"\\frac(\d)(\d)", r"\1/\2", s)
    s = re.sub(r"\\sqrt\{([^{}]+)\}", r"sqrt(\1)", s)
    s = s.replace("\\pi", "pi").replace("\\cdot", "*").replace("\\times", "*")
    s = s.replace("{", "").replace("}", "")
    s = s.replace(" ", "")
    # strip thousands separators: 1,234 -> 1234
    s = re.sub(r"(\d),(?=\d{3}(\D|$))", r"\1", s)
    s = s.rstrip(".")
    return s.lower()


def _to_number(s: str) -> Optional[float]:
    try:
        return float(s)
    except ValueError:
        pass
    m = re.fullmatch(r"(-?\d+(?:\.\d+)?)/(-?\d+(?:\.\d+)?)", s)
    if m:
        denom = float(m.group(2))
        if denom != 0:
            return float(m.group(1)) / denom
    return None


def grade_answer(given_answer: Optional[str], ground_truth: Optional[str]) -> bool:
    """True if the given answer is mathematically equivalent to the ground truth."""
    if given_answer is None or ground_truth is None:
        return False
    if _HAS_MATHRULER:
        return bool(_mr_grade(given_answer, ground_truth))
    g = _normalize(str(given_answer))
    t = _normalize(str(ground_truth))
    if g is None or t is None:
        return False
    if g == t:
        return True
    gn, tn = _to_number(g), _to_number(t)
    if gn is not None and tn is not None:
        return abs(gn - tn) <= 1e-6 * max(1.0, abs(tn))
    # multiple-choice letter equivalence: "(a)" == "a"
    gm = re.fullmatch(r"\(?([a-e])\)?\.?", g)
    tm = re.fullmatch(r"\(?([a-e])\)?\.?", t)
    if gm and tm:
        return gm.group(1) == tm.group(1)
    return False
