"""Evaluation metrics (the port's own copy of
``spatialthinker_tpu/eval/metrics.py``): accuracy with its binomial stderr,
per-task accuracy, and the 3DSR paired view-consistency score."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple


def accuracy_with_stderr(correct: int, total: int) -> Tuple[float, float]:
    if total == 0:
        return 0.0, 0.0
    acc = correct / total
    return acc, math.sqrt(max(acc * (1 - acc), 0.0) / total)


def per_task_accuracy(
    records: List[Dict], task_counts: Optional[Dict[str, int]] = None
) -> Dict[str, Tuple[float, float]]:
    """records: dicts with 'task' and 'correct' (0/1)."""
    out = {}
    tasks = task_counts or {}
    seen_tasks = tasks.keys() if tasks else {r.get("task") for r in records if r.get("task")}
    for task in seen_tasks:
        rel = [r for r in records if r.get("task") == task]
        out[task] = accuracy_with_stderr(sum(r["correct"] for r in rel), len(rel))
    return out


def view_consistency(records: List[Dict]) -> Tuple[float, float]:
    """3DSR-Full paired metric: consecutive (even, odd) records are two views
    of one scene; a pair counts iff BOTH answers are correct."""
    pairs_total = len(records) // 2
    pairs_consistent = sum(
        1
        for i in range(1, len(records), 2)
        if records[i - 1]["correct"] == 1 and records[i]["correct"] == 1
    )
    return accuracy_with_stderr(pairs_consistent, pairs_total)


def summarize(records: List[Dict], task_counts: Optional[Dict[str, int]] = None,
              paired_consistency: bool = False) -> Dict[str, float]:
    correct = sum(r["correct"] for r in records)
    acc, err = accuracy_with_stderr(correct, len(records))
    out = {"accuracy": acc, "stderr": err, "n": len(records)}
    for task, (a, e) in per_task_accuracy(records, task_counts).items():
        out[f"{task}_acc"] = a
        out[f"{task}_stderr"] = e
    if paired_consistency:
        vc, vce = view_consistency(records)
        out["view_consistency_acc"] = vc
        out["view_consistency_stderr"] = vce
    return out
