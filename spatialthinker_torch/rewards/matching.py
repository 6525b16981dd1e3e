"""Hungarian matching for scene-graph objects and relation triplets.

Behavioral parity with verl/utils/reward_score/spatial_sgg.py:140-246,
but cost matrices are built with vectorized geometry (pairwise_ciou) and a
batched similarity matrix instead of per-pair python loops. The assignment
solve is ``scipy.optimize.linear_sum_assignment``. The JAX package's C++
Jonker-Volgenant solver (not copied) finds an optimal assignment too, but
where costs tie (duplicate predictions, equal boxes) the two may pick
different optimal mappings. The rewards built on the mappings stay equal
(``tests/test_torch_rewards.py::test_rewards_equal_on_tied_costs``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .geometry import pairwise_ciou
from .semantic import sim_matrix

SEM_W = 2.0  # label similarity weight
IOU_W = 1.0  # spatial overlap weight
DUMMY_COST = 1e5


def _solve_assignment(cost: np.ndarray):
    """Minimum-cost assignment; returns (row_idx, col_idx)."""
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)


def match_objects(gt_objs: Sequence[Dict], pr_objs: Sequence[Dict]) -> List[Optional[int]]:
    """Hungarian match preds->GT with cost SEM_W*(1-sim) + IOU_W*(1-ciou).

    Rows are predictions padded with dummy rows when preds < GT; returns a
    GT-indexed list where entry j is the matched pred index or None.
    """
    G, P = len(gt_objs), len(pr_objs)
    if G == 0:
        return []
    pad = max(0, G - P)
    cost = np.full((P + pad, G), DUMMY_COST, dtype=np.float64)
    if P:
        pr_boxes = np.asarray([o["bbox"] for o in pr_objs], dtype=np.float64)
        gt_boxes = np.asarray([o["bbox"] for o in gt_objs], dtype=np.float64)
        ciou = pairwise_ciou(pr_boxes, gt_boxes)  # (P, G)
        sims = sim_matrix([o["id"] for o in pr_objs], [o["id"] for o in gt_objs])
        cost[:P, :] = SEM_W * (1.0 - sims) + IOU_W * (1.0 - ciou)
    rows, cols = _solve_assignment(cost)
    mapping: List[Optional[int]] = [None] * G
    for r, c in zip(rows, cols):
        if r < P:
            mapping[c] = int(r)
    return mapping


def match_triplets(gt_rels: Sequence[Dict], pred_rels: Sequence[Dict]) -> List[Dict]:
    """Hungarian match of (subject, predicate, object) triplets by weighted
    semantic similarity 0.3/0.4/0.3 (subj/pred/obj)."""
    num_gt, num_pred = len(gt_rels), len(pred_rels)
    if num_gt == 0:
        return []
    pad = max(0, num_gt - num_pred)
    cost = np.full((num_pred + pad, num_gt), DUMMY_COST, dtype=np.float64)
    if num_pred:
        subj = sim_matrix([r["subject"] for r in pred_rels], [r["subject"] for r in gt_rels])
        obj = sim_matrix([r["object"] for r in pred_rels], [r["object"] for r in gt_rels])
        pred = sim_matrix([r["predicate"] for r in pred_rels], [r["predicate"] for r in gt_rels])
        weighted = 0.3 * subj + 0.3 * obj + 0.4 * pred
        cost[:num_pred, :] = 1.0 - weighted
    rows, cols = _solve_assignment(cost)
    matches = []
    for r, c in zip(rows, cols):
        if r < num_pred:
            matches.append(
                {
                    "groundtruth": gt_rels[c],
                    "prediction": pred_rels[r],
                    "cost": float(cost[r, c]),
                    "similarity": 1.0 - float(cost[r, c]),
                }
            )
    return matches
