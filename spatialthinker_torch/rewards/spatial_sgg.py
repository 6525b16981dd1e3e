"""The SpatialThinker dense multi-objective spatial reward.

Behavioral parity with verl/utils/reward_score/spatial_sgg.py:644-691:

    total = 0.1 * format + 0.2 * count + 0.5 * accuracy + 0.2 * spatial

- format: all four <observe><scene><think><answer> tags exactly once, scene
  JSON schema-valid, unique object ids (scene.format_reward). When format
  fails, every other component is 0.
- count:  1 - |#pred_objs - #gt_objs| / max(#gt, 1), blended 0.7/0.3 with the
  relationship-count term when GT relations exist.
- accuracy: exact lowercase match of extracted <answer> text.
- spatial: gated on format == 1 AND accuracy == 1; mean matched CIoU between
  pred and GT objects under Hungarian assignment (cost 2*(1-sem) + (1-ciou)),
  boxes normalized by the image W x H parsed from the prompt.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .geometry import pairwise_ciou, scale_boxes
from .matching import match_objects, match_triplets
from .scene import (
    extract_answer,
    extract_image_size,
    extract_scene,
    format_reward,
    is_valid_object,
    is_valid_relation,
)
from .semantic import refine_node_edge, sim_matrix

FORMAT_WEIGHT = 0.1
COUNT_WEIGHT = 0.2
ACCURACY_WEIGHT = 0.5
SPATIAL_WEIGHT = 0.2

OBJ_WEIGHT = 0.5
REL_WEIGHT = 0.5


def acc_reward(pred: str, gt: str) -> float:
    return float(pred.strip().lower() == gt.strip().lower())


def count_reward(pred_scene, gt_scene) -> float:
    if not isinstance(pred_scene, dict) or not isinstance(gt_scene, dict):
        return 0.0
    pred_objs = pred_scene.get("objects")
    gt_objs = gt_scene.get("objects")
    pred_rels = pred_scene.get("relationships") or []
    gt_rels = gt_scene.get("relationships") or []
    if not isinstance(pred_objs, list) or not isinstance(gt_objs, list):
        return 0.0
    obj_term = max(0.0, 1.0 - abs(len(pred_objs) - len(gt_objs)) / max(len(gt_objs), 1))
    if not gt_rels:
        return obj_term
    rel_term = max(0.0, 1.0 - abs(len(pred_rels) - len(gt_rels)) / max(len(gt_rels), 1))
    return 0.7 * obj_term + 0.3 * rel_term


def _normalize_objects(objs: Sequence[Dict], w: int, h: int) -> List[Dict]:
    if not objs:
        return []
    boxes = scale_boxes(np.asarray([o["bbox"] for o in objs], dtype=np.float64), 1.0 / w, 1.0 / h)
    return [
        {"id": refine_node_edge(o["id"]), "bbox": boxes[i].tolist()} for i, o in enumerate(objs)
    ]


def _normalize_triplets(rels: Sequence[Dict]) -> List[Dict]:
    return [
        {**r, "subject": refine_node_edge(r["subject"]), "object": refine_node_edge(r["object"])}
        for r in rels
    ]


def _scene_parts(pred_scene, gt_scene):
    """Shared validity gate: returns (gt_objs, pr_objs, gt_rels, pr_rels) or None."""
    if not isinstance(pred_scene, dict) or not isinstance(gt_scene, dict):
        return None
    gt_objs = gt_scene.get("objects") or []
    pr_objs = pred_scene.get("objects") or []
    gt_rels = gt_scene.get("relationships") or []
    pr_rels = pred_scene.get("relationships") or []
    if not isinstance(pr_objs, list) or not isinstance(gt_objs, list):
        return None
    if not isinstance(pr_rels, list) or not isinstance(gt_rels, list):
        return None
    if not all(is_valid_object(o) for o in pr_objs):
        return None
    if not all(is_valid_relation(r) for r in pr_rels):
        return None
    return gt_objs, pr_objs, gt_rels, pr_rels


def compute_obj_score(gt_objs: List[Dict], pr_objs: List[Dict]) -> float:
    """Mean matched CIoU over GT objects (unmatched GT scores 0)."""
    if not gt_objs:
        return 1.0
    assign = match_objects(gt_objs, pr_objs)
    if not pr_objs:
        return 0.0
    gt_boxes = np.asarray([o["bbox"] for o in gt_objs], dtype=np.float64)
    pr_boxes = np.asarray([o["bbox"] for o in pr_objs], dtype=np.float64)
    ciou = pairwise_ciou(gt_boxes, pr_boxes)
    total = 0.0
    for g_idx, p_idx in enumerate(assign):
        if p_idx is not None:
            total += ciou[g_idx, p_idx]
    return total / len(gt_objs)


def compute_rel_score(gt_rels: List[Dict], pr_rels: List[Dict]) -> float:
    matches = match_triplets(gt_rels, pr_rels)
    scores = [1.0 - m["cost"] for m in matches]
    return sum(scores) / len(gt_rels) if gt_rels else 1.0


def relaxed_spatial_reward(
    pred_scene: dict,
    gt_scene: dict,
    w: int,
    h: int,
    threshold: float = 0.0,
    rel_gating: bool = False,
) -> float:
    """Object-grounding score, optionally gated on any relation triplet match
    (reference spatial_sgg.py:422-501; shipped config runs rel_gating=False)."""
    parts = _scene_parts(pred_scene, gt_scene)
    if parts is None:
        return 0.0
    gt_objs, pr_objs, gt_rels, pr_rels = parts
    gt_objs = _normalize_objects(gt_objs, w, h)
    pr_objs = _normalize_objects(pr_objs, w, h)

    if not gt_rels:
        if not gt_objs:
            return 1.0 if not pr_objs else 0.0
        return compute_obj_score(gt_objs, pr_objs)

    gt_triplets = _normalize_triplets(gt_rels)
    pr_triplets = _normalize_triplets(pr_rels)
    matches = match_triplets(gt_triplets, pr_triplets)
    obj_score = compute_obj_score(gt_objs, pr_objs)
    if not matches and rel_gating:
        return 0.0
    return obj_score


def spatial_reward(pred_scene: dict, gt_scene: dict, w: int, h: int) -> tuple:
    """Full object+relation variant (reference spatial_sgg.py:248-388):
    obj = 0.5 * (IoU/L1 box score) + 0.5 * label similarity, rel = mean triplet
    similarity. Returns (obj_score, rel_score)."""
    parts = _scene_parts(pred_scene, gt_scene)
    if parts is None:
        return 0.0, 0.0
    gt_objs, pr_objs, gt_rels, pr_rels = parts
    gt_objs = _normalize_objects(gt_objs, w, h)
    pr_objs = _normalize_objects(pr_objs, w, h)
    gt_triplets = _normalize_triplets(gt_rels)
    pr_triplets = _normalize_triplets(pr_rels)

    IOU_W, L1_W = 1.0, 5.0
    if not gt_objs:
        obj_score = 1.0 if not pr_objs else 0.0
    else:
        assign = match_objects(gt_objs, pr_objs)
        from .geometry import pairwise_iou, pairwise_l1

        if pr_objs:
            gt_boxes = np.asarray([o["bbox"] for o in gt_objs], dtype=np.float64)
            pr_boxes = np.asarray([o["bbox"] for o in pr_objs], dtype=np.float64)
            iou = pairwise_iou(gt_boxes, pr_boxes)
            l1 = np.exp(-pairwise_l1(gt_boxes, pr_boxes))
            sims = sim_matrix([o["id"] for o in gt_objs], [o["id"] for o in pr_objs])
        box_scores, id_sims = [], []
        for g_idx, p_idx in enumerate(assign):
            if p_idx is None:
                box_scores.append(0.0)
                id_sims.append(0.0)
            else:
                box_scores.append((IOU_W * iou[g_idx, p_idx] + L1_W * l1[g_idx, p_idx]) / (IOU_W + L1_W))
                id_sims.append(sims[g_idx, p_idx])
        obj_score = 0.5 * (sum(box_scores) / len(gt_objs)) + 0.5 * (sum(id_sims) / len(gt_objs))

    if not gt_rels:
        rel_score = 1.0 if not pr_rels else 0.0
    else:
        rel_score = compute_rel_score(gt_triplets, pr_triplets)
    return obj_score, rel_score


def spatial_sgg_compute_score(predict_str: str, ground_truth_str: str, problem: str) -> Dict[str, float]:
    pred_answer = extract_answer(predict_str)
    gt_answer = extract_answer(ground_truth_str)
    pred_scene = extract_scene(predict_str)
    gt_scene = extract_scene(ground_truth_str)
    image_width, image_height = extract_image_size(problem)

    fr = format_reward(predict_str)
    if fr == 1.0:
        cr = count_reward(pred_scene, gt_scene)
        ar = acc_reward(pred_answer, gt_answer)
        obj_score = 0.0
        if ar == 1.0:
            obj_score = relaxed_spatial_reward(pred_scene, gt_scene, image_width, image_height)
    else:
        cr, ar, obj_score = 0.0, 0.0, 0.0

    total = fr * FORMAT_WEIGHT + cr * COUNT_WEIGHT + ar * ACCURACY_WEIGHT + obj_score * SPATIAL_WEIGHT
    return {
        "overall": total,
        "format": fr,
        "count": cr,
        "accuracy": ar,
        "spatial_score": obj_score,
    }
