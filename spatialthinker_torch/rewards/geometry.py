"""Vectorized bounding-box geometry: IoU / GIoU / CIoU / L1.

Behavioral parity with the scalar helpers in
verl/utils/reward_score/spatial_sgg.py:41-138, re-designed as
batched numpy ops so the Hungarian cost matrix for N preds x M GTs is computed
in one shot instead of N*M python calls (the reference's reward hot loop)."""

from __future__ import annotations

import numpy as np


def _split(boxes: np.ndarray):
    return boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]


def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between a:(N,4) and b:(M,4) boxes [x1,y1,x2,y2]. Returns (N,M)."""
    a = np.asarray(a, dtype=np.float64)[:, None, :]
    b = np.asarray(b, dtype=np.float64)[None, :, :]
    ax1, ay1, ax2, ay2 = _split(a)
    bx1, by1, bx2, by2 = _split(b)
    iw = np.maximum(0.0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
    ih = np.maximum(0.0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return np.where(union == 0.0, 0.0, inter / np.where(union == 0.0, 1.0, union))


def pairwise_ciou(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Complete-IoU matrix mapped to [0,1] via (ciou+1)/2; pairwise over (N,4)x(M,4).

    Matches the scalar recipe of the reference (spatial_sgg.py:75-133): the
    union carries +eps, the enclosing diagonal carries +eps, and alpha uses the
    eps-free IoU denominator.
    """
    a = np.asarray(a, dtype=np.float64)[:, None, :]
    b = np.asarray(b, dtype=np.float64)[None, :, :]
    ax1, ay1, ax2, ay2 = _split(a)
    bx1, by1, bx2, by2 = _split(b)
    wa, ha = ax2 - ax1, ay2 - ay1
    wb, hb = bx2 - bx1, by2 - by1

    iw = np.maximum(0.0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
    ih = np.maximum(0.0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    inter = iw * ih
    union = wa * ha + wb * hb - inter + eps
    iou = inter / union

    cxa, cya = (ax1 + ax2) / 2.0, (ay1 + ay2) / 2.0
    cxb, cyb = (bx1 + bx2) / 2.0, (by1 + by2) / 2.0
    center_dist_sq = (cxa - cxb) ** 2 + (cya - cyb) ** 2

    ex1, ey1 = np.minimum(ax1, bx1), np.minimum(ay1, by1)
    ex2, ey2 = np.maximum(ax2, bx2), np.maximum(ay2, by2)
    enclose_diag_sq = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2 + eps

    # NOTE argument order: the reference computes atan(w_pred/h_pred)-atan(w_gt/h_gt)
    # with (boxA=pred? no: compute_ciou(boxA, boxB) uses wB,hB first). The term is
    # squared so the order does not change the value.
    v = (4.0 / (np.pi**2)) * (np.arctan(wb / (hb + eps)) - np.arctan(wa / (ha + eps))) ** 2
    with_v = (1.0 - iou) + v
    alpha = np.where(with_v == 0.0, 0.0, v / np.where(with_v == 0.0, 1.0, with_v))

    ciou = iou - (center_dist_sq / enclose_diag_sq + alpha * v)
    return (ciou + 1.0) / 2.0


def pairwise_giou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GIoU matrix mapped to [0,1] (reference spatial_sgg.py:50-72)."""
    a = np.asarray(a, dtype=np.float64)[:, None, :]
    b = np.asarray(b, dtype=np.float64)[None, :, :]
    ax1, ay1, ax2, ay2 = _split(a)
    bx1, by1, bx2, by2 = _split(b)
    iw = np.maximum(0.0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
    ih = np.maximum(0.0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    iou = np.where(union > 0, inter / np.where(union == 0, 1.0, union), 0.0)
    ex1, ey1 = np.minimum(ax1, bx1), np.minimum(ay1, by1)
    ex2, ey2 = np.maximum(ax2, bx2), np.maximum(ay2, by2)
    c_area = (ex2 - ex1) * (ey2 - ey1)
    giou = np.where(c_area == 0, iou, iou - (c_area - union) / np.where(c_area == 0, 1.0, c_area))
    return (giou + 1.0) / 2.0


def pairwise_l1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sum of absolute coordinate differences, pairwise."""
    a = np.asarray(a, dtype=np.float64)[:, None, :]
    b = np.asarray(b, dtype=np.float64)[None, :, :]
    return np.sum(np.abs(a - b), axis=-1)


# scalar conveniences (used by tests and by per-pair paths)
def iou(box_a, box_b) -> float:
    return float(pairwise_iou(np.asarray([box_a]), np.asarray([box_b]))[0, 0])


def ciou(box_a, box_b) -> float:
    return float(pairwise_ciou(np.asarray([box_a]), np.asarray([box_b]))[0, 0])


def giou(box_a, box_b) -> float:
    return float(pairwise_giou(np.asarray([box_a]), np.asarray([box_b]))[0, 0])


def box_l1(box_a, box_b) -> float:
    return float(np.sum(np.abs(np.asarray(box_a, dtype=np.float64) - np.asarray(box_b, dtype=np.float64))))


def scale_boxes(boxes: np.ndarray, sw: float, sh: float) -> np.ndarray:
    boxes = np.asarray(boxes, dtype=np.float64).copy()
    boxes[..., 0] *= sw
    boxes[..., 2] *= sw
    boxes[..., 1] *= sh
    boxes[..., 3] *= sh
    return boxes
