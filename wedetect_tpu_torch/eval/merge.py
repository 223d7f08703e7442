"""Multi-query prediction merging for grounding evaluation.

Behavioral spec: reference wedetect_ref/eval_grounding/eval.py:1585-1625
— after scoring every (query, proposal) pair:

multi-query mode (default):
  1. flatten query-major: boxes tiled per query, label = query index
  2. if >1000 candidates keep the top 1000 by score
  3. optional class-aware NMS (torchvision batched_nms, IoU 0.7)
  4. score_thre > 0: keep scores above it; else top `num_select`

single_box mode (REC):
  per proposal take the max over queries (label = argmax query);
  optional class-aware NMS.

All host-side numpy: inputs are tiny (<= queries x 100) and this runs
after the LLM forward, so there is nothing to win on device. The port's
copy of `wedetect_tpu.eval.merge`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def nms_numpy(boxes: np.ndarray, scores: np.ndarray,
              iou_thr: float) -> np.ndarray:
    """Greedy NMS, torchvision semantics (sort by score desc, stable
    on ties by original index). Returns kept indices in that order."""
    order = np.argsort(-scores, kind="mergesort")
    boxes = boxes.astype(np.float64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order])
        yy1 = np.maximum(y1[i], y1[order])
        xx2 = np.minimum(x2[i], x2[order])
        yy2 = np.minimum(y2[i], y2[order])
        inter = (np.clip(xx2 - xx1, 0, None)
                 * np.clip(yy2 - yy1, 0, None))
        union = areas[i] + areas[order] - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        suppressed[order[iou > iou_thr]] = True
    return np.asarray(keep, np.int64)


def batched_nms_numpy(boxes: np.ndarray, scores: np.ndarray,
                      labels: np.ndarray,
                      iou_thr: float) -> np.ndarray:
    """Class-aware NMS via the coordinate-offset trick
    (torchvision.ops.batched_nms semantics)."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    max_coord = boxes.max() if boxes.size else 0.0
    offsets = labels.astype(np.float64) * (max_coord + 1.0)
    shifted = boxes.astype(np.float64) + offsets[:, None]
    return nms_numpy(shifted, scores, iou_thr)


def merge_predictions(scores_qn: np.ndarray, proposals: np.ndarray, *,
                      single_box: bool = False, nms: bool = False,
                      score_thre: float = -1.0, num_select: int = 300,
                      nms_iou: float = 0.7, cap: int = 1000
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """scores_qn (Q, N) per-query proposal scores; proposals (N, 4).

    Returns (boxes (M, 4), labels (M,) query indices, scores (M,)).
    """
    scores_qn = np.asarray(scores_qn, np.float64)
    proposals = np.asarray(proposals, np.float64).reshape(-1, 4)
    q, n = scores_qn.shape
    if not single_box:
        boxes = np.tile(proposals, (q, 1))
        labels = np.repeat(np.arange(q), n)
        scores = scores_qn.reshape(-1)
        if len(boxes) > cap:
            top = np.argsort(-scores, kind="mergesort")[:cap]
            boxes, labels, scores = boxes[top], labels[top], scores[top]
        if nms:
            keep = batched_nms_numpy(boxes, scores, labels, nms_iou)
            boxes, labels, scores = boxes[keep], labels[keep], scores[keep]
        if score_thre > 0:
            m = scores > score_thre
            boxes, labels, scores = boxes[m], labels[m], scores[m]
        else:
            top = np.argsort(-scores, kind="mergesort")[
                :min(num_select, len(scores))]
            boxes, labels, scores = boxes[top], labels[top], scores[top]
    else:
        labels = scores_qn.argmax(axis=0)
        scores = scores_qn.max(axis=0)
        boxes = proposals
        if nms:
            keep = batched_nms_numpy(boxes, scores, labels, nms_iou)
            boxes, labels, scores = boxes[keep], labels[keep], scores[keep]
    return boxes, labels.astype(np.int64), scores
