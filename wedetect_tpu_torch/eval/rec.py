"""Referring-expression comprehension metrics (top-k accuracy).

Behavioral spec: reference
wedetect_ref/eval_grounding/eval.py:1102-1341 (eval_refcoco): per
query, rank proposals by score; acc@k = fraction of queries whose
top-k boxes contain one with IoU >= 0.5 against any gt box. The port's
copy of `wedetect_tpu.eval.rec`, on the port's own `box_iou_xyxy`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from wedetect_tpu_torch.eval.coco_map import box_iou_xyxy


def rec_topk_accuracy(pred_boxes: Sequence[np.ndarray],
                      gt_boxes: Sequence[np.ndarray],
                      topk: Tuple[int, ...] = (1, 5, 10),
                      iou_thr: float = 0.5) -> Dict[str, float]:
    """pred_boxes: per-query (N, 4) already sorted by descending score;
    gt_boxes: per-query (G, 4)."""
    scores = {k: 0.0 for k in topk}
    n = 0
    for pred, gt in zip(pred_boxes, gt_boxes):
        pred = np.asarray(pred, np.float64).reshape(-1, 4)
        gt = np.asarray(gt, np.float64).reshape(-1, 4)
        if len(gt) == 0:
            continue
        iou = box_iou_xyxy(pred, gt).max(axis=1) if len(pred) else \
            np.zeros(0)
        for k in topk:
            if len(iou) and iou[:k].max() >= iou_thr:
                scores[k] += 1.0
        n += 1
    return {f"acc@{k}": (scores[k] / n if n else 0.0) for k in topk}


def score_and_rank(proposals: np.ndarray, scores: np.ndarray,
                   num_select: int = 20) -> np.ndarray:
    """Sort proposals by score desc, keep top num_select
    (reference --num_select 20, wedetect_ref/README.md:22)."""
    order = np.argsort(-scores, kind="mergesort")[:num_select]
    return np.asarray(proposals)[order]
