"""Proposal recall evaluation (Recall@N over IoU thresholds).

Behavioral spec: reference eval_recall/recall.py:60-178 — for each
image, greedily match gts to proposals (repeatedly take the (gt,
proposal) pair with max IoU, remove both), collect per-gt best IoUs,
then recall@thr = fraction of gts with matched IoU >= thr. The
headline metric is mean recall over IoU .5:.05:.95 at N in {100, 300}
(eval_recall/eval_recall.py:41-70). A copy of
`wedetect_tpu.eval.recall`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from wedetect_tpu_torch.eval.coco_map import box_iou_xyxy

DEFAULT_IOU_THRS = np.arange(0.5, 0.96, 0.05)


def _greedy_gt_ious(ious: np.ndarray) -> np.ndarray:
    """Per-gt matched IoU via the reference's iterative max matching."""
    ious = ious.copy()
    ng = ious.shape[0]
    gt_ious = np.zeros((ng,), np.float32)
    if ious.size == 0:
        return gt_ious
    for j in range(ng):
        gt_max = ious.argmax(axis=1)
        max_ious = ious[np.arange(ng), gt_max]
        gi = max_ious.argmax()
        gt_ious[j] = max_ious[gi]
        bi = gt_max[gi]
        ious[gi, :] = -1
        ious[:, bi] = -1
    return gt_ious


def eval_recalls(gts: Sequence[np.ndarray],
                 proposals: Sequence[np.ndarray],
                 proposal_nums: Sequence[int] = (100, 300),
                 iou_thrs: Optional[np.ndarray] = None) -> np.ndarray:
    """recalls[n_idx, thr_idx]. gts: per-image (G, 4) xyxy; proposals:
    per-image (P, 4) or (P, 5) with trailing score (sorted desc if 5).
    """
    iou_thrs = (DEFAULT_IOU_THRS if iou_thrs is None
                else np.asarray(iou_thrs))
    proposal_nums = np.asarray(proposal_nums)
    total_gt = sum(0 if g is None else len(g) for g in gts)
    per_n_ious = np.zeros((len(proposal_nums), max(total_gt, 1)),
                          np.float32)
    for k, pn in enumerate(proposal_nums):
        pos = 0
        for g, p in zip(gts, proposals):
            if g is None or len(g) == 0:
                continue
            p = np.asarray(p)
            if p.ndim == 2 and p.shape[1] == 5:
                p = p[np.argsort(-p[:, 4], kind="mergesort")]
            ious = box_iou_xyxy(np.asarray(g, np.float64),
                                p[:pn, :4].astype(np.float64))
            per_n_ious[k, pos:pos + len(g)] = _greedy_gt_ious(
                ious.astype(np.float32))
            pos += len(g)
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    for i, thr in enumerate(iou_thrs):
        recalls[:, i] = (per_n_ious >= thr).sum(axis=1) / max(total_gt, 1)
    return recalls


def summarize_recalls(recalls: np.ndarray,
                      proposal_nums: Sequence[int] = (100, 300)
                      ) -> Dict[str, float]:
    """Mean recall over the IoU sweep per proposal budget (the
    reference's AR@100/AR@300 headline)."""
    return {f"AR@{n}": float(recalls[i].mean())
            for i, n in enumerate(proposal_nums)}
