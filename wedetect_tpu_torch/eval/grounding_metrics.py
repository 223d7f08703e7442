"""Grounding benchmark metrics: gRefCOCO, HumanRef DensityF1, D3.

Behavioral specs:
- gRefCOCO (reference eval_grounding/grefcoco_metric.py:13-108):
  per image, greedy one-to-one IoU matching between predictions and
  gts; F1 per image thresholded at 1.0 -> F1_score; plus
  no-target accuracy (N-acc) and target accuracy (T-acc)
- HumanRef DensityF1 (recall_precision_densityf1.py:29-135):
  one-to-one matching recall/precision; density-aware F1 =
  F1 * min(1, gt_density / pred_density); rejection cases score 1
  when the prediction set is empty
- D3 (dod_metric.py:10-162) evaluates with plain COCO AP over
  sentence-id categories -> the port's eval/coco_map.

The port's copy of `wedetect_tpu.eval.grounding_metrics`, on the port's
own `box_iou_xyxy`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from wedetect_tpu_torch.eval.coco_map import box_iou_xyxy


def grefcoco_metrics(results: Sequence[Dict],
                     iou_thr: float = 0.5,
                     thresh_f1: float = 1.0) -> Dict[str, float]:
    """results: per-image dicts {pred_boxes (P,4), gt_boxes (G,4),
    no_target (bool)}."""
    correct = 0
    nt = {"TP": 0, "TN": 0, "FP": 0, "FN": 0}
    for r in results:
        pred = np.asarray(r["pred_boxes"], np.float64).reshape(-1, 4)
        gt = np.asarray(r["gt_boxes"], np.float64).reshape(-1, 4)
        if r.get("no_target", False):
            if len(pred) >= 1:
                nt["FN"] += 1
                f1 = 0.0
            else:
                nt["TP"] += 1
                f1 = 1.0
        else:
            nt["TN" if len(pred) >= 1 else "FP"] += 1
            iou = box_iou_xyxy(pred, gt)
            tp = 0
            for _ in range(min(len(pred), len(gt))):
                if iou.size == 0 or iou.max() < iou_thr:
                    break
                i, j = np.unravel_index(iou.argmax(), iou.shape)
                tp += 1
                iou[i, :] = 0.0
                iou[:, j] = 0.0
            fp = len(pred) - tp
            fn = len(gt) - tp
            f1 = 2 * tp / max(2 * tp + fp + fn, 1)
        if f1 >= thresh_f1:
            correct += 1
    n = max(len(results), 1)
    return {
        "F1_score": correct / n,
        "T_acc": nt["TN"] / max(nt["TN"] + nt["FP"], 1),
        "N_acc": nt["TP"] / max(nt["TP"] + nt["FN"], 1),
    }


def _match_one_to_one(gt: np.ndarray, pred: np.ndarray,
                      iou_thr: float = 0.5):
    """Reference calculate_metrics: per gt (in order), take the best
    still-unused prediction with IoU >= thr."""
    if len(gt) == 0:
        return (1.0, 1.0) if len(pred) == 0 else (0.0, 0.0)
    if len(pred) == 0:
        return 0.0, 0.0
    iou = box_iou_xyxy(gt, pred)
    used = np.zeros(len(pred), bool)
    matches = 0
    for g in range(len(gt)):
        cand = np.where(~used, iou[g], -1.0)
        best = cand.argmax()
        if cand[best] >= iou_thr:
            matches += 1
            used[best] = True
    return matches / len(gt), matches / len(pred)


def humanref_density_f1(results: Sequence[Dict],
                        iou_thr: float = 0.5) -> Dict[str, float]:
    """results: per-query dicts {pred_boxes (P,4), gt_boxes (G,4),
    total_persons (int), rejection (bool)}.
    Returns macro precision / recall / density-F1 and rejection
    accuracy."""
    precisions, recalls, f1s = [], [], []
    rej_total, rej_correct = 0, 0
    for r in results:
        pred = np.asarray(r["pred_boxes"], np.float64).reshape(-1, 4)
        gt = np.asarray(r["gt_boxes"], np.float64).reshape(-1, 4)
        if r.get("rejection", len(gt) == 0):
            rej_total += 1
            if len(pred) == 0:
                rej_correct += 1
                precisions.append(1.0)
                recalls.append(1.0)
                f1s.append(1.0)
            else:
                precisions.append(0.0)
                recalls.append(0.0)
                f1s.append(0.0)
            continue
        rec, prec = _match_one_to_one(gt, pred, iou_thr)
        total = max(int(r.get("total_persons", len(gt))), 1)
        if prec + rec == 0:
            f1 = 0.0
        else:
            f1 = 2 * prec * rec / (prec + rec)
            gt_density = len(gt) / total
            pred_density = len(pred) / total
            penalty = (min(1.0, gt_density / pred_density)
                       if pred_density > 0 else 0.0)
            f1 = f1 * penalty
        precisions.append(prec)
        recalls.append(rec)
        f1s.append(f1)
    return {
        "precision": float(np.mean(precisions)) if precisions else 0.0,
        "recall": float(np.mean(recalls)) if recalls else 0.0,
        "density_f1": float(np.mean(f1s)) if f1s else 0.0,
        "rejection_acc": (rej_correct / rej_total
                          if rej_total else float("nan")),
    }


def dod_length_breakdown(per_class_ap: Dict[int, float],
                         cat_names: Dict[int, str]) -> Dict[str, float]:
    """D3 mAP grouped by reference-sentence word count
    (reference dod_metric.py:100-141): short 1-3 words, mid 4-6,
    long 7-9, very long 10+. NaN APs (classes absent from the gt)
    are skipped."""
    bins: Dict[str, List[float]] = {"short": [], "mid": [], "long": [],
                                    "very_long": []}
    for cid, ap in per_class_ap.items():
        if cid not in cat_names or np.isnan(ap):
            continue
        n = len(cat_names[cid].split(" "))
        key = ("short" if n < 4 else "mid" if n < 7
               else "long" if n < 10 else "very_long")
        bins[key].append(ap)
    return {f"mAP_{k}": (float(np.mean(v)) if v else float("nan"))
            for k, v in bins.items()}
