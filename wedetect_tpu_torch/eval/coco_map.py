"""COCO-style bbox mAP evaluator (numpy, pycocotools-compatible).

Re-implements the COCOeval bbox protocol the reference relies on via
mmdet CocoMetric (behavioral spec: config/wedetect_base.py:180-186,
test.py:129-146; COCO evaluation as defined by the published
cocoapi semantics):

- IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1
- greedy per-image matching: detections sorted by score, each matched
  to the unmatched gt with highest IoU >= thr (ties -> earlier gt);
  crowd gts can absorb multiple detections and don't count as misses
- area ranges all / small(<32^2) / medium / large(>96^2), maxDets 100
- AP = mean over 101-point interpolated precision, averaged over
  classes present in the gt

The implementation is vectorized per (image, class) with numpy on host;
the detector side feeds fixed-slot Detections with validity masks. A
copy of `wedetect_tpu.eval.coco_map`, with one change: the greedy
matcher is the native one (`native.coco_match`, built from the port's
own copy of coco_match.cc; a failed build raises), and its plain
Python version (`coco_match_python`) runs only when asked for
(`CocoEvaluator(..., matcher="python")`).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from wedetect_tpu_torch.native import coco_match

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def box_iou_xyxy(a: np.ndarray, b: np.ndarray,
                 iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """IoU matrix (len(a), len(b)); crowd columns use intersection/area_a."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:4] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:4] - b[:, :2], 0, None), -1)
    union = area_a[:, None] + area_b[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    if iscrowd is not None and iscrowd.any():
        crowd_iou = np.where(area_a[:, None] > 0,
                             inter / np.maximum(area_a[:, None], 1e-12),
                             0.0)
        iou = np.where(iscrowd[None, :], crowd_iou, iou)
    return iou



def coco_match_python(iou: np.ndarray, gt_ig: np.ndarray,
                      crowd: np.ndarray, thrs: Sequence[float]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of `native.coco_match`, the same contract:
    detections (rows of iou, in score order) each take the unmatched gt
    with the highest IoU at or above the threshold (ties to the earlier
    gt; crowd gts rematch; once a non-ignored gt matched, ignored ones
    are not considered). Returns (dtm (T, nd), gtm (T, ng)), -1 for
    none."""
    nd, ng = iou.shape
    t = len(thrs)
    dtm = np.full((t, nd), -1, np.int64)
    gtm = np.full((t, ng), -1, np.int64)
    for ti, thr in enumerate(thrs):
        for di in range(nd):
            best, bi = min(thr, 1 - 1e-10), -1
            for gi in range(ng):
                # gt already matched (crowds can rematch)
                if gtm[ti, gi] >= 0 and not crowd[gi]:
                    continue
                # non-ignored match found, moving on to ignored gts ->
                # stop
                if bi > -1 and not gt_ig[bi] and gt_ig[gi]:
                    break
                if iou[di, gi] < best:
                    continue
                best, bi = iou[di, gi], gi
            if bi == -1:
                continue
            dtm[ti, di] = bi
            gtm[ti, bi] = di
    return dtm, gtm


class CocoEvaluator:
    """Accumulates per-image detections and computes COCO bbox metrics.

    gt format per image: dict with
        boxes (N, 4) xyxy, labels (N,), iscrowd (N,) bool,
        areas (N,) (annotation 'area'; falls back to box area)
    det format per image: boxes (M, 4) xyxy, scores (M,), labels (M,)

    matcher: "native" (the C++ matcher, built on first use) or "python"
    (its plain version, `coco_match_python`).
    """

    def __init__(self, class_ids: Sequence[int],
                 max_dets: int = 100, matcher: str = "native"):
        if matcher not in ("native", "python"):
            raise ValueError(f"matcher must be 'native' or 'python', "
                             f"got {matcher!r}")
        self.class_ids = list(class_ids)
        self.max_dets = max_dets
        self.matcher = matcher
        # eval_imgs[(img_idx, cls)] -> per-image match record
        self._records: List[Tuple] = []
        self._gt_counts: Dict[int, int] = collections.defaultdict(int)

    def add_image(self, gt: Dict[str, np.ndarray],
                  det_boxes: np.ndarray, det_scores: np.ndarray,
                  det_labels: np.ndarray) -> None:
        det_boxes = np.asarray(det_boxes, np.float64)
        det_scores = np.asarray(det_scores, np.float64)
        det_labels = np.asarray(det_labels)
        gt_boxes = np.asarray(gt["boxes"], np.float64)
        gt_labels = np.asarray(gt["labels"])
        iscrowd = np.asarray(gt.get("iscrowd",
                                    np.zeros(len(gt_boxes), bool)), bool)
        areas = np.asarray(gt.get("areas", np.prod(
            np.clip(gt_boxes[:, 2:4] - gt_boxes[:, :2], 0, None), -1)
            if len(gt_boxes) else np.zeros(0)), np.float64)

        for cls in np.unique(np.concatenate([gt_labels, det_labels])
                             if len(gt_labels) or len(det_labels)
                             else np.zeros(0, np.int64)):
            g = gt_labels == cls
            d = det_labels == cls
            self._eval_img(int(cls), gt_boxes[g], iscrowd[g], areas[g],
                           det_boxes[d], det_scores[d])

    def _eval_img(self, cls, gtb, gtcrowd, gtarea, dtb, dts):
        """Match one (image, class) pair at all IoU thrs / area ranges."""
        t = len(IOU_THRS)
        dorder = np.argsort(-dts, kind="mergesort")[:self.max_dets]
        dtb, dts = dtb[dorder], dts[dorder]
        iou_full = box_iou_xyxy(dtb, gtb, gtcrowd)

        nd = len(dtb)
        rec = {}
        for aname, (amin, amax) in AREA_RNG.items():
            # pycocotools sorts gts by the FULL per-range ignore flag
            # (crowd OR area outside range) before matching
            gt_ig0 = gtcrowd | (gtarea < amin) | (gtarea > amax)
            order = np.argsort(gt_ig0, kind="mergesort")
            gt_ig = gt_ig0[order]
            crowd = gtcrowd[order]
            iou = iou_full[:, order]
            ng = len(order)

            if self.matcher == "native" and nd and ng:
                dtm, gtm = coco_match(iou, gt_ig, crowd, IOU_THRS)
            else:
                dtm, gtm = coco_match_python(iou, gt_ig, crowd, IOU_THRS)
            # det ignored: matched to ignored gt, or unmatched with
            # det area outside range
            darea = np.prod(np.clip(dtb[:, 2:4] - dtb[:, :2], 0, None),
                            -1) if nd else np.zeros(0)
            dt_out = (darea < amin) | (darea > amax)
            dt_ig = np.zeros((t, nd), bool)
            for ti in range(t):
                m = dtm[ti]
                dt_ig[ti] = np.where(
                    m >= 0, gt_ig[np.clip(m, 0, None)] if ng else False,
                    dt_out)
            num_gt = int((~gt_ig).sum())
            rec[aname] = (dtm >= 0) & ~dt_ig, dt_ig, dts.copy(), num_gt
        self._records.append((cls, rec))

    def summarize(self) -> Dict[str, float]:
        """Returns mAP, AP50, AP75, APs, APm, APl (+ per-class)."""
        by_cls: Dict[Tuple[int, str], List] = collections.defaultdict(list)
        for cls, rec in self._records:
            for aname, r in rec.items():
                by_cls[(cls, aname)].append(r)

        t, r = len(IOU_THRS), len(REC_THRS)
        classes = sorted({c for c, _ in by_cls})
        precisions = {a: np.full((t, r, len(classes)), -1.0)
                      for a in AREA_RNG}
        for ci, cls in enumerate(classes):
            for aname in AREA_RNG:
                recs = by_cls.get((cls, aname), [])
                if not recs:
                    continue
                num_gt = sum(x[3] for x in recs)
                if num_gt == 0:
                    continue
                matched = np.concatenate([x[0] for x in recs], axis=1)
                ignored = np.concatenate([x[1] for x in recs], axis=1)
                scores = np.concatenate([x[2] for x in recs])
                order = np.argsort(-scores, kind="mergesort")
                matched, ignored = matched[:, order], ignored[:, order]
                for ti in range(t):
                    keep = ~ignored[ti]
                    tp = np.cumsum(matched[ti][keep])
                    fp = np.cumsum(~matched[ti][keep])
                    nd = len(tp)
                    rc = tp / num_gt if nd else np.zeros(0)
                    pr = tp / np.maximum(tp + fp, 1e-12)
                    # monotone precision envelope
                    for i in range(nd - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    idx = np.searchsorted(rc, REC_THRS, side="left")
                    prec = np.zeros(r)
                    ok = idx < nd
                    prec[ok] = pr[idx[ok]]
                    precisions[aname][ti, :, ci] = prec

        def ap(aname, ti=None):
            p = precisions[aname]
            if ti is not None:
                p = p[ti:ti + 1]
            valid = p > -1
            return float(p[valid].mean()) if valid.any() else float("nan")

        out = {
            "mAP": ap("all"),
            "AP50": ap("all", 0),
            "AP75": ap("all", 5),
            "APs": ap("small"),
            "APm": ap("medium"),
            "APl": ap("large"),
        }
        # per-class AP over the "all" range (COCOeval
        # precision[:, :, i, 0, -1].mean() — the D3 per-length
        # breakdown consumes this, dod_metric.py:94-101)
        per_class = {}
        for ci, cls in enumerate(classes):
            p = precisions["all"][:, :, ci]
            v = p > -1
            per_class[int(cls)] = (float(p[v].mean()) if v.any()
                                   else float("nan"))
        out["per_class"] = per_class
        return out
