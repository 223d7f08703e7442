"""LVIS bbox AP evaluator (fixed-AP protocol).

Behavioral spec: the published LVIS evaluation protocol as used by the
reference's LVISMetric (config/wedetect_base.py:187-195; BASELINE.md
notes "LVIS metrics are fixed AP"):

- per-image CATEGORY DOMAIN: category c is evaluated on image i only
  if c is positively annotated (has gt) or in the image's
  `neg_category_ids` (verified absent). Detections of other
  categories on that image are EXCLUDED (neither TP nor FP).
- categories in `not_exhaustive_category_ids` are present but not
  fully annotated: unmatched detections of those categories are
  ignored rather than counted as false positives.
- fixed AP (Dave et al.): no per-image detection budget; instead a
  per-category cap of 10k detections across the dataset. The cap
  selects the global top-k BY SCORE BEFORE matching (exactly k kept
  on score ties, stable in image order) — the protocol caps the
  submitted result file, so a capped-out detection never participates
  in matching (it cannot absorb a gt from a kept detection; the
  round-4 implementation filtered records post-match, which the
  differential oracle in tests/lvis_oracle.py distinguishes).
- APr/APc/APf: AP averaged over rare (<10 imgs), common (10-100) and
  frequent (>100) categories by training-image frequency.

add_image() buffers domain-filtered inputs; the dataset-wide cap is
only known once every image is in, so matching runs in summarize()
(idempotent — records are rebuilt per call). A copy of
`wedetect_tpu.eval.lvis_map`; `matcher` picks the COCO core's matcher
("native" or its plain version "python", eval/coco_map.py).
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Set

import numpy as np

from wedetect_tpu_torch.eval.coco_map import CocoEvaluator


class LvisEvaluator(CocoEvaluator):
    def __init__(self, class_ids: Sequence[int],
                 per_class_cap: int = 10000,
                 frequencies: Optional[Dict[int, str]] = None,
                 matcher: str = "native"):
        super().__init__(class_ids, max_dets=per_class_cap,
                         matcher=matcher)
        self.per_class_cap = per_class_cap
        # frequencies: {label: 'r'|'c'|'f'}
        self.frequencies = frequencies or {}
        # buffered (gt, det_boxes, det_scores, det_labels,
        # not_exhaustive) per image, dets already domain-filtered
        self._images = []

    def add_image(self, gt, det_boxes, det_scores, det_labels,
                  neg_cats: Optional[Set[int]] = None,
                  not_exhaustive: Optional[Set[int]] = None) -> None:
        neg_cats = set(neg_cats or ())
        not_exhaustive = set(not_exhaustive or ())
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float64)
        det_labels = np.asarray(det_labels)
        gt_labels = np.asarray(gt["labels"])
        pos_cats = set(int(c) for c in gt_labels)
        domain = pos_cats | neg_cats

        keep = np.array([int(c) in domain for c in det_labels], bool) \
            if len(det_labels) else np.zeros(0, bool)
        self._images.append((gt, det_boxes[keep], det_scores[keep],
                             det_labels[keep], not_exhaustive))

    def summarize(self) -> Dict[str, float]:
        # 1. fixed-AP per-category dataset-wide cap: global top-k by
        # score per class, stable ties (image order, then submission
        # order within the image), applied BEFORE matching
        by_cls = collections.defaultdict(list)  # cls -> (score, i, j)
        for i, (_gt, _db, ds, dl, _ne) in enumerate(self._images):
            for j, c in enumerate(dl):
                by_cls[int(c)].append((float(ds[j]), i, j))
        dropped = set()
        for c, lst in by_cls.items():
            if len(lst) <= self.per_class_cap:
                continue
            order = sorted(range(len(lst)), key=lambda k: -lst[k][0])
            for k in order[self.per_class_cap:]:
                dropped.add((lst[k][1], lst[k][2]))

        # 2. match every image through the COCO core (rebuilt per
        # call — summarize is idempotent over the buffered inputs)
        self._records = []
        for i, (gt, db, ds, dl, not_exhaustive) in \
                enumerate(self._images):
            if dropped:
                keep = np.array([(i, j) not in dropped
                                 for j in range(len(dl))], bool)
                db, ds, dl = db[keep], ds[keep], dl[keep]
            n_before = len(self._records)
            super().add_image(gt, db, ds, dl)
            # 3. not-exhaustive classes: unmatched dets -> ignored
            for idx in range(n_before, len(self._records)):
                cls, rec = self._records[idx]
                if cls in not_exhaustive:
                    new_rec = {}
                    for aname, (matched, ignored, scores, num_gt) in \
                            rec.items():
                        ignored = ignored | ~matched
                        new_rec[aname] = (matched, ignored, scores,
                                          num_gt)
                    self._records[idx] = (cls, new_rec)

        base = super().summarize()
        if self.frequencies:
            per_class = base["per_class"]
            for tag, name in (("r", "APr"), ("c", "APc"),
                              ("f", "APf")):
                vals = [v for c, v in per_class.items()
                        if self.frequencies.get(c) == tag
                        and not np.isnan(v)]
                base[name] = float(np.mean(vals)) if vals else \
                    float("nan")
        return base


def lvis_frequencies_from_ann(coco_json: dict,
                              cat2label) -> Dict[int, str]:
    """{label: 'r'|'c'|'f'} from LVIS categories' `frequency` field."""
    out = {}
    for c in coco_json.get("categories", []):
        f = c.get("frequency")
        if f in ("r", "c", "f") and c["id"] in cat2label:
            out[cat2label[c["id"]]] = f
    return out
