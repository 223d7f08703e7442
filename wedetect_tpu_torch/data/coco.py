"""COCO/LVIS dataset readers from raw annotation JSON (no pycocotools).

Behavioral spec: reference wedetect/datasets/yolov5_coco.py:10-65,
yolov5_lvis.py:9-14, wecoco.py:10-26 (mmdet CocoDataset semantics:
category ids sorted, mapped to contiguous labels; images without
annotations kept in test mode) and mm_dataset.py:14-93
(MultiModalDataset: texts injected from a class-text JSON of the form
[[name, synonym, ...], ...]).

Host-side, numpy-only; a copy of `wedetect_tpu.data.coco`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class CocoDetDataset:
    """Detection dataset over a COCO-format annotation file."""

    def __init__(self, ann_file: str, img_root: str,
                 test_mode: bool = True,
                 class_text_path: Optional[str] = None,
                 filter_empty: bool = False):
        with open(ann_file) as f:
            coco = json.load(f)
        self.cats = sorted(coco["categories"], key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in self.cats]
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.class_names = [c["name"] for c in self.cats]

        anns_by_img: Dict[int, List[dict]] = {}
        for a in coco["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.items: List[dict] = []
        for img in coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            if filter_empty and not test_mode and not anns:
                continue
            # LVIS stores the path in coco_url/file_name variants
            fname = img.get("file_name")
            if fname is None and "coco_url" in img:
                fname = "/".join(img["coco_url"].split("/")[-2:])
            self.items.append({
                "img_id": img["id"],
                "path": os.path.join(img_root, fname),
                "width": img["width"], "height": img["height"],
                "anns": anns,
                # LVIS per-image category domains
                "neg_cats": [self.cat2label.get(c, -1) for c in
                             img.get("neg_category_ids", [])],
                "not_exhaustive": [self.cat2label.get(c, -1) for c in
                                   img.get(
                                       "not_exhaustive_category_ids",
                                       [])],
            })
        self.texts = None
        if class_text_path:
            self.texts = load_class_texts(class_text_path)
        # LVIS category frequency groups (r/c/f) when present
        self.frequencies = {
            self.cat2label[c["id"]]: c["frequency"]
            for c in self.cats if c.get("frequency") in ("r", "c", "f")
        } or None

    def __len__(self) -> int:
        return len(self.items)

    def gt_arrays(self, idx: int) -> Dict[str, np.ndarray]:
        """GT in evaluator format (xyxy boxes, labels, iscrowd, areas)."""
        anns = self.items[idx]["anns"]
        n = len(anns)
        boxes = np.zeros((n, 4), np.float32)
        labels = np.zeros((n,), np.int64)
        iscrowd = np.zeros((n,), bool)
        areas = np.zeros((n,), np.float64)
        for i, a in enumerate(anns):
            x, y, w, h = a["bbox"]
            boxes[i] = (x, y, x + w, y + h)
            labels[i] = self.cat2label[a["category_id"]]
            iscrowd[i] = bool(a.get("iscrowd", 0))
            areas[i] = a.get("area", w * h)
        return {"boxes": boxes, "labels": labels, "iscrowd": iscrowd,
                "areas": areas}

    def train_arrays(self, idx: int, max_gt: int
                     ) -> Dict[str, np.ndarray]:
        """Zero-padded gt arrays for the static train graph
        (crowd annotations dropped, as in mmdet train filtering)."""
        g = self.gt_arrays(idx)
        keep = ~g["iscrowd"]
        boxes, labels = g["boxes"][keep][:max_gt], g["labels"][keep][:max_gt]
        n = len(boxes)
        out_b = np.zeros((max_gt, 4), np.float32)
        out_l = np.zeros((max_gt,), np.int32)
        out_m = np.zeros((max_gt,), bool)
        out_b[:n], out_l[:n], out_m[:n] = boxes, labels, True
        return {"gt_bboxes": out_b, "gt_labels": out_l, "gt_mask": out_m}


def load_class_texts(path: str) -> List[List[str]]:
    """[[name, synonym, ...], ...] per class (reference
    data/texts/*_class_texts.json format)."""
    with open(path) as f:
        return json.load(f)


class MultiModalMixedDataset:
    """Marks each sample with is_detection (reference
    mm_dataset.py:97-125, MultiModalMixedDataset) so mixed
    grounding/detection training can branch on sample provenance."""

    def __init__(self, dataset, is_detection: int = 1):
        self.dataset = dataset
        self.is_detection = is_detection
        self.texts = getattr(dataset, "texts", None)

    def __len__(self):
        return len(self.dataset)

    def sample(self, idx: int) -> Dict:
        out = dict(self.dataset.sample(idx))
        out["is_detection"] = self.is_detection
        return out


def first_texts(texts: Sequence[Sequence[str]]) -> List[str]:
    """LoadText semantics: first synonym of each class (reference
    datasets/transformers/mm_transforms.py:107-135)."""
    return [t[0] for t in texts]
