"""Grounding benchmark dataset builders (coco / refcoco / grefcoco /
humanref / d3 / odinw).

Behavioral spec: reference wedetect_ref/eval_grounding/eval.py:377-583
(GroundingDataset.__init__/__getitem__). Each builder returns a flat
list of per-image items:

    {"id": int, "image": str, "img_root": str, "dataset": str,
     "queries": [str],          # RAW query text (the scorer applies
                                # the 'Please detect ...' template)
     "query_labels": [int],     # per-query label (category id for
                                # coco/odinw, sentence id for d3)
     "gt_bboxes": [[x1,y1,x2,y2]], "gt_labels": [...],
     "no_target": bool,         # grefcoco
     "rejection": bool, "total_persons": int,   # humanref
     "proposals": [[...]] | None}  # humanref carries its own

The reference clamps proposals and gts to the image size at load time
(eval.py:540-546, 578-583); clamping proposals is RefScorer's job, gts
are clamped here when the image size is known from the annotations.

COCO-format files are parsed with plain json (no pycocotools dep):
annotations grouped by image_id, ignore/iscrowd entries dropped. The
port's copy of `wedetect_tpu.eval.grounding_data`.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Optional, Sequence


def _load_coco_json(path: str):
    data = json.load(open(path))
    anns_by_img: Dict[int, List[dict]] = collections.defaultdict(list)
    for a in data.get("annotations", []):
        anns_by_img[a["image_id"]].append(a)
    cats = sorted(data.get("categories", []), key=lambda c: c["id"])
    return data["images"], anns_by_img, cats


def _xywh_to_xyxy(b):
    x, y, w, h = b
    return [x, y, x + w, y + h]


def _clamp_boxes(boxes, w, h):
    out = []
    for x1, y1, x2, y2 in boxes:
        out.append([max(0, min(w, x1)), max(0, min(h, y1)),
                    max(0, min(w, x2)), max(0, min(h, y2))])
    return out


def build_coco(ann_path: str, img_root: str,
               classes_en: Optional[Sequence[str]] = None
               ) -> List[dict]:
    """COCO-OVD: every image queried with all 80 class names
    (eval.py:389-415). query_labels carry the ORIGINAL category ids;
    the contiguous<->original mapping the reference hardcodes
    (inverse_id_map / id_map) is derived from the categories table."""
    images, anns_by_img, cats = _load_coco_json(ann_path)
    names = (list(classes_en) if classes_en is not None
             else [c["name"] for c in cats])
    cat_ids = [c["id"] for c in cats]
    items = []
    for im in images:
        w, h = im.get("width", 1e9), im.get("height", 1e9)
        gt_boxes, gt_labels = [], []
        for a in anns_by_img.get(im["id"], []):
            if a.get("ignore", False) or a.get("iscrowd", 0):
                continue
            gt_boxes.append(_xywh_to_xyxy(a["bbox"]))
            gt_labels.append(a["category_id"])
        items.append({
            "id": im["id"], "image": im["file_name"],
            "img_root": img_root, "dataset": "coco",
            "queries": names, "query_labels": cat_ids,
            "gt_bboxes": _clamp_boxes(gt_boxes, w, h),
            "gt_labels": gt_labels,
        })
    return items


def build_refcoco(ann_files: Sequence[str], img_root: str
                  ) -> List[dict]:
    """refcoco/+/g: one item per referring annotation
    (eval.py:416-433). Subset = annotation file stem."""
    items = []
    for path in ann_files:
        subset = os.path.basename(path).split(".")[0]
        for ann in json.load(open(path)):
            expr = ann["conversations"][1]["value"]
            items.append({
                "id": ann["id"], "image": ann["image"],
                "img_root": img_root, "dataset": subset,
                "queries": [expr], "query_labels": [0],
                "gt_bboxes": [list(b)
                              for b in ann["bounding_boxes"]],
                "gt_labels": [expr],
            })
    return items


def build_grefcoco(ann_files: Sequence[str], img_root: str,
                   subsets: Sequence[str] = ("val", "testA", "testB")
                   ) -> List[dict]:
    """gRefCOCO: COCO-format files with the caption on the image info
    and category_id == -1 marking no-target (eval.py:434-459,
    grefcoco_metric.py:44-48)."""
    items = []
    for path, subset in zip(ann_files, subsets):
        images, anns_by_img, _ = _load_coco_json(path)
        for im in images:
            w, h = im.get("width", 1e9), im.get("height", 1e9)
            boxes, no_target = [], False
            for a in anns_by_img.get(im["id"], []):
                if a["category_id"] == -1:
                    no_target = True
                if a.get("ignore", False) or a.get("iscrowd", 0):
                    continue
                boxes.append(_xywh_to_xyxy(a["bbox"]))
            cap = im["caption"]
            items.append({
                "id": im["id"], "image": im["file_name"],
                "img_root": img_root, "dataset": subset,
                "queries": [cap], "query_labels": [0],
                "gt_bboxes": _clamp_boxes(boxes, w, h),
                "gt_labels": [cap] * len(boxes),
                "no_target": no_target,
            })
    return items


def build_humanref(ann_path: str, img_root: str) -> List[dict]:
    """HumanRef jsonl: per line one referring query; candidate_boxes
    are BOTH the proposal set and the person-count denominator for
    density-F1 (eval.py:484-507, recall_precision_densityf1.py:150)."""
    items = []
    with open(ann_path, encoding="utf-8") as f:
        for line in f:
            ann = json.loads(line)
            items.append({
                "id": ann["id"], "image": ann["image_name"],
                "img_root": img_root, "dataset": "humanref",
                "queries": [ann["referring"]], "query_labels": [0],
                "gt_bboxes": [list(b) for b in ann["answer_boxes"]],
                "gt_labels": [ann["referring"]]
                * len(ann["answer_boxes"]),
                "rejection": ann.get("domain", "") == "rejection",
                "total_persons": len(ann["candidate_boxes"]),
                "proposals": [list(b)
                              for b in ann["candidate_boxes"]],
            })
    return items


def build_d3(img_root: str, pkl_root: str) -> List[dict]:
    """D3: per image, every sentence of the image's groups becomes a
    query; query_labels carry the sentence ids, which are the COCO
    category ids of the FULL/PRES/ABS annotation jsons
    (eval.py:460-483, :1627-1629). The reference builds identical item
    lists for all three subsets and scores each 3x; here images are
    scored once and each subset json is evaluated on the same merged
    predictions — same metrics, one third the compute."""
    from wedetect_tpu_torch.data.d3 import D3

    d3 = D3(img_root, pkl_root)
    items = []
    for img_id in d3.get_img_ids():
        info = d3.load_imgs(img_id)[0]
        group_ids = d3.get_group_ids(img_ids=[img_id])
        sents = d3.load_sents(d3.get_sent_ids(group_ids=group_ids))
        items.append({
            "id": info["id"], "image": info["file_name"],
            "img_root": img_root, "dataset": "d3",
            "queries": [s["raw_sent"] for s in sents],
            "query_labels": [s["id"] for s in sents],
            "gt_bboxes": [], "gt_labels": [],
        })
    return items


def build_odinw(datasets: Dict[str, dict]) -> List[dict]:
    """ODinW13/35: a dict of {name: {ann_path, img_path, classes_en}}
    (eval.py:508-537); per sub-dataset COCO-style items tagged with
    the sub-dataset name."""
    items = []
    for name, sub in datasets.items():
        for it in build_coco(sub["ann_path"], sub["img_path"],
                             sub.get("classes_en")):
            it["dataset"] = name
            items.append(it)
    return items
