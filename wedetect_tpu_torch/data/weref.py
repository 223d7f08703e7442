"""VLM-tagged referring dataset with fallback-on-error.

Behavioral spec: reference wedetect/datasets/weref.py:22-156
(WeRefDataset): per-image jsonl `ref_infos` keyed by image stem; each
annotation carries VLM tags (the LAST tag is the class text) and a
sam2 box (xywh); a mixed_ratio gate falls back to the base (detection)
labels; bad samples fall back to a previously successful index; a
negative-text queue enriches the class list. The port of
`wedetect_tpu.data.weref` on the port's `data/wds.NegQueue`: the same
gate, rewrites, fallback and numpy generator, drawn in the same order.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from wedetect_tpu_torch.data.wds import NegQueue


class WeRefDataset:
    """Wraps a base dataset (sample(idx) -> {image, gt_bboxes,
    gt_labels, texts, img_path}) with VLM referring annotations."""

    def __init__(self, base, ref_root: str, mixed_ratio: float = 0.5,
                 use_negative_queue: bool = True,
                 use_sam_box: bool = True, seed: int = 0):
        self.base = base
        self.mixed_ratio = mixed_ratio
        self.use_sam_box = use_sam_box
        self.neg_queue = NegQueue(80) if use_negative_queue else None
        self.rng = np.random.default_rng(seed)
        self.success_ids: set = set()
        self.error_ids: set = set()
        self.ref_infos: Dict[str, List[dict]] = {}
        for fname in sorted(os.listdir(ref_root)):
            if not fname.endswith(".jsonl"):
                continue
            with open(os.path.join(ref_root, fname)) as f:
                for line in f:
                    data = json.loads(line.strip())
                    anns = data["annotations"]
                    for ann in anns:
                        if ann.get("vlm") == "ERROR":
                            ann["vlm"] = {"tags": ["object"],
                                          "neg_tags": []}
                    self.ref_infos[data["key"]] = anns

    def __len__(self) -> int:
        return len(self.base)

    def _fallback(self, idx: int) -> Dict:
        self.error_ids.add(idx)
        if self.success_ids:
            j = int(self.rng.choice(sorted(self.success_ids)))
            return self.sample(j)
        return self.base.sample(0)

    def sample(self, idx: int) -> Dict:
        if self.rng.integers(0, 101) > self.mixed_ratio * 100:
            return self.base.sample(idx)
        info = self.base.sample(idx)
        key = os.path.basename(info.get("img_path", "")).split(".")[0]
        anns = self.ref_infos.get(key)
        if anns is None:
            return self._fallback(idx)
        texts: List[str] = []
        text2cat: Dict[str, int] = {}
        boxes, labels = [], []
        for ann in anns:
            if "bbox" not in ann:
                return self._fallback(idx)
            tags = (ann.get("vlm") or {}).get("tags") or []
            if not tags:
                return self._fallback(idx)
            text = tags[-1]
            if text not in text2cat:
                text2cat[text] = len(texts)
                texts.append(text)
            x, y, w, h = (ann["sam2_bbox"] if self.use_sam_box
                          else ann["bbox"])
            boxes.append([x, y, x + w, y + h])
            labels.append(text2cat[text])
        if not boxes:
            return self._fallback(idx)
        if self.neg_queue is not None:
            enriched = self.neg_queue.enrich([[t] for t in texts])
            self.neg_queue.update(enriched)
            texts = [t[0] for t in enriched]
        self.success_ids.add(idx)
        out = dict(info)
        out["gt_bboxes"] = np.asarray(boxes, np.float32)
        out["gt_labels"] = np.asarray(labels, np.int64)
        out["texts"] = texts
        return out
