"""WebDataset-style tar streaming for large-scale training.

Behavioral spec: reference wedetect/datasets/wdscoco.py:23-161 (WDSCoco:
resampled tar shards split per node, (jpg, json) pairs, open-vocab
text labels built on the fly with an en->zh map, retry on bad samples,
shared negative-text queue) and weref.py:48-156 (NegQueue).

Implemented without the webdataset dependency: a plain tarfile stream
with shard resampling, per-process splitting, and bounded retry. A copy
of `wedetect_tpu.data.wds`: images are decoded by the port's native
JPEG decoder (`native.decode_jpeg`, C++ with the GIL released), and a
sample it rejects by cv2 (imported on use).
"""

from __future__ import annotations

import glob
import json
import tarfile
from typing import Dict, Iterator, List, Optional

import numpy as np

from wedetect_tpu_torch import native


class NegQueue:
    """Shared pool of recent class texts used as negatives.

    Behavioral spec (reference wedetect/datasets/weref.py:22-44):
    a SET of texts randomly downsampled to `size` when it overflows;
    the literal placeholder "object" is never kept; enrich() appends
    ALL pooled texts not already present (no cap on the output).
    """

    def __init__(self, size: int = 80, seed: int = 0):
        self.size = size
        self.queue: set = set()
        self.rng = np.random.default_rng(seed)

    def enrich(self, class_texts):
        if not class_texts:
            return [[t] for t in sorted(self.queue)]
        if isinstance(class_texts[0], str):
            have = set(class_texts)
            return list(class_texts) + sorted(self.queue - have)
        have = {t for syns in class_texts for t in syns}
        return list(class_texts) + [[t]
                                    for t in sorted(self.queue - have)]

    def update(self, class_texts) -> None:
        flat = []
        for t in class_texts:
            flat.extend([t] if isinstance(t, str) else t)
        self.queue.update(flat)
        if len(self.queue) > self.size:
            self.queue = set(
                self.rng.choice(sorted(self.queue), self.size,
                                replace=False).tolist())
        self.queue.discard("object")


def iter_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Group tar members by key prefix (webdataset convention)."""
    with tarfile.open(path, "r|*") as tf:
        current_key = None
        group: Dict[str, bytes] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            key, _, ext = name.partition(".")
            data = tf.extractfile(member).read()
            if current_key is None:
                current_key = key
            if key != current_key:
                yield group
                group = {}
                current_key = key
            group[ext] = data
        if group:
            yield group


class WdsDetDataset:
    """Streaming open-vocabulary detection samples from tar shards."""

    def __init__(self, shards: str, ann_key: str = "annotations",
                 label_key: str = "text_ch",
                 en_zh_map: Optional[Dict[str, str]] = None,
                 class_texts: Optional[List[List[str]]] = None,
                 use_negative_queue: bool = False,
                 length: int = 100, seed: int = 0,
                 rank: int = 0, world_size: int = 1,
                 max_retry: int = 3):
        paths = sorted(glob.glob(shards)) if isinstance(shards, str) \
            else list(shards)
        assert paths, f"no shards match {shards}"
        # per-node split (wds.split_by_node semantics)
        self.paths = paths[rank::world_size] or paths
        self.ann_key = ann_key
        self.label_key = label_key
        self.en_zh_map = en_zh_map or {}
        self.base_class_texts = class_texts
        self.neg_queue = NegQueue(80) if use_negative_queue else None
        self.length = length
        self.max_retry = max_retry
        self.rng = np.random.default_rng(seed + rank)
        self._iter: Optional[Iterator] = None

    def __len__(self) -> int:
        return self.length

    def _shard_stream(self) -> Iterator[Dict[str, bytes]]:
        while True:  # resampled=True: endless reshuffled shards
            order = self.rng.permutation(len(self.paths))
            for i in order:
                try:
                    yield from iter_tar_samples(self.paths[i])
                except (tarfile.TarError, OSError):
                    continue

    def _decode(self, raw: Dict[str, bytes]) -> Dict:
        js = json.loads(raw["json"])
        img = native.decode_jpeg(raw["jpg"])
        if img is None:
            import cv2

            img = cv2.imdecode(np.frombuffer(raw["jpg"], np.uint8),
                               cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError("bad image")
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

        class_texts = list(self.base_class_texts or [])
        text2cat = {}
        for i, syns in enumerate(class_texts):
            for s in syns:
                text2cat[s] = i
        boxes, labels = [], []
        for ann in js[self.ann_key]:
            if "bbox" not in ann:
                raise ValueError("missing bbox")
            if self.label_key == "vlm":
                tags = (ann.get("vlm") or {}).get("tags") or []
                if not tags:
                    raise ValueError("no vlm tags")
                text = tags[-1]
            else:
                text = ann[self.label_key]
            text = self.en_zh_map.get(text, text)
            if text not in text2cat:
                text2cat[text] = len(class_texts)
                class_texts.append([text])
            x, y, w, h = ann["bbox"]
            boxes.append([x, y, x + w, y + h])
            labels.append(text2cat[text])
        if not boxes:
            raise ValueError("no annotations")
        if self.neg_queue is not None:
            class_texts = self.neg_queue.enrich(class_texts)
            self.neg_queue.update(class_texts)
        return {
            "image": img,
            "gt_bboxes": np.asarray(boxes, np.float32),
            "gt_labels": np.asarray(labels, np.int64),
            "texts": [t[0] for t in class_texts],
            "img_path": js.get("meta", {}).get("image_name", ""),
        }

    def next_sample(self) -> Dict:
        if self._iter is None:
            self._iter = self._shard_stream()
        for _ in range(self.max_retry + 1):
            raw = next(self._iter)
            try:
                return self._decode(raw)
            except (ValueError, KeyError):
                continue
        raise ValueError(f"failed after {self.max_retry} retries")
