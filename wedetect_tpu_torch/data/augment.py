"""Training augmentations: mosaic, mixup, random text sampling.

Behavioral spec: reference
wedetect/datasets/transformers/mm_transforms.py:11-103 (RandomLoadText:
sample <= max_num_samples class prompts — all positives + a random
number of negatives — shuffle, remap gt labels, drop gts of unsampled
classes) and mm_mix_img_transforms.py:207-511 / 809-938
(MultiModalMosaic: 2x-canvas 4-image mosaic around a jittered center,
pad 114, text-aware label remap via `_update_label_text`;
YOLOv5MultiModalMixUp: 0.5/0.5 blend of two same-size images with gt
concat).

Host-side numpy; samples come as dicts
{image (HWC u8), gt_bboxes (N,4) xyxy, gt_labels (N,), texts}. A copy
of `wedetect_tpu.data.augment` (the port imports nothing of the JAX
package); cv2 is imported on use.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def random_load_text(sample: Dict, class_texts: Sequence[Sequence[str]],
                     rng: np.random.Generator,
                     num_neg_samples: Tuple[int, int] = (80, 80),
                     max_num_samples: int = 80,
                     prompt_format: str = "{}") -> Dict:
    """Sample class prompts and remap labels; returns updated sample
    with 'texts' (list of prompt strings, first synonym chosen
    randomly) and remapped/filtered gts."""
    num_classes = len(class_texts)
    labels = np.asarray(sample["gt_labels"])
    positive = sorted(set(int(x) for x in labels))
    if len(positive) > max_num_samples:
        positive = sorted(rng.choice(positive, max_num_samples,
                                     replace=False).tolist())
    n_neg = min(min(num_classes, max_num_samples) - len(positive),
                int(rng.integers(num_neg_samples[0],
                                 num_neg_samples[1] + 1)))
    candidates = [i for i in range(num_classes) if i not in set(positive)]
    negative = (rng.choice(candidates, n_neg, replace=False).tolist()
                if n_neg > 0 and candidates else [])
    sampled = positive + list(negative)
    rng.shuffle(sampled)
    label2id = {lab: i for i, lab in enumerate(sampled)}

    keep = np.array([int(lab) in label2id for lab in labels], bool)
    new_labels = np.array([label2id[int(lab)] for lab in labels[keep]],
                          np.int64)
    texts = []
    for lab in sampled:
        syns = class_texts[lab]
        texts.append(prompt_format.format(
            syns[int(rng.integers(len(syns)))]))
    out = dict(sample)
    out["gt_bboxes"] = np.asarray(sample["gt_bboxes"])[keep]
    out["gt_labels"] = new_labels
    out["texts"] = texts
    out["sampled_classes"] = sampled
    return out


def _place_keep_ratio(img: np.ndarray, target: int,
                      rng: Optional[np.random.Generator] = None
                      ) -> Tuple[np.ndarray, float]:
    import cv2

    h, w = img.shape[:2]
    r = min(target / h, target / w)
    resized = cv2.resize(img, (int(w * r), int(h * r)),
                         interpolation=cv2.INTER_LINEAR)
    return resized, r


def mosaic4(samples: List[Dict], img_scale: int,
            rng: np.random.Generator,
            center_ratio_range: Tuple[float, float] = (0.5, 1.5),
            pad_val: int = 114) -> Dict:
    """4-image mosaic on a 2x canvas around a jittered center."""
    s = img_scale
    canvas = np.full((2 * s, 2 * s, 3), pad_val, np.uint8)
    cx = int(rng.uniform(*center_ratio_range) * s)
    cy = int(rng.uniform(*center_ratio_range) * s)
    all_boxes, all_labels = [], []
    for i, sample in enumerate(samples[:4]):
        img, r = _place_keep_ratio(sample["image"], s)
        h, w = img.shape[:2]
        if i == 0:    # top-left
            x1, y1 = max(cx - w, 0), max(cy - h, 0)
            x2, y2 = cx, cy
            crop_x1, crop_y1 = w - (x2 - x1), h - (y2 - y1)
        elif i == 1:  # top-right
            x1, y1 = cx, max(cy - h, 0)
            x2, y2 = min(cx + w, 2 * s), cy
            crop_x1, crop_y1 = 0, h - (y2 - y1)
        elif i == 2:  # bottom-left
            x1, y1 = max(cx - w, 0), cy
            x2, y2 = cx, min(cy + h, 2 * s)
            crop_x1, crop_y1 = w - (x2 - x1), 0
        else:         # bottom-right
            x1, y1 = cx, cy
            x2, y2 = min(cx + w, 2 * s), min(cy + h, 2 * s)
            crop_x1, crop_y1 = 0, 0
        canvas[y1:y2, x1:x2] = img[crop_y1:crop_y1 + (y2 - y1),
                                   crop_x1:crop_x1 + (x2 - x1)]
        boxes = np.asarray(sample["gt_bboxes"], np.float32).copy()
        if len(boxes):
            boxes *= r
            boxes[:, 0::2] += x1 - crop_x1
            boxes[:, 1::2] += y1 - crop_y1
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, 2 * s)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, 2 * s)
            wh = boxes[:, 2:4] - boxes[:, 0:2]
            ok = (wh > 2).all(axis=1)
            all_boxes.append(boxes[ok])
            all_labels.append(np.asarray(sample["gt_labels"])[ok])
    return {
        "image": canvas,
        "gt_bboxes": (np.concatenate(all_boxes)
                      if all_boxes else np.zeros((0, 4), np.float32)),
        "gt_labels": (np.concatenate(all_labels)
                      if all_labels else np.zeros((0,), np.int64)),
        "texts": samples[0].get("texts"),
    }


def mixup2(a: Dict, b: Dict, rng: np.random.Generator) -> Dict:
    """YOLOv5-style 0.5/0.5 mixup of two same-size samples."""
    img_a, img_b = a["image"], b["image"]
    assert img_a.shape == img_b.shape, "mixup needs same-size inputs"
    img = (img_a.astype(np.float32) * 0.5
           + img_b.astype(np.float32) * 0.5).astype(np.uint8)
    return {
        "image": img,
        "gt_bboxes": np.concatenate([
            np.asarray(a["gt_bboxes"], np.float32).reshape(-1, 4),
            np.asarray(b["gt_bboxes"], np.float32).reshape(-1, 4)]),
        "gt_labels": np.concatenate([
            np.asarray(a["gt_labels"]), np.asarray(b["gt_labels"])]),
        "texts": a.get("texts"),
    }


def merge_mixed_texts(samples: List[Dict]) -> Tuple[List, List[Dict]]:
    """Text-aware label remap across mixed images: build the union
    text list and remap each sample's labels into it (reference
    `_update_label_text`, mm_mix_img_transforms.py:118-143)."""
    union: List = []
    index: Dict = {}
    out = []
    for s in samples:
        texts = s.get("texts") or []
        remap = {}
        for i, t in enumerate(texts):
            key = tuple(t) if isinstance(t, list) else t
            if key not in index:
                index[key] = len(union)
                union.append(t)
            remap[i] = index[key]
        labels = np.asarray(s["gt_labels"])
        new = np.array([remap.get(int(x), int(x)) for x in labels],
                       np.int64)
        s2 = dict(s)
        s2["gt_labels"] = new
        s2["texts"] = union
        out.append(s2)
    return union, out


def mosaic9(samples: List[Dict], img_scale: int,
            rng: np.random.Generator, pad_val: int = 114) -> Dict:
    """9-image 3x3 mosaic (reference Mosaic9,
    mm_mix_img_transforms.py:514-806): images tile a 3s x 3s canvas,
    which is center-cropped to 2s x 2s with a random jitter."""
    import cv2

    s = img_scale
    canvas = np.full((3 * s, 3 * s, 3), pad_val, np.uint8)
    all_boxes, all_labels = [], []
    for i, sample in enumerate(samples[:9]):
        r, c = divmod(i, 3)
        img, ratio = _place_keep_ratio(sample["image"], s)
        h, w = img.shape[:2]
        y1, x1 = r * s, c * s
        canvas[y1:y1 + h, x1:x1 + w] = img
        boxes = np.asarray(sample["gt_bboxes"], np.float32).copy()
        if len(boxes):
            boxes *= ratio
            boxes[:, 0::2] += x1
            boxes[:, 1::2] += y1
            all_boxes.append(boxes)
            all_labels.append(np.asarray(sample["gt_labels"]))
    ox = int(rng.integers(0, s + 1))
    oy = int(rng.integers(0, s + 1))
    out = canvas[oy:oy + 2 * s, ox:ox + 2 * s]
    if all_boxes:
        boxes = np.concatenate(all_boxes)
        labels = np.concatenate(all_labels)
        boxes[:, 0::2] = (boxes[:, 0::2] - ox).clip(0, 2 * s)
        boxes[:, 1::2] = (boxes[:, 1::2] - oy).clip(0, 2 * s)
        wh = boxes[:, 2:4] - boxes[:, 0:2]
        keep = (wh > 2).all(axis=1)
        boxes, labels = boxes[keep], labels[keep]
    else:
        boxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int64)
    return {"image": out, "gt_bboxes": boxes, "gt_labels": labels,
            "texts": samples[0].get("texts")}


def yolox_mixup(a: Dict, b: Dict, rng: np.random.Generator,
                ratio_range=(0.5, 1.5), pad_val: int = 114) -> Dict:
    """YOLOX-style mixup (reference YOLOXMultiModalMixUp,
    mm_mix_img_transforms.py:941-1173): the second image is jittered in
    scale, optionally flipped, padded/cropped to the first image's
    size, then blended 0.5/0.5 with gts concatenated."""
    import cv2

    img_a = a["image"]
    h, w = img_a.shape[:2]
    jit = float(rng.uniform(*ratio_range))
    img_b = b["image"]
    bh, bw = img_b.shape[:2]
    scale = min(h / bh, w / bw) * jit
    nbh, nbw = max(int(bh * scale), 1), max(int(bw * scale), 1)
    resized = cv2.resize(img_b, (nbw, nbh),
                         interpolation=cv2.INTER_LINEAR)
    flip = bool(rng.uniform() < 0.5)
    if flip:
        resized = resized[:, ::-1]
    pad = np.full((max(h, nbh), max(w, nbw), 3), pad_val, np.uint8)
    pad[:nbh, :nbw] = resized
    pad = pad[:h, :w]
    mixed = (img_a.astype(np.float32) * 0.5
             + pad.astype(np.float32) * 0.5).astype(np.uint8)
    boxes_b = np.asarray(b["gt_bboxes"], np.float32).copy()
    if len(boxes_b):
        boxes_b *= scale
        if flip:
            boxes_b[:, [0, 2]] = nbw - boxes_b[:, [2, 0]]
        boxes_b[:, 0::2] = boxes_b[:, 0::2].clip(0, w)
        boxes_b[:, 1::2] = boxes_b[:, 1::2].clip(0, h)
        wh_b = boxes_b[:, 2:4] - boxes_b[:, 0:2]
        keep = (wh_b > 2).all(axis=1)
        boxes_b = boxes_b[keep]
        labels_b = np.asarray(b["gt_labels"])[keep]
    else:
        labels_b = np.zeros((0,), np.int64)
    return {
        "image": mixed,
        "gt_bboxes": np.concatenate([
            np.asarray(a["gt_bboxes"], np.float32).reshape(-1, 4),
            boxes_b.reshape(-1, 4)]),
        "gt_labels": np.concatenate([
            np.asarray(a["gt_labels"]), labels_b]),
        "texts": a.get("texts"),
    }
