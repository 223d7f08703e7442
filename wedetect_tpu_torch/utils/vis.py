"""PIL visualization of detections, on the host.

Port of `wedetect_tpu/utils/vis.py` (reference vis.py:6-73
plot_bounding_boxes and infer_wedetect.py:119-140): colored rectangles
with class and score captions drawn in a CJK-capable TrueType font (the
reference ships simsun.ttc so that Chinese class names render). The
font is the caller's (`font_path`), else the first of the common system
CJK fonts that loads, else PIL's default, whose glyph coverage depends
on the platform. A training batch may hold tensors on any device
(`visualize_batch` reads them back).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

PALETTE = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
    (207, 210, 49), (72, 249, 10), (146, 204, 23), (61, 219, 134),
    (26, 147, 52), (0, 212, 187), (44, 153, 168), (0, 194, 255),
    (52, 69, 147), (100, 115, 255), (0, 24, 236), (132, 56, 255),
    (82, 0, 133), (203, 56, 255), (255, 149, 200), (255, 55, 199),
]

# probed in order when no explicit font is given (simsun.ttc first:
# the reference's own choice, if a user dropped it alongside)
_CJK_FONT_CANDIDATES = (
    "simsun.ttc",
    "/usr/share/fonts/truetype/wqy/wqy-zenhei.ttc",
    "/usr/share/fonts/truetype/wqy/wqy-microhei.ttc",
    "/usr/share/fonts/opentype/noto/NotoSansCJK-Regular.ttc",
    "/usr/share/fonts/truetype/noto/NotoSansCJK-Regular.ttc",
    "/usr/share/fonts/truetype/droid/DroidSansFallbackFull.ttf",
    "/System/Library/Fonts/PingFang.ttc",
    "C:/Windows/Fonts/simsun.ttc",
)


def _host(x) -> np.ndarray:
    """A numpy array of x (a tensor on any device, or array-like)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_caption_font(font_path: Optional[str] = None, size: int = 14):
    """The caption font: an explicit `font_path` (raises if it does not
    load: a user's font failing silently would draw tofu with no hint
    why), else the first of _CJK_FONT_CANDIDATES that loads, else PIL's
    built-in font."""
    from PIL import ImageFont

    if font_path:
        return ImageFont.truetype(font_path, size)
    for cand in _CJK_FONT_CANDIDATES:
        if os.path.exists(cand):
            try:
                return ImageFont.truetype(cand, size)
            except OSError:
                continue
    return ImageFont.load_default()


def draw_detections(image, boxes, scores, labels,
                    class_names: Optional[Sequence[str]] = None,
                    line_width: int = 3,
                    font_path: Optional[str] = None,
                    font_size: int = 14):
    """Draw xyxy boxes on a PIL image or an (H, W, 3) uint8 array;
    returns a PIL copy."""
    from PIL import Image, ImageDraw

    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image))
    img = image.copy().convert("RGB")
    d = ImageDraw.Draw(img)
    font = load_caption_font(font_path, font_size)
    for box, score, label in zip(boxes, scores, labels):
        color = PALETTE[int(label) % len(PALETTE)]
        x1, y1, x2, y2 = [float(v) for v in box]
        d.rectangle([x1, y1, x2, y2], outline=color, width=line_width)
        name = (class_names[int(label)] if class_names is not None
                else str(int(label)))
        caption = f"{name} {float(score):.2f}"
        l_, t_, r_, b_ = d.textbbox((0, 0), caption, font=font)
        tw, th = r_ - l_, b_ - t_
        d.rectangle([x1, max(y1 - th - 4, 0), x1 + tw + 4, max(y1, th)],
                    fill=color)
        d.text((x1 + 2, max(y1 - th - 3, 0)), caption, fill=(255,) * 3,
               font=font)
    return img


def visualize_batch(batch, class_texts=None, out_dir="debug_vis",
                    mean=(0.0, 0.0, 0.0), std=(255.0, 255.0, 255.0)):
    """Debug dump of a training batch (train/train_step.Batch) with its
    gt boxes drawn, one file an image (reference wedetect/models/utils/
    vis.py:9-109): float images are denormalized with mean and std.
    Returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    images = _host(batch.images)
    paths = []
    for i in range(images.shape[0]):
        if images.dtype == np.uint8:
            img = images[i]
        else:
            img = (images[i].astype(np.float32) * np.asarray(std)
                   + np.asarray(mean))
            img = np.clip(img, 0, 255).astype(np.uint8)
        m = _host(batch.gt_mask[i]).astype(bool)
        boxes = _host(batch.gt_bboxes[i])[m]
        labels = _host(batch.gt_labels[i])[m]
        drawn = draw_detections(img, boxes, np.ones(len(boxes)), labels,
                                class_names=class_texts)
        path = os.path.join(out_dir, f"batch_{i}.jpg")
        drawn.save(path)
        paths.append(path)
    return paths
