"""The two letterboxes of the published pipelines, for images that need
no resize (the longer side already at the target): the benchmark's
traffic only sends such images, and a resize would need cv2 or PIL.

- "pipeline" (WeDetect's test pipeline, KeepRatioResize then
  LetterResize): pad top = round(pad_h // 2 - 0.1), left likewise, the
  rest at the bottom and right; the un-letterbox subtracts that integer
  padding.
- "yolov5" (the standalone scripts that WeDetect-Uni ships): pad top
  = pad_h // 2, but the un-letterbox subtracts pad_h / 2 as a float.

Both pad with 114 and return (HWC uint8 image, scale_factor (w, h),
pad [top, bottom, left, right] as the un-letterbox reads it).
"""

from __future__ import annotations

import numpy as np


def letterbox(img: np.ndarray, size, flavor: str):
    h, w = img.shape[:2]
    th, tw = size
    if max(h, w) != max(th, tw) or h > th or w > tw:
        raise ValueError(f"image {h}x{w} would need a resize to {size}")
    ph, pw = th - h, tw - w
    if flavor == "pipeline":
        top, left = int(round(ph // 2 - 0.1)), int(round(pw // 2 - 0.1))
        pad = [top, ph - top, left, pw - left]
    elif flavor == "yolov5":
        top, left = ph // 2, pw // 2
        pad = [ph / 2, ph / 2, pw / 2, pw / 2]
    else:
        raise ValueError(flavor)
    out = np.full((th, tw, 3), 114, np.uint8)
    out[top:top + h, left:left + w] = img
    return out, (1.0, 1.0), pad
