"""Host-side preprocessing: keep-ratio resize + letterbox padding.

The same numpy functions as `wedetect_tpu.ops.letterbox` (reference
WeDetectKeepRatioResize -> WeDetectLetterResize, transforms.py:94-275,
and the standalone scripts' YOLOv5 letterbox, generate_proposal.py:17-83).
cv2 and PIL are imported only when an image must be resized; padding is
done in numpy, and an image already at the target size needs neither.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def keep_ratio_resize(img: np.ndarray, scale: Tuple[int, int],
                      allow_scale_up: bool = True) -> np.ndarray:
    """Resize keeping aspect so the image fits inside `scale` (h, w):
    int(w * ratio) target sizes, area interpolation on downscale,
    bilinear on upscale."""
    h, w = img.shape[:2]
    th, tw = scale
    ratio = min(max(th, tw) / max(h, w), min(th, tw) / min(h, w))
    if not allow_scale_up:
        ratio = min(ratio, 1.0)
    if ratio != 1.0:
        import cv2

        interp = cv2.INTER_AREA if ratio < 1 else cv2.INTER_LINEAR
        img = cv2.resize(img, (int(w * ratio), int(h * ratio)),
                         interpolation=interp)
    return img


def letter_resize(img: np.ndarray, scale: Tuple[int, int],
                  allow_scale_up: bool = False, pad_val: int = 114):
    """Letterbox to exactly `scale` (h, w).

    Returns (image, scale_factor (w_ratio, h_ratio), pad_param
    [top, bottom, left, right]) as WeDetectLetterResize with
    half_pad_param=False.
    """
    h, w = img.shape[:2]
    th, tw = scale
    ratio = min(th / h, tw / w)
    if not allow_scale_up:
        ratio = min(ratio, 1.0)
    no_pad_h, no_pad_w = int(round(h * ratio)), int(round(w * ratio))
    padding_h, padding_w = th - no_pad_h, tw - no_pad_w
    if (h, w) != (no_pad_h, no_pad_w):
        import cv2

        img = cv2.resize(img, (no_pad_w, no_pad_h),
                         interpolation=cv2.INTER_LINEAR)
    scale_factor = (no_pad_w / w, no_pad_h / h)
    top = int(round(padding_h // 2 - 0.1))
    left = int(round(padding_w // 2 - 0.1))
    bottom, right = padding_h - top, padding_w - left
    if padding_h or padding_w:
        out = np.full((th, tw) + img.shape[2:], pad_val, dtype=img.dtype)
        out[top:top + no_pad_h, left:left + no_pad_w] = img
        img = out
    pad_param = np.array([top, bottom, left, right], dtype=np.float32)
    return img, scale_factor, pad_param


def yolov5_letterbox(img: np.ndarray, scale: Tuple[int, int],
                     scale_up: bool = True, pad_val: int = 114):
    """The standalone scripts' flavor: one PIL BILINEAR resize with
    round() sizes, pad left = dw//2, top = dh//2, and float half-pad
    offsets (dw/2, dh/2) for the un-letterbox.

    Returns (padded u8 HWC, scale_factor (r, r), pad_param
    [dh/2, dh/2, dw/2, dw/2] float, ori_shape (h, w)).
    """
    h, w = img.shape[:2]
    th, tw = scale
    r = min(tw / w, th / h)
    if not scale_up:
        r = min(r, 1.0)
    nw, nh = int(round(w * r)), int(round(h * r))
    if (nw, nh) != (w, h):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).resize(
            (nw, nh), Image.Resampling.BILINEAR))
    dw, dh = tw - nw, th - nh
    left, top = dw // 2, dh // 2
    out = np.full((th, tw, 3), pad_val, dtype=np.uint8)
    out[top:top + nh, left:left + nw] = img
    pad = np.array([dh / 2, dh / 2, dw / 2, dw / 2], np.float32)
    return out, np.array([r, r], np.float32), pad, (h, w)


def preprocess_image(img: np.ndarray, scale: Tuple[int, int],
                     pad_val: int = 114):
    """Test-time preprocessing: keep-ratio resize then letterbox.

    img: HWC uint8 RGB. Returns (padded uint8 HWC image, scale_factor
    (w, h), pad_param [t, b, l, r], ori_shape (h, w)).
    """
    ori_shape = img.shape[:2]
    resized = keep_ratio_resize(img, scale, allow_scale_up=True)
    out, scale_factor, pad_param = letter_resize(resized, scale,
                                                 allow_scale_up=False,
                                                 pad_val=pad_val)
    total_sf = (scale_factor[0] * resized.shape[1] / img.shape[1],
                scale_factor[1] * resized.shape[0] / img.shape[0])
    return out, np.array(total_sf, np.float32), pad_param, ori_shape
