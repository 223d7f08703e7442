"""Qwen-VL image preprocessing: smart resize + patch extraction.

Port of the image half of `wedetect_tpu/data/vision_process.py`
(reference wedetect_ref/models/vision_process.py:41-105): smart_resize
with factor-of-32 rounding and token budgets, grid buckets, the PIL
BICUBIC resize (Pillow when importable, else the bit-exact numpy copy in
`data/pil_resize.py`), and the Qwen processor's patch layout (rows in
2x2 merge-block order, each row flattened (C, T, P, P), normalized with
the Qwen mean/std), and `fetch_image` (every image source form the
reference accepts). Video is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

IMAGE_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
IMAGE_STD = np.array([0.5, 0.5, 0.5], np.float32)
IMAGE_MIN_TOKEN_NUM = 4
IMAGE_MAX_TOKEN_NUM = 16384
MAX_RATIO = 200


def round_by_factor(x: float, f: int) -> int:
    return round(x / f) * f


def ceil_by_factor(x: float, f: int) -> int:
    return math.ceil(x / f) * f


def floor_by_factor(x: float, f: int) -> int:
    return math.floor(x / f) * f


def smart_resize(height: int, width: int, factor: int = 32,
                 min_pixels: Optional[int] = None,
                 max_pixels: Optional[int] = None) -> Tuple[int, int]:
    max_pixels = (max_pixels if max_pixels is not None
                  else IMAGE_MAX_TOKEN_NUM * factor ** 2)
    min_pixels = (min_pixels if min_pixels is not None
                  else IMAGE_MIN_TOKEN_NUM * factor ** 2)
    assert max_pixels >= min_pixels
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(f"aspect ratio over {MAX_RATIO}")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def make_grid_buckets(total_tokens: int = 1024, factor: int = 32,
                      ratios=(0.33, 0.5, 0.67, 0.75, 1.0, 1.33, 1.5,
                              2.0, 3.0)):
    """A fixed set of (h, w) pixel sizes (~total_tokens patches each)
    covering common aspect ratios."""
    out = []
    for r in ratios:  # r = h/w
        gw = max(1, round((total_tokens / r) ** 0.5))
        gh = max(1, round(gw * r))
        out.append((gh * factor, gw * factor))
    return out


def snap_to_bucket(h: int, w: int, buckets) -> Tuple[int, int]:
    """The bucket with the closest aspect ratio."""
    ratio = h / w
    return min(buckets, key=lambda b: abs(b[0] / b[1] - ratio))


def resize_pil_bicubic(img: np.ndarray, wb: int, hb: int) -> np.ndarray:
    """PIL BICUBIC on uint8: Pillow itself when importable, else the
    bit-identical numpy copy in data/pil_resize.py."""
    try:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize(
            (wb, hb), Image.Resampling.BICUBIC))
    except ImportError:
        from wedetect_tpu_torch.data.pil_resize import resize_bicubic_u8

        return resize_bicubic_u8(img, wb, hb)


def fetch_image(src) -> np.ndarray:
    """An image from any source form of the reference's `fetch_image`
    (wedetect_ref/models/vision_process.py:95-150): a numpy array
    (passed through), a PIL.Image, encoded bytes, a local path, a
    `file://` path, a `data:image/...;base64,` URI or an `http(s)://`
    URL. Returns RGB uint8 (H, W, 3); RGBA is composited onto white.
    No resize here: smart_resize and snap_to_bucket do that."""
    import base64
    import io

    if isinstance(src, np.ndarray):
        arr = src
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        return np.ascontiguousarray(arr[..., :3]).astype(np.uint8)

    from PIL import Image

    if isinstance(src, Image.Image):
        img = src
    elif isinstance(src, (bytes, bytearray)):
        img = Image.open(io.BytesIO(bytes(src)))
    elif isinstance(src, str):
        if src.startswith(("http://", "https://")):
            import urllib.request

            with urllib.request.urlopen(src, timeout=30) as r:
                img = Image.open(io.BytesIO(r.read()))
                img.load()
        elif src.startswith("file://"):
            img = Image.open(src[len("file://"):])
        elif src.startswith("data:image"):
            if "base64," not in src:
                raise ValueError(f"unsupported data URI: {src[:40]}")
            img = Image.open(io.BytesIO(
                base64.b64decode(src.split("base64,", 1)[1])))
        else:
            img = Image.open(src)
    else:
        raise ValueError(
            f"unrecognized image input (ndarray, PIL.Image, bytes, "
            f"path, file://, data:image or http(s):// supported), "
            f"got {type(src)}")
    if img.mode == "RGBA":
        bg = Image.new("RGB", img.size, (255, 255, 255))
        bg.paste(img, mask=img.split()[3])
        img = bg
    else:
        img = img.convert("RGB")
    return np.asarray(img)


def image_to_pixels(img: np.ndarray, patch: int = 16, merge: int = 2,
                    min_pixels: Optional[int] = None,
                    max_pixels: Optional[int] = None,
                    grid_buckets=None, resample: str = "pil"):
    """HWC uint8 RGB -> (resized uint8 (Hb, Wb, 3), grid_h, grid_w): the
    resize half of image_to_patches, for patchify on the device
    (models/ref.pixels_to_patches)."""
    h, w = img.shape[:2]
    if grid_buckets:
        hb, wb = snap_to_bucket(h, w, grid_buckets)
    else:
        hb, wb = smart_resize(h, w, patch * merge, min_pixels, max_pixels)
    if resample == "pil":
        resized = resize_pil_bicubic(img, wb, hb)
    else:
        import cv2

        resized = cv2.resize(img, (wb, hb), interpolation=cv2.INTER_CUBIC)
    return resized, hb // patch, wb // patch


def image_to_patches(img: np.ndarray, patch: int = 16,
                     temporal_patch: int = 2, merge: int = 2,
                     min_pixels: Optional[int] = None,
                     max_pixels: Optional[int] = None,
                     grid_buckets=None, resample: str = "pil"):
    """HWC uint8 RGB -> (patches (S, C*T*P*P) f32, grid_h, grid_w), rows
    in merge-block order, each flattened (C, T, P, P)."""
    resized, gh, gw = image_to_pixels(
        img, patch=patch, merge=merge, min_pixels=min_pixels,
        max_pixels=max_pixels, grid_buckets=grid_buckets,
        resample=resample)
    x = (resized.astype(np.float32) / 255.0 - IMAGE_MEAN) / IMAGE_STD
    x = x.transpose(2, 0, 1)                    # CHW
    x = np.stack([x] * temporal_patch, 0)       # T, C, H, W
    x = x.reshape(temporal_patch, 3, gh // merge, merge, patch,
                  gw // merge, merge, patch)
    x = x.transpose(2, 5, 3, 6, 1, 0, 4, 7)
    patches = x.reshape(gh * gw, 3 * temporal_patch * patch * patch)
    return patches, gh, gw
