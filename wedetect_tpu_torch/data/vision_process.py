"""Qwen-VL image preprocessing: smart resize + patch extraction.

Port of the image half of `wedetect_tpu/data/vision_process.py`
(reference wedetect_ref/models/vision_process.py:41-105): smart_resize
with factor-of-32 rounding and token budgets, grid buckets, the PIL
BICUBIC resize (Pillow when importable, else the bit-exact numpy copy in
`data/pil_resize.py`), and the Qwen processor's patch layout (rows in
2x2 merge-block order, each row flattened (C, T, P, P), normalized with
the Qwen mean/std), and `fetch_image` (every image source form the
reference accepts), and the video half: `fetch_video` (every source form
of the reference's `fetch_video`, decoded on the host with cv2 or PIL),
fps sampling (`smart_nframes`, `sample_frame_indices`), the per-frame
pixel budget and `video_to_patches` (cv2 INTER_CUBIC, not the PIL-exact
bicubic of images, so as to match the JAX package bit for bit).
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

# video constants (reference vision_process.py:28-37)
VIDEO_MIN_TOKEN_NUM = 128
VIDEO_MAX_TOKEN_NUM = 768
VIDEO_FPS = 2.0
FRAME_FACTOR = 2
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768
MODEL_SEQ_LEN = 128000


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


# -------------------------------------------------------------- video


def smart_nframes(total_frames: int, video_fps: float,
                  fps: Optional[float] = None,
                  nframes: Optional[int] = None,
                  min_frames: int = FPS_MIN_FRAMES,
                  max_frames: Optional[int] = None) -> int:
    """Frame count for model inputs (reference
    vision_process.py:144-182 smart_nframes): either an explicit
    `nframes` rounded to FRAME_FACTOR, or fps-based sampling clamped to
    [min_frames, max_frames] and floored to FRAME_FACTOR."""
    if nframes is not None:
        n = round_by_factor(nframes, FRAME_FACTOR)
    else:
        fps = VIDEO_FPS if fps is None else fps
        lo = ceil_by_factor(min_frames, FRAME_FACTOR)
        hi = floor_by_factor(max_frames if max_frames is not None
                             else min(FPS_MAX_FRAMES, total_frames),
                             FRAME_FACTOR)
        n = total_frames / video_fps * fps
        n = min(min(max(n, lo), hi), total_frames)
        n = floor_by_factor(n, FRAME_FACTOR)
    if not (FRAME_FACTOR <= n <= total_frames):
        raise ValueError(
            f"nframes must be in [{FRAME_FACTOR}, {total_frames}], "
            f"got {n}")
    return int(n)


def sample_frame_indices(total_frames: int, nframes: int) -> np.ndarray:
    """Uniform temporal sampling (reference :216 linspace().round())."""
    return np.round(np.linspace(0, total_frames - 1,
                                nframes)).astype(np.int64)


def read_video_cv2(path: str, fps: Optional[float] = None,
                   nframes: Optional[int] = None):
    """Decode a video file and sample frames (host replacement for
    the reference's torchvision/decord readers). Returns
    (frames (T, H, W, 3) uint8 RGB, sample_fps)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {path}")
    video_fps = cap.get(cv2.CAP_PROP_FPS) or VIDEO_FPS
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    total = len(frames)
    n = smart_nframes(total, video_fps, fps=fps, nframes=nframes)
    idx = sample_frame_indices(total, n)
    sample_fps = n / max(total, 1e-6) * video_fps
    return np.stack([frames[i] for i in idx]), sample_fps


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
_ANIM_EXTS = (".gif", ".apng")


def _stack_uniform(frames) -> np.ndarray:
    """Stack decoded frames, resizing any stragglers to the first
    frame's size (mixed-size frame lists; PIL-bicubic, the repo's
    image resample)."""
    h, w = frames[0].shape[:2]
    out = [f if f.shape[:2] == (h, w) else resize_pil_bicubic(f, w, h)
           for f in frames]
    return np.stack(out).astype(np.uint8)


def fetch_video(src, fps: Optional[float] = None,
                nframes: Optional[int] = None):
    """Decode + temporally sample frames from any source form the
    reference's ``fetch_video`` accepts (wedetect_ref/models/
    vision_process.py:403-447): a video FILE path or ``file://`` URI
    (decoded via cv2 — the host replacement for its torchvision/
    decord/torchcodec backends — with smart_nframes fps sampling), a
    LIST of per-frame image sources (each through fetch_image, padded
    to a FRAME_FACTOR multiple by repeating the last frame, reference
    :430-432), a pre-decoded (T, H, W, 3) array, a directory or glob
    of frame images, a PIL-decodable animation (.gif/.apng/animated
    .webp), or an ``.npy``/``.npz`` frame stack. Returns
    (frames (T, H, W, 3) uint8 RGB, sample_fps); feed the frames to
    ``video_to_patches``."""
    import glob as globmod
    import os

    if isinstance(src, np.ndarray):
        return _pad_frame_list([f for f in src], fps)
    if isinstance(src, (list, tuple)):
        return _pad_frame_list([fetch_image(s) for s in src], fps)
    if not isinstance(src, str):
        raise ValueError(
            f"unrecognized video input (path, file://, directory, "
            f"glob, .gif/.apng/.webp animation, .npy/.npz stack, "
            f"frame list or (T, H, W, 3) array supported), "
            f"got {type(src)}")
    if src.startswith("file://"):
        src = src[len("file://"):]
    low = src.lower()
    if os.path.isdir(src):
        paths = sorted(
            p for p in os.listdir(src)
            if p.lower().endswith(_IMAGE_EXTS))
        if not paths:
            raise ValueError(f"no frame images in directory {src}")
        return fetch_video([os.path.join(src, p) for p in paths],
                           fps=fps, nframes=nframes)
    if any(ch in src for ch in "*?["):
        paths = sorted(globmod.glob(src))
        if not paths:
            raise ValueError(f"glob {src} matched no frames")
        return fetch_video(paths, fps=fps, nframes=nframes)
    if low.endswith((".npy", ".npz")):
        arr = np.load(src)
        if not isinstance(arr, np.ndarray):      # npz: first array
            arr = arr[list(arr.files)[0]]
        return fetch_video(np.asarray(arr), fps=fps, nframes=nframes)
    if low.endswith(_ANIM_EXTS + (".webp",)):
        return _read_animation_pil(src, fps=fps, nframes=nframes)
    return read_video_cv2(src, fps=fps, nframes=nframes)


def _pad_frame_list(frames, fps):
    """Reference list-of-frames semantics (vision_process.py:430-438):
    keep every frame, pad to a FRAME_FACTOR multiple by repeating the
    last; sample_fps is the caller's claim (default VIDEO_FPS)."""
    if not frames:
        raise ValueError("empty frame list")
    n = ceil_by_factor(len(frames), FRAME_FACTOR)
    frames = list(frames) + [frames[-1]] * (n - len(frames))
    return _stack_uniform(frames), (fps or VIDEO_FPS)


def _read_animation_pil(path: str, fps: Optional[float] = None,
                        nframes: Optional[int] = None):
    """GIF/APNG/animated-WebP via PIL ImageSequence; the source fps
    comes from the per-frame duration metadata (fallback VIDEO_FPS),
    then the standard smart_nframes + linspace sampling applies."""
    from PIL import Image, ImageSequence

    img = Image.open(path)
    frames = [np.asarray(f.convert("RGB"))
              for f in ImageSequence.Iterator(img)]
    if len(frames) == 1:                  # still image file
        return _pad_frame_list(frames, fps)
    dur_ms = img.info.get("duration") or 0
    video_fps = 1000.0 / dur_ms if dur_ms else VIDEO_FPS
    total = len(frames)
    n = smart_nframes(total, video_fps, fps=fps, nframes=nframes)
    idx = sample_frame_indices(total, n)
    sample_fps = n / max(total, 1e-6) * video_fps
    return _stack_uniform([frames[i] for i in idx]), sample_fps


def video_frame_pixel_budget(nframes: int, patch: int = 16,
                             merge: int = 2,
                             min_pixels: Optional[int] = None,
                             max_pixels: Optional[int] = None,
                             total_pixels: Optional[int] = None):
    """Per-frame pixel budget (reference fetch_video:448-455): the
    total token budget is split across frames, clamped to the video
    frame min/max."""
    f2 = (patch * merge) ** 2
    min_px = (min_pixels if min_pixels is not None
              else VIDEO_MIN_TOKEN_NUM * f2)
    total_px = (total_pixels if total_pixels is not None
                else MODEL_SEQ_LEN * f2 * 0.9)
    cap = max(min(VIDEO_MAX_TOKEN_NUM * f2,
                  total_px / nframes * FRAME_FACTOR),
              int(min_px * 1.05))
    if max_pixels is not None:
        cap = min(max_pixels, cap)
    return min_px, int(cap)


def video_to_patches(frames: np.ndarray, patch: int = 16,
                     temporal_patch: int = 2, merge: int = 2,
                     min_pixels: Optional[int] = None,
                     max_pixels: Optional[int] = None,
                     total_pixels: Optional[int] = None):
    """(T, H, W, 3) uint8 RGB frames -> (patches
    (grid_t*gh*gw, C*TP*P*P) f32, grid_t, gh, gw).

    Mirrors the Qwen video processor: every frame smart-resized to a
    shared grid under the per-frame budget, T padded to a multiple of
    temporal_patch by repeating the last frame, consecutive
    temporal_patch frames stacked per token, merge-block spatial order
    within each temporal group (groups are token-major)."""
    import cv2

    frames = np.asarray(frames)
    t, h, w = frames.shape[:3]
    min_px, max_px = video_frame_pixel_budget(
        t, patch, merge, min_pixels, max_pixels, total_pixels)
    hb, wb = smart_resize(h, w, patch * merge, min_px, max_px)
    resized = np.stack([
        cv2.resize(f, (wb, hb), interpolation=cv2.INTER_CUBIC)
        for f in frames])
    tp = temporal_patch
    if t % tp:
        resized = np.concatenate(
            [resized, np.repeat(resized[-1:], tp - t % tp, axis=0)])
        t = resized.shape[0]
    grid_t = t // tp
    x = (resized.astype(np.float32) / 255.0 - IMAGE_MEAN) / IMAGE_STD
    x = x.transpose(0, 3, 1, 2)                 # T, C, H, W
    gh, gw = hb // patch, wb // patch
    x = x.reshape(grid_t, tp, 3, gh // merge, merge, patch,
                  gw // merge, merge, patch)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = x.reshape(grid_t * gh * gw,
                        3 * tp * patch * patch)
    return patches, grid_t, gh, gw
