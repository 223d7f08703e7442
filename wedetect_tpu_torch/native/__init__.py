"""Native (C++) host code, loaded with ctypes: the COCO greedy matcher
(`coco_match.cc`) and the fused JPEG decode + letterbox
(`image_pipeline.cc`).

On first use each source is compiled on its own with

    g++ -O3 -shared -fPIC -o build/native/<name>-<hash>.so <name>.cc

into `build/native/` at the root of the checkout (no `-march=native`,
so a build runs on any x86-64 host); the name carries a hash of the
flags and the source, so an edited source is rebuilt and a built one is
reused. A failed build or load raises with g++'s output: there is no
silent fallback. The matcher's plain version is
`eval/coco_map.coco_match_python`, which runs only when an evaluator is
asked for it (`matcher="python"`).

The JPEG decoder is cv2.imdecode, whose bundled libjpeg-turbo is the
library the JAX package links (the same pixels; tests hold the two
bitwise), with its EXIF handling off; `fast=True` decodes at libjpeg's
DCT scale 1/2, 1/4 or 1/8 (cv2.IMREAD_REDUCED_COLOR_*). The C++
(`image_pipeline.cc`) reads the header (frame size, EXIF orientation,
the fast path's scale) and turns the decoded image upright, resizes and
letterboxes it. The same route runs on every host: no libjpeg headers
are needed.

The decoder's bindings (`decode_letterbox`, `decode_jpeg`, `jpeg_info`)
follow the JAX package's contract: they return None for bytes that the
decoder rejects (no 8-bit JPEG frame of 1 or 3 components, or data that
cv2 cannot decode), and the caller decodes that one file with cv2. Each
rejection adds one to `decode_fallbacks`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "coco_match.cc"
IMAGE_SRC = Path(__file__).resolve().parent / "image_pipeline.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_image_lib = None
# files the decoder rejected (rc != 0), each decoded by cv2 instead
decode_fallbacks = 0


def build(src: Optional[Path] = None) -> Path:
    """Compile `src` (default: coco_match.cc), if not built yet, and
    return the .so."""
    src = SRC if src is None else Path(src)
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + src.read_bytes())
    out = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build (one
    # process per eval shard) never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not run for {src}: {e}") from e
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {src}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded matcher library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p = ctypes.POINTER
            lib.coco_match.argtypes = [
                p(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                p(ctypes.c_uint8), p(ctypes.c_uint8), p(ctypes.c_double),
                ctypes.c_int, p(ctypes.c_int64), p(ctypes.c_int64)]
            lib.coco_match.restype = None
            _lib = lib
        return _lib


def load_image() -> ctypes.CDLL:
    """The loaded decoder library, built on first use."""
    global _image_lib
    with _lock:
        if _image_lib is None:
            lib = ctypes.CDLL(str(build(IMAGE_SRC)))
            p = ctypes.POINTER
            u8, i32, f32 = (p(ctypes.c_uint8), p(ctypes.c_int),
                            p(ctypes.c_float))
            lib.wd_jpeg_header.argtypes = [u8, ctypes.c_size_t, i32, i32,
                                           i32]
            lib.wd_jpeg_header.restype = ctypes.c_int
            lib.wd_decode_scale.argtypes = [ctypes.c_int] * 5
            lib.wd_decode_scale.restype = ctypes.c_int
            lib.wd_letterbox.argtypes = [u8] + [ctypes.c_int] * 8 + [
                u8, f32, f32, i32]
            lib.wd_letterbox.restype = None
            lib.wd_upright_rgb.argtypes = [u8] + [ctypes.c_int] * 3 + [u8]
            lib.wd_upright_rgb.restype = None
            _image_lib = lib
        return _image_lib


def coco_match(iou, gt_ig, crowd, thrs):
    """Greedy COCO matching of nd detections (in score order) to ng gts
    (non-ignored first) at every IoU threshold.

    iou (nd, ng), gt_ig (ng,) and crowd (ng,) bool, thrs (T,) ->
    (dtm (T, nd), gtm (T, ng)) int64: the gt matched per detection and
    the detection matched per gt, -1 for none."""
    lib = load()
    nd, ng = iou.shape
    nt = len(thrs)
    iou = np.ascontiguousarray(iou, np.float64)
    gt_ig = np.ascontiguousarray(gt_ig, np.uint8)
    crowd = np.ascontiguousarray(crowd, np.uint8)
    thrs = np.ascontiguousarray(thrs, np.float64)
    dtm = np.empty((nt, nd), np.int64)
    gtm = np.empty((nt, ng), np.int64)
    p = ctypes.POINTER
    lib.coco_match(
        iou.ctypes.data_as(p(ctypes.c_double)), nd, ng,
        gt_ig.ctypes.data_as(p(ctypes.c_uint8)),
        crowd.ctypes.data_as(p(ctypes.c_uint8)),
        thrs.ctypes.data_as(p(ctypes.c_double)), nt,
        dtm.ctypes.data_as(p(ctypes.c_int64)),
        gtm.ctypes.data_as(p(ctypes.c_int64)))
    return dtm, gtm


def _rejected() -> None:
    """Count one file that the decoder rejects (the caller decodes it
    with cv2)."""
    global decode_fallbacks
    with _lock:
        decode_fallbacks += 1


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _header(lib, buf: np.ndarray) -> Optional[Tuple[int, int, int]]:
    """(frame h, frame w, EXIF orientation), or None when rejected."""
    h, w, orient = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.wd_jpeg_header(_ptr(buf, ctypes.c_uint8), buf.size,
                          ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(orient)):
        return None
    return h.value, w.value, orient.value


def _decode_bgr(buf: np.ndarray, fh: int, fw: int, denom: int = 1
                ) -> Optional[np.ndarray]:
    """The frame decoded by cv2's libjpeg at 1/denom (EXIF ignored), or
    None when cv2 fails or decodes to another size than libjpeg's
    ceil(f / denom)."""
    import cv2

    flag = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
            4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8}
    img = cv2.imdecode(buf, flag[denom] | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None or img.shape != (-(-fh // denom), -(-fw // denom), 3):
        return None
    return np.ascontiguousarray(img)


def decode_letterbox(jpeg_bytes: bytes, scale, pad_val: int = 114,
                     fast: bool = False):
    """Fused JPEG decode + keep-ratio + letterbox.

    scale: (th, tw). Returns (padded u8 HWC RGB, scale_factor (w, h)
    f32, pad_param [t, b, l, r] f32, ori_shape (h, w)), the
    ops/letterbox.preprocess_image contract, or None when the decoder
    rejects the bytes (the caller falls back to cv2 for that file).
    Releases the GIL: thread pools decode in parallel.

    fast=True decodes at libjpeg's DCT scale 1/2, 1/4 or 1/8 when the
    keep-ratio target is at least 2x smaller than the source: about
    denom^2 less decode work, close to but not bit-identical with the
    exact path (the scale/pad metadata stays exact).
    """
    th, tw = int(scale[0]), int(scale[1])
    if th <= 0 or tw <= 0 or not 0 <= pad_val <= 255:
        raise ValueError(f"scale {scale} / pad_val {pad_val} out of range")
    lib = load_image()
    buf = np.frombuffer(jpeg_bytes, np.uint8)
    head = _header(lib, buf)
    img = None
    if head is not None:
        fh, fw, orient = head
        denom = lib.wd_decode_scale(fh, fw, orient, th, tw) if fast else 1
        img = _decode_bgr(buf, fh, fw, denom)
    if img is None:
        _rejected()
        return None
    out = np.empty((th, tw, 3), np.uint8)
    sf = np.empty(2, np.float32)
    pad = np.empty(4, np.float32)
    ori = np.empty(2, np.int32)
    lib.wd_letterbox(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                     orient, fh, fw, th, tw, int(pad_val),
                     _ptr(out, ctypes.c_uint8), _ptr(sf, ctypes.c_float),
                     _ptr(pad, ctypes.c_float), _ptr(ori, ctypes.c_int))
    return out, sf, pad, (int(ori[0]), int(ori[1]))


def jpeg_info(jpeg_bytes: bytes) -> Optional[Tuple[int, int]]:
    """(h, w) of the decoded image, EXIF orientation applied, read from
    the header; None when the decoder rejects it."""
    head = _header(load_image(), np.frombuffer(jpeg_bytes, np.uint8))
    if head is None:
        _rejected()
        return None
    h, w, orient = head
    return (w, h) if orient >= 5 else (h, w)


def decode_jpeg(jpeg_bytes: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> upright RGB u8 HWC (EXIF orientation applied), or
    None when the decoder rejects them (the caller falls back to cv2)."""
    lib = load_image()
    buf = np.frombuffer(jpeg_bytes, np.uint8)
    head = _header(lib, buf)
    img = None if head is None else _decode_bgr(buf, *head[:2])
    if img is None:
        _rejected()
        return None
    h, w, orient = head
    out = np.empty((w, h, 3) if orient >= 5 else (h, w, 3), np.uint8)
    lib.wd_upright_rgb(_ptr(img, ctypes.c_uint8), h, w, orient,
                       _ptr(out, ctypes.c_uint8))
    return out
