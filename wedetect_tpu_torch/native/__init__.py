"""Native (C++) host code, loaded with ctypes: the COCO greedy matcher.

On first use `coco_match.cc` is compiled with

    g++ -O3 -shared -fPIC -o build/native/coco_match-<hash>.so coco_match.cc

into `build/native/` at the root of the checkout (no `-march=native`,
so a build runs on any x86-64 host); the name carries a hash of the
flags and the source, so an edited source is rebuilt and a built one is
reused. A failed build raises with g++'s output: there is no silent
fallback. The plain version is `eval/coco_map.coco_match_python`, which
runs only when an evaluator is asked for it (`matcher="python"`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "coco_match.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile coco_match.cc (if not built yet) and return the .so."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + SRC.read_bytes())
    out = BUILD_DIR / f"coco_match-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build (one
    # process per eval shard) never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not run for {SRC}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {SRC}:\n"
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
