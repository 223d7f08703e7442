"""Image loading for the detection API and CLIs, image sizes from file
headers (`image_size`), and the eval loader: decode -> letterbox ->
batch, with prefetch.

Replaces the reference's torch DataLoader stack (reference
config/wedetect_base.py:197-211 val_dataloader, datasets/utils.py:8-60
yolow_collate) with a thread-pooled numpy pipeline, as
`wedetect_tpu.data.loader` does: images are decoded and letterboxed on
host threads while the card runs the previous batch. A `.jpg` /
`.jpeg` file goes through the fused native decode + letterbox
(`native.decode_letterbox`, C++ with the GIL released, so the pool's
threads decode in parallel); any other file, and a JPEG that the
decoder rejects, is decoded with cv2 and letterboxed by
`ops/letterbox.preprocess_image`, as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures as cf
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from wedetect_tpu_torch import native
from wedetect_tpu_torch.ops.letterbox import preprocess_image

JPEG_SUFFIXES = (".jpg", ".jpeg")


def load_image_rgb(path: str) -> np.ndarray:
    """Read an image file as HWC uint8 RGB (cv2, imported on use)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


# JPEG start-of-frame markers (baseline, extended, progressive, lossless,
# arithmetic): each carries the frame's height and width
_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
             0xCD, 0xCE, 0xCF}


def _jpeg_size(f) -> Optional[Tuple[int, int]]:
    """(width, height) from a JPEG's frame header, the file positioned
    after its SOI marker; None when the scan starts before any frame."""
    while True:
        byte = f.read(1)
        if not byte:
            return None
        if byte != b"\xff":
            continue
        marker = 0xFF
        while marker == 0xFF:                 # fill bytes
            nxt = f.read(1)
            if not nxt:
                return None
            marker = nxt[0]
        if marker in (0x00, 0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue                          # no length field
        if marker in (0xD9, 0xDA):
            return None
        seg = f.read(2)
        if len(seg) < 2:
            return None
        if marker in _JPEG_SOF:
            h, w = struct.unpack(">xHH", f.read(5))
            return w, h
        f.seek(struct.unpack(">H", seg)[0] - 2, 1)


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file as its header states it (the
    size PIL's Image.open reports, before any EXIF rotation), read from
    the header of a PNG, JPEG, GIF or BMP; other formats are decoded
    (cv2). The JAX package reads headers with Pillow, which the card's
    installation lacks."""
    with open(path, "rb") as f:
        head = f.read(26)
        if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head[:6] in (b"GIF87a", b"GIF89a"):
            return struct.unpack("<HH", head[6:10])
        if head[:2] == b"BM" and len(head) == 26:
            if struct.unpack("<I", head[14:18])[0] == 12:   # OS/2 header
                return struct.unpack("<HH", head[18:22])
            w, h = struct.unpack("<ii", head[18:26])
            return w, abs(h)
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            size = _jpeg_size(f)
            if size is not None:
                return size
    img = load_image_rgb(path)
    return img.shape[1], img.shape[0]


def letterbox_file(path: str, img_size, fast_decode: bool = False):
    """An image file decoded and letterboxed to img_size: (padded, sf,
    pad, ori), the ops/letterbox.preprocess_image contract. JPEG files
    go through the native decoder (fast_decode: its DCT-scaled decode
    for >= 2x downscales, near-exact), others and rejected JPEGs
    through cv2 + preprocess_image."""
    if path.lower().endswith(JPEG_SUFFIXES):
        with open(path, "rb") as f:
            result = native.decode_letterbox(f.read(), img_size,
                                             fast=fast_decode)
        if result is not None:
            return result
    return preprocess_image(load_image_rgb(path), img_size)


def eval_sample(ds, idx: int, img_size, fast_decode: bool = False) -> Dict:
    """One letterboxed eval sample of a CocoDetDataset with its metas."""
    item = ds.items[idx]
    padded, sf, pad, ori = letterbox_file(item["path"], img_size,
                                          fast_decode)
    return {
        "image": padded, "scale_factor": sf, "pad_param": pad,
        "ori_shape": np.array(ori, np.float32),
        "img_id": item["img_id"], "idx": idx,
    }


class EvalLoader:
    """Batched, prefetching eval loader over an index shard.

    Pads the final partial batch by repeating the last sample (the
    extra rows carry valid=False downstream via `n_valid`).
    """

    def __init__(self, ds, img_size, batch_size: int = 8,
                 indices: Optional[Sequence[int]] = None,
                 num_workers: int = 8, prefetch: int = 4,
                 fast_decode: bool = False):
        self.ds = ds
        self.img_size = tuple(img_size)
        self.bs = batch_size
        self.indices = list(indices if indices is not None
                            else range(len(ds)))
        self.workers = num_workers
        self.prefetch = prefetch
        self.fast_decode = fast_decode

    def __len__(self):
        return (len(self.indices) + self.bs - 1) // self.bs

    def __iter__(self) -> Iterator[Dict]:
        chunks = [self.indices[i:i + self.bs]
                  for i in range(0, len(self.indices), self.bs)]
        with cf.ThreadPoolExecutor(self.workers) as pool:
            pending: List = []
            it = iter(chunks)

            def submit_next():
                chunk = next(it, None)
                if chunk is None:
                    return
                futs = [pool.submit(eval_sample, self.ds, i,
                                    self.img_size, self.fast_decode)
                        for i in chunk]
                pending.append((chunk, futs))

            for _ in range(self.prefetch):
                submit_next()
            while pending:
                chunk, futs = pending.pop(0)
                submit_next()
                samples = [f.result() for f in futs]
                n = len(samples)
                while len(samples) < self.bs:
                    samples.append(samples[-1])
                yield {
                    "images": np.stack([s["image"] for s in samples]),
                    "scale_factor": np.stack(
                        [s["scale_factor"] for s in samples]),
                    "pad_param": np.stack(
                        [s["pad_param"] for s in samples]),
                    "ori_shape": np.stack(
                        [s["ori_shape"] for s in samples]),
                    "img_ids": [s["img_id"] for s in samples[:n]],
                    "idxs": [s["idx"] for s in samples[:n]],
                    "n_valid": n,
                }
