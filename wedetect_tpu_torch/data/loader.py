"""Image loading for the detection API and CLIs, and the eval loader:
decode -> letterbox -> batch, with prefetch.

Replaces the reference's torch DataLoader stack (reference
config/wedetect_base.py:197-211 val_dataloader, datasets/utils.py:8-60
yolow_collate) with a thread-pooled numpy pipeline, as
`wedetect_tpu.data.loader` does: images are decoded and letterboxed on
host threads while the card runs the previous batch. Every image is
decoded with cv2 and letterboxed by `ops/letterbox.preprocess_image`,
the JAX package's own path for non-JPEG files; its fused native JPEG
decoder (`native/image_pipeline.cc`) is not ported, so JPEG files take
the cv2 path too.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from wedetect_tpu_torch.ops.letterbox import preprocess_image

NO_FAST_DECODE = ("fast_decode needs the fused native JPEG decoder "
                  "(native/image_pipeline.cc), which is not ported")


def load_image_rgb(path: str) -> np.ndarray:
    """Read an image file as HWC uint8 RGB (cv2, imported on use)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def eval_sample(ds, idx: int, img_size, fast_decode: bool = False) -> Dict:
    """One letterboxed eval sample of a CocoDetDataset with its metas."""
    if fast_decode:
        raise NotImplementedError(NO_FAST_DECODE)
    item = ds.items[idx]
    padded, sf, pad, ori = preprocess_image(load_image_rgb(item["path"]),
                                            img_size)
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
        if fast_decode:
            raise NotImplementedError(NO_FAST_DECODE)
        self.ds = ds
        self.img_size = tuple(img_size)
        self.bs = batch_size
        self.indices = list(indices if indices is not None
                            else range(len(ds)))
        self.workers = num_workers
        self.prefetch = prefetch

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
                futs = [pool.submit(eval_sample, self.ds, i, self.img_size)
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
