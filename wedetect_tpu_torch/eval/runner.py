"""COCO / LVIS evaluation runner.

Behavioral spec: reference test.py:67-146 + dist_test.sh (mmengine
TestLoop with per-rank DefaultSampler, CocoMetric/LVISMetric on rank 0)
and eval_recall/eval_recall.py:1458-1588 (InferenceSampler contiguous
shards + all_gather_object); the port of `wedetect_tpu.eval.runner`.

Each process takes a contiguous index shard (rank and world from
torch.distributed when a process group is up, else 0 of 1), runs
batched `detect_step` (or `detect_step_tta`) on the model's device,
reads each batch's detections back in one copy, accumulates the metric
on the host, and with several processes merges the evaluator's records
(and the LVIS evaluator's buffered images, and the dump) on every rank.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from wedetect_tpu_torch.configs import ModelCfg
from wedetect_tpu_torch.data.loader import EvalLoader
from wedetect_tpu_torch.eval import dist
from wedetect_tpu_torch.eval.coco_map import CocoEvaluator
from wedetect_tpu_torch.eval.lvis_map import LvisEvaluator
from wedetect_tpu_torch.models.wedetect import (Detections, detect_step,
                                                detect_step_tta)

# the host-side split of an evaluation, in ms (`timings=`): waiting for
# the loader, the detect step's call (its NMS syncs the host, so most of
# the card's work lands here), the packed read-back (the rest of it),
# the evaluator's add_image and summarize
TIMING_KEYS = ("loader_wait_ms", "detect_ms", "readback_ms",
               "add_image_ms", "summarize_ms")


def process_shard(n: int, rank: Optional[int] = None,
                  world: Optional[int] = None) -> range:
    """Contiguous index shard (InferenceSampler semantics)."""
    rank = dist.process_index() if rank is None else rank
    world = dist.process_count() if world is None else world
    per = (n + world - 1) // world
    return range(rank * per, min((rank + 1) * per, n))


def pack(det: Detections, with_embeds: bool) -> torch.Tensor:
    """The detections as one (B, max_out, 7 [+ C]) f32 tensor: boxes,
    score, label, valid (+ embeds), so a batch is one read-back."""
    cols = [det.boxes, det.scores[..., None],
            det.labels[..., None].float(), det.valid[..., None].float()]
    if with_embeds:
        cols.append(det.embeds.float())
    return torch.cat(cols, -1)


def evaluate_coco(cfg: ModelCfg, model, ds, text_embeds,
                  batch_size: int = 8, class_mask=None,
                  max_images: Optional[int] = None,
                  progress: bool = False, lvis: bool = False,
                  tta: bool = False, dump_path: Optional[str] = None,
                  timings: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
    """Run the detector over the dataset and compute COCO (or LVIS
    fixed-AP) bbox metrics.

    model: the WeDetectModule (or a `Detector`, whose model is used);
    text_embeds: its (K, C) class embeddings (None for Uni). tta=True
    adds the horizontal-flip view (`detect_step_tta`). dump_path writes
    every image's raw predictions (boxes, scores, labels, embeds;
    eval/dump.py layout); with several processes rank 0 writes the
    merged dump. timings, when given, is filled with TIMING_KEYS (host
    clock) and the counts of images and batches.
    """
    model = getattr(model, "model", model)
    step = detect_step_tta if tta else detect_step
    dev = next(model.parameters()).device

    indices = list(process_shard(len(ds)))
    if max_images:
        indices = indices[:max_images]
    loader = EvalLoader(ds, cfg.img_size, batch_size=batch_size,
                        indices=indices)
    classes = range(len(ds.class_names))
    if lvis:
        evaluator = LvisEvaluator(
            class_ids=classes, frequencies=getattr(ds, "frequencies", None))
    else:
        evaluator = CocoEvaluator(class_ids=classes)
    w = (None if text_embeds is None else
         torch.as_tensor(text_embeds, dtype=torch.float32, device=dev))
    clock = dict.fromkeys(TIMING_KEYS, 0.0)

    def lap(key, t0):
        t1 = time.perf_counter()
        clock[key] += (t1 - t0) * 1e3
        return t1

    dump_records: List[dict] = []

    def consume(packed, batch):
        t0 = time.perf_counter()
        packed = packed.cpu().numpy()
        t0 = lap("readback_ms", t0)
        boxes = packed[..., :4]
        scores = packed[..., 4]
        labels = packed[..., 5].astype(np.int64)
        valid = packed[..., 6].astype(bool)
        for i, idx in enumerate(batch["idxs"]):
            v = valid[i]
            if dump_path is not None:
                dump_records.append({
                    "img_id": ds.items[idx]["img_id"],
                    "boxes": boxes[i][v], "scores": scores[i][v],
                    "labels": labels[i][v],
                    "embeds": packed[i, :, 7:][v]})
            if lvis:
                item = ds.items[idx]
                evaluator.add_image(
                    ds.gt_arrays(idx), boxes[i][v], scores[i][v],
                    labels[i][v],
                    neg_cats=set(item.get("neg_cats", [])),
                    not_exhaustive=set(item.get("not_exhaustive", [])))
            else:
                evaluator.add_image(ds.gt_arrays(idx), boxes[i][v],
                                    scores[i][v], labels[i][v])
        lap("add_image_ms", t0)

    # lag-1 pipeline: batch i is read back after batch i + 1 has been
    # dispatched (the detect step's NMS syncs the host, so the overlap
    # is the tail of batch i's device work)
    pending = None
    n_batches = 0
    t0 = time.perf_counter()
    for bi, batch in enumerate(loader):
        t0 = lap("loader_wait_ms", t0)
        det = step(cfg, model, batch["images"], w, batch["scale_factor"],
                   batch["pad_param"], batch["ori_shape"], class_mask)
        packed = pack(det, dump_path is not None)
        lap("detect_ms", t0)
        if pending is not None:
            consume(*pending)
        pending = (packed, batch)
        n_batches += 1
        if progress and bi % 20 == 0:
            print(f"eval {bi}/{len(loader)}", flush=True)
        t0 = time.perf_counter()
    if pending is not None:
        consume(*pending)

    if dist.process_count() > 1:
        # merge of per-process match records (the reference's
        # all_gather_object + rank-0 metric pattern)
        parts = dist.all_gather_object(evaluator._records)
        evaluator._records = [r for part in parts for r in part]
        if lvis:
            # LvisEvaluator matches lazily in summarize() from the
            # buffered per-image inputs (the fixed-AP cap is a
            # dataset-wide top-k): gather those too
            parts = dist.all_gather_object(evaluator._images)
            evaluator._images = [im for part in parts for im in part]
        if dump_path is not None:
            parts = dist.all_gather_object(dump_records)
            dump_records = [r for part in parts for r in part]
    if dump_path is not None and dist.process_index() == 0:
        from wedetect_tpu_torch.eval.dump import save_detections

        save_detections(dump_path, dump_records)
    t0 = time.perf_counter()
    metrics = evaluator.summarize()
    lap("summarize_ms", t0)
    if timings is not None:
        timings.update(clock, images=len(indices), batches=n_batches)
    return metrics
