"""Raw-prediction dump — the reference's ``DumpDetResults`` role.

Reference test.py:29,143 (`--out results.pkl`) saves every image's
predicted instances so metrics can be recomputed offline and errors
analyzed without re-running the model. Here: one
flat .npz (compressed) with per-image detections concatenated along a
single axis plus an offsets vector — no pickles, no ragged object
arrays, loadable from plain numpy.

Layout::

    img_ids (N,)  int64   COCO image id per evaluated image
    n_det   (N,)  int32   detections kept per image
    boxes   (M,4) float32 xyxy in original-image coordinates
    scores  (M,)  float32
    labels  (M,)  int64   contiguous label index (dataset order)
    embeds  (M,C) float16 region embedding per detection (optional)

where M = n_det.sum(); image i's rows are
``slice(n_det[:i].sum(), n_det[:i+1].sum())``.

A copy of `wedetect_tpu.eval.dump`: the same layout, so either package
reads the other's dump; `recompute_metrics` also takes the evaluator's
`matcher`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def save_detections(path: str, records: List[dict]) -> None:
    """records: per image ``{"img_id", "boxes", "scores", "labels"}``
    (+ optional ``"embeds"``), already filtered to valid rows."""
    n = len(records)
    img_ids = np.asarray([r["img_id"] for r in records], np.int64)
    n_det = np.asarray([len(r["scores"]) for r in records], np.int32)
    cat = {
        "img_ids": img_ids,
        "n_det": n_det,
        "boxes": (np.concatenate([np.asarray(r["boxes"], np.float32)
                                  .reshape(-1, 4) for r in records])
                  if n else np.zeros((0, 4), np.float32)),
        "scores": (np.concatenate([np.asarray(r["scores"], np.float32)
                                   .ravel() for r in records])
                   if n else np.zeros((0,), np.float32)),
        "labels": (np.concatenate([np.asarray(r["labels"], np.int64)
                                   .ravel() for r in records])
                   if n else np.zeros((0,), np.int64)),
    }
    if n and "embeds" in records[0]:
        cat["embeds"] = np.concatenate([_embed_rows(r) for r in records])
    np.savez_compressed(path, **cat)


def _embed_rows(record) -> np.ndarray:
    """A record's embeds as (n_det, C) float16. An image without
    detections keeps its (0, C) rows (JAX's reshape(0, -1) of them
    raises, so a JAX dump with such an image fails to write)."""
    e = np.asarray(record["embeds"], np.float16)
    n = len(record["scores"])
    return e.reshape(n, -1) if n else e.reshape(0, e.shape[-1])


def load_detections(path: str) -> List[Dict[str, np.ndarray]]:
    """Inverse of save_detections: list of per-image dicts."""
    z = np.load(path)
    offs = np.concatenate([[0], np.cumsum(z["n_det"])]).astype(int)
    out = []
    for i, img_id in enumerate(z["img_ids"]):
        s = slice(offs[i], offs[i + 1])
        rec = {"img_id": int(img_id), "boxes": z["boxes"][s],
               "scores": z["scores"][s], "labels": z["labels"][s]}
        if "embeds" in z:
            rec["embeds"] = z["embeds"][s]
        out.append(rec)
    return out


def recompute_metrics(ds, path: str, lvis: bool = False,
                      class_ids=None, matcher: str = "native"
                      ) -> Dict[str, float]:
    """Recompute COCO/LVIS metrics from a dump — must equal the live
    run's metrics bit-for-bit (tests/test_torch_eval_runner.py), with
    either matcher ("native" or its plain version "python")."""
    if lvis:
        from wedetect_tpu_torch.eval.lvis_map import LvisEvaluator

        ev = LvisEvaluator(
            class_ids=class_ids or range(len(ds.class_names)),
            frequencies=getattr(ds, "frequencies", None), matcher=matcher)
    else:
        from wedetect_tpu_torch.eval.coco_map import CocoEvaluator

        ev = CocoEvaluator(
            class_ids=class_ids or range(len(ds.class_names)),
            matcher=matcher)
    by_id: Dict[int, int] = {it["img_id"]: i
                             for i, it in enumerate(ds.items)}
    for rec in load_detections(path):
        idx = by_id[rec["img_id"]]
        if lvis:
            item = ds.items[idx]
            ev.add_image(ds.gt_arrays(idx), rec["boxes"], rec["scores"],
                         rec["labels"],
                         neg_cats=set(item.get("neg_cats", [])),
                         not_exhaustive=set(item.get("not_exhaustive",
                                                     [])))
        else:
            ev.add_image(ds.gt_arrays(idx), rec["boxes"], rec["scores"],
                         rec["labels"])
    return ev.summarize()
