"""The comparison that decides `correct` for detection answers.

For every sampled image the reference computes, in float32, its
per-anchor scores, boxes and region embeddings and its own selection
and NMS. Each of the program's detections is tied to the reference's
anchor whose embedding and box lie nearest (embeddings are distinct per
anchor; the box term separates anchors whose embeddings tie), and
judged by what it says. The numbers, maxima over every
detection (`*_mean`: their means; counts summed over the images):

- `det_embed_gap`, `det_embed_gap_mean`: the relative L2 distance of a
  detection's 768-d embedding from its anchor's (the network);
- `det_logit_gap_mean`: |logit(score) - the reference's logit of that
  anchor and label| (the scores and labels as produced);
- `missed`: the reference's top MISS_TOP detections that the program
  neither returned (same anchor and label) nor replaced by one of its
  own that the reference ranks near it (same label, IoU above
  EXCUSE_IOU, at least EXCUSE_SCORE of its score: the suppression a
  greedy NMS flips when two boxes overlap at its threshold); a
  selection that returns the wrong candidates misses them;
- `det_pair_iou`: the largest IoU of two of the program's detections
  of one label, by the reference's boxes of their anchors: the
  configuration's NMS keeps it under its IoU threshold, give or take
  the boxes' rounding, and an NMS that suppresses too little does not;
- recorded besides: `det_score_gap` (|score - the reference's|, and the
  scores missed), `det_miss_score`, `det_box_gap_px` (the distance,
  max over the four coordinates, original image pixels, of a box from
  its anchor's reference box).

Which of them a cell holds, and to what limit, its workload file says
(PERF.md §2 gives the readings).

A missing or malformed answer reads BAD in every number.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import detector as R
from benchmark.reference import no_tf32
from benchmark.reference.letterbox import letterbox

MISS_TOP = 100
EXCUSE_IOU = 0.5
EXCUSE_SCORE = 0.5
BAD = 1e9


def image_gaps(logits, boxes_lb, boxes_o, emb, ans, rc: R.DetCfg):
    """One image: logits (A, K), letterboxed and original boxes (A, 4),
    embeddings (A, C) of the reference; ans the program's answer dict.
    Returns {number: (kind, value)}, kind "max" or "sum" (with "n", the
    detections, for the means)."""
    dev = logits.device
    k = logits.shape[1]
    scores = torch.sigmoid(logits)
    r_anc, r_lab, r_sc = R.select_and_nms(scores, boxes_lb, rc)
    r_anc, r_lab, r_sc = (x[:MISS_TOP] for x in (r_anc, r_lab, r_sc))
    bad = {key: ("max", BAD) for key in MAXES}
    if ans is None:
        return dict(bad, missing=("sum", 1))
    pb = torch.as_tensor(ans["bboxes"], device=dev, dtype=torch.float32)
    ps = torch.as_tensor(ans["scores"], device=dev, dtype=torch.float32)
    pl = torch.as_tensor(ans["labels"], device=dev).long()
    pe = torch.as_tensor(ans["embeddings"], device=dev,
                         dtype=torch.float32)
    n = len(ps)
    if (pb.shape != (n, 4) or pe.shape != (n, emb.shape[1])
            or pl.shape != (n,) or ((pl < 0) | (pl >= k)).any()
            or not torch.isfinite(pb).all()):
        return dict(bad, malformed=("sum", 1))
    out = {key: ("max", 0.0) for key in MAXES}
    out.update({key: ("sum", 0.0) for key in SUMS})
    matched = torch.zeros(len(r_anc), dtype=torch.bool, device=dev)
    if n:
        norm = torch.linalg.vector_norm(emb, dim=1)
        rel = torch.cdist(pe, emb) / norm[None]
        bdist = torch.cdist(pb, boxes_o, p=float("inf"))
        anc = torch.argmin(rel + bdist / 16.0, dim=1)
        rows = torch.arange(n, device=dev)
        ds = (ps - scores[anc, pl]).abs()
        dl = (torch.logit(ps.clamp(1e-7, 1 - 1e-7)) - logits[anc, pl]).abs()
        # cdist's matmul form cancels; the matched pairs' distance again,
        # directly
        de = torch.linalg.vector_norm(pe - emb[anc], dim=1) / norm[anc]
        db = bdist[rows, anc]
        for key, d in (("det_score_gap", ds), ("det_embed_gap", de),
                       ("det_box_gap_px", db)):
            out[key] = ("max", float(d.max()))
        for key, d in (("det_logit_gap", dl), ("det_embed_gap", de)):
            out[f"{key}_sum"] = ("sum", float(d.sum()))
        same = (anc[None, :] == r_anc[:, None]) & (pl[None, :]
                                                   == r_lab[:, None])
        matched = same.any(dim=1)
        iou = R.iou_matrix(boxes_lb[r_anc], boxes_lb[anc])
        near = ((pl[None, :] == r_lab[:, None]) & (iou > EXCUSE_IOU)
                & (scores[anc][:, r_lab].T >= EXCUSE_SCORE * r_sc[:, None]))
        matched |= near.any(dim=1)
        # how far two detections of one label overlap, by the
        # reference's boxes of their anchors (NMS keeps them apart)
        iou = R.iou_matrix(boxes_lb[anc], boxes_lb[anc])
        pair = ((pl[:, None] == pl[None, :])
                & torch.ones_like(iou, dtype=torch.bool).triu(1))
        out["det_pair_iou"] = ("max", float(
            torch.where(pair, iou, torch.zeros_like(iou)).max()))
    missed = r_sc[~matched]
    miss = float(missed.max()) if len(missed) else 0.0
    out["det_miss_score"] = ("max", miss)
    out["det_score_gap"] = ("max", max(out["det_score_gap"][1], miss))
    out.update(detections=("sum", n), reference_top=("sum", len(r_anc)),
               missed=("sum", int((~matched).sum())))
    return out


MAXES = ("det_score_gap", "det_box_gap_px", "det_embed_gap",
         "det_miss_score", "det_pair_iou")
SUMS = ("det_logit_gap_sum", "det_embed_gap_sum")


def compare_images(ref, rc: R.DetCfg, images, answers, embeds, flavor,
                    dev, block: int) -> dict:
    """The reference on images (blocks of `block`), each answer judged
    against it. embeds: (K, C) class embeddings, or None (the prompt
    bank). Maxima over every detection; `*_mean` the sums' means."""
    out = {key: 0.0 for key in MAXES}
    totals = {"images": len(images)}
    for st in range(0, len(images), block):
        chunk = images[st:st + block]
        boxed = [letterbox(im, rc.img_size, flavor) for im in chunk]
        x = torch.as_tensor(np.stack([b[0] for b in boxed]), device=dev)
        with torch.inference_mode(), no_tf32():
            logits, boxes, emb = ref(x, embeds)
            for j, (im, (_, sf, pad)) in enumerate(zip(chunk, boxed)):
                bo = R.unletterbox(boxes[j], sf, pad, im.shape[:2])
                g = image_gaps(logits[j], boxes[j], bo, emb[j],
                               answers[st + j], rc)
                for key, (kind, v) in g.items():
                    if kind == "max":
                        out[key] = max(out.get(key, 0.0), v)
                    else:
                        totals[key] = totals.get(key, 0) + v
        del logits, boxes, emb
    for key in SUMS:
        if key in totals:
            out[key.replace("_sum", "_mean")] = (
                totals.pop(key) / max(totals.get("detections", 0), 1))
    out.update(totals)
    return out


def reference_answers(ref, rc: R.DetCfg, images, embeds, flavor, dev,
                      block: int) -> list:
    """The reference's own answers to images, in the program's format
    (one dict an image: bboxes in original image coordinates, scores,
    labels, embeddings): the control, where `ref` computes in fp8."""
    out = []
    for st in range(0, len(images), block):
        chunk = images[st:st + block]
        boxed = [letterbox(im, rc.img_size, flavor) for im in chunk]
        x = torch.as_tensor(np.stack([b[0] for b in boxed]), device=dev)
        with torch.inference_mode(), no_tf32():
            logits, boxes, emb = ref(x, embeds)
            for j, (im, (_, sf, pad)) in enumerate(zip(chunk, boxed)):
                anc, lab, sc = R.select_and_nms(torch.sigmoid(logits[j]),
                                                boxes[j], rc)
                bo = R.unletterbox(boxes[j][anc], sf, pad, im.shape[:2])
                out.append({k: v.cpu().numpy() for k, v in (
                    ("bboxes", bo), ("scores", sc), ("labels", lab),
                    ("embeddings", emb[j][anc]))})
        del logits, boxes, emb
    return out
