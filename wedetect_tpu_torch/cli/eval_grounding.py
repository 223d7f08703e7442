"""Distributed REC / OVD grounding benchmark evaluation CLI.

Port of `wedetect_tpu/cli/eval_grounding.py`, covering every benchmark
of the reference driver (wedetect_ref/eval_grounding/eval.py):
refcoco/+/g (REC top-k), coco (open-vocabulary detection, every class
name a query), grefcoco, humanref, d3 and odinw13/35, with the
reference's merge modes (--single_box, --nms, --score_thre,
--num_select; eval.py:1585-1625).

Usage:
    python -m wedetect_tpu_torch.cli.eval_grounding \
        --ref_checkpoint <hf-dir> --dataset refcoco \
        --ann val.json testA.json --img-root imgs \
        --proposals proposals.json --num_select 20 --grid-tokens 256

    --dataset coco     --ann instances_val2017.json (1 file)
    --dataset grefcoco --ann val.json testA.json testB.json
    --dataset humanref --ann annotations.jsonl (proposals built in)
    --dataset d3       --ann full.json pres.json abs.json \
                       --pkl-root d3_pkl
    --dataset odinw    --odinw-spec spec.json
                       (spec: {name: {ann_path, img_path, classes_en}})

Dataset formats: eval/grounding_data.py. Proposals json: {image_name:
[boxes] | [[boxes], [scores]]}. Without a checkpoint, --random-init
scores with random weights and a stub tokenizer: the miniature Ref of
the other CLIs (--random-size tiny), or ref_2b at full width (2b).

The queries of an image batch into one prefill a bucket inside
RefScorer (the reference runs one forward a query); a shard of
one-query items (refcoco) with --grid-tokens batches across images
(RefScorer.score_rec), grouped by grid bucket from the files' headers
(data/loader.image_size). Each process scores a contiguous item shard
(eval/runner.process_shard) and predictions merge through
eval/dist.all_gather_object. --device cpu runs on the CPU; the default
is the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

# the host split of score_items and main (`timings=`), in ms: image
# header reads, image decodes, the scorer's calls (each ends in a
# read-back of its scores, so they hold the card's time), the merge and
# the metrics
TIMING_KEYS = ("header_ms", "load_ms", "score_ms", "merge_ms", "metrics_ms")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WeDetect-Ref grounding eval")
    p.add_argument("--ref_checkpoint", default="")
    p.add_argument("--random-init", action="store_true",
                   help="random weights and a stub tokenizer (no "
                        "checkpoint)")
    p.add_argument("--random-size", default="tiny", choices=["tiny", "2b"],
                   help="--random-init's model: the miniature Ref or "
                        "ref_2b at full width")
    p.add_argument("--dataset", default="refcoco",
                   choices=["refcoco", "coco", "grefcoco", "humanref",
                            "d3", "odinw"])
    p.add_argument("--ann", nargs="+", default=[])
    p.add_argument("--img-root", default="")
    p.add_argument("--proposals", default="")
    p.add_argument("--pkl-root", default="",
                   help="d3 pickled-annotation dir")
    p.add_argument("--odinw-spec", default="",
                   help="json of {name: {ann_path, img_path, classes_en}}")
    p.add_argument("--num_select", type=int, default=300)
    p.add_argument("--num_proposals", type=int, default=100)
    p.add_argument("--nms", action="store_true")
    p.add_argument("--score_thre", type=float, default=-1.0)
    p.add_argument("--single_box", action="store_true")
    p.add_argument("--max-items", type=int, default=0)
    p.add_argument("--batch-queries", type=int, default=8)
    p.add_argument("--int8-prefill", action="store_true",
                   help="dynamic int8 decoder / ViT prefill matmuls "
                        "(ops/int8.py)")
    p.add_argument("--grid-tokens", type=int, default=0,
                   help="snap images to fixed ~N-token grid buckets "
                        "(enables cross-image REC batching on one-query "
                        "datasets)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (default float32)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    return p.parse_args(argv)


def load_scorer(ckpt_dir: str, batch_queries: int, grid_tokens: int = 0,
                quant_prefill: bool = False, random_init: bool = False,
                random_size: str = "tiny", device="cuda",
                dtype: str = "float32"):
    """(RefScorer, its tokenizer's pad id): the checkpoint's model, or
    --random-init's."""
    from wedetect_tpu_torch.cli._ref_load import load_ref, random_ref
    from wedetect_tpu_torch.models.ref_api import RefScorer

    if random_init:
        cfg, model, tok = random_ref(random_size, device)
    else:
        cfg, model, tok = load_ref(ckpt_dir, device)
    buckets = None
    if grid_tokens:
        from wedetect_tpu_torch.data.vision_process import make_grid_buckets

        buckets = tuple(make_grid_buckets(
            grid_tokens, cfg.vision.patch * cfg.vision.merge))
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok,
                       query_batch=batch_queries, grid_buckets=buckets,
                       quant_prefill=quant_prefill, dtype=dtype,
                       device=device)
    pad = getattr(tok, "pad_token_id", None)
    return scorer, 151643 if pad is None else pad


def build_items(args):
    from wedetect_tpu_torch.eval import grounding_data as gd

    ds = args.dataset
    if ds == "refcoco":
        return gd.build_refcoco(args.ann, args.img_root)
    if ds == "coco":
        return gd.build_coco(args.ann[0], args.img_root)
    if ds == "grefcoco":
        return gd.build_grefcoco(args.ann, args.img_root)
    if ds == "humanref":
        return gd.build_humanref(args.ann[0], args.img_root)
    if ds == "d3":
        return gd.build_d3(args.img_root, args.pkl_root)
    if ds == "odinw":
        return gd.build_odinw(json.load(open(args.odinw_spec)))
    raise ValueError(ds)


def item_proposals(item, proposals_map, num_proposals):
    """Proposal boxes for one item (reference eval.py:536-546)."""
    props = (item.get("proposals")
             if item.get("proposals") is not None
             else proposals_map[item["image"]])
    if (len(props) == 2 and len(props[0]) > 0
            and isinstance(props[0][0], (list, tuple))):
        props = props[0]
    return np.asarray(props, np.float32).reshape(-1, 4)[:num_proposals]


@contextlib.contextmanager
def _timed(timings: Optional[Dict[str, float]], key: str):
    """Add the block's wall ms to timings[key] (nothing for None)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings[key] = (timings.get(key, 0.0)
                            + (time.perf_counter() - t0) * 1e3)


def score_items(items, scorer, proposals_map, args,
                timings: Optional[Dict[str, float]] = None):
    """Score a shard of items; returns per-item prediction dicts.

    One-query shards (refcoco-style REC) batch across images through
    RefScorer.score_rec when the scorer has grid buckets: the whole
    shard is grouped by bucket from header reads before it is chunked,
    so each fused call is bucket-pure. `args.pad_token_id`, when set, is
    the pad id of the scorer's sequences (default Qwen's 151643).
    timings, when given, gets the host split (TIMING_KEYS)."""
    from wedetect_tpu_torch.data.loader import image_size, load_image_rgb
    from wedetect_tpu_torch.data.vision_process import snap_to_bucket
    from wedetect_tpu_torch.eval.merge import merge_predictions

    pad = getattr(args, "pad_token_id", 151643)
    rec_batch = (all(len(it["queries"]) == 1 for it in items)
                 and getattr(scorer, "prefix_sharing", False)
                 and getattr(scorer, "grid_buckets", None))
    item_scores = {}
    if rec_batch:
        by_bucket = {}
        with _timed(timings, "header_ms"):
            for item in items:
                w0, h0 = image_size(os.path.join(item["img_root"],
                                                 item["image"]))
                b = snap_to_bucket(h0, w0, scorer.grid_buckets)
                by_bucket.setdefault(b, []).append(item)
        chunk = max(1, scorer.query_batch) * 4
        done = 0
        for grp_items in by_bucket.values():
            for st in range(0, len(grp_items), chunk):
                part = grp_items[st:st + chunk]
                samples = []
                with _timed(timings, "load_ms"):
                    for item in part:
                        props = item_proposals(item, proposals_map,
                                               args.num_proposals)
                        img = load_image_rgb(os.path.join(
                            item["img_root"], item["image"]))
                        samples.append((img, props, item["queries"][0]))
                with _timed(timings, "score_ms"):
                    scores = scorer.score_rec(samples, pad_token_id=pad)
                for item, sc, (_, props, _q) in zip(part, scores, samples):
                    item_scores[id(item)] = (sc[None], props)
                done += len(part)
                print(f"score {done}/{len(items)}", flush=True)

    results = []
    for n, item in enumerate(items):
        if id(item) in item_scores:
            scores_qn, props = item_scores[id(item)]
        else:
            with _timed(timings, "load_ms"):
                props = item_proposals(item, proposals_map,
                                       args.num_proposals)
                img = load_image_rgb(os.path.join(item["img_root"],
                                                  item["image"]))
            with _timed(timings, "score_ms"):
                scores_qn = scorer.score(img, props, item["queries"],
                                         pad_token_id=pad)
        with _timed(timings, "merge_ms"):
            boxes, qidx, scores = merge_predictions(
                scores_qn, props, single_box=args.single_box,
                nms=args.nms, score_thre=args.score_thre,
                num_select=args.num_select)
        labels = np.asarray(item["query_labels"])[qidx]
        results.append({
            "id": item["id"], "dataset": item["dataset"],
            "boxes": boxes, "labels": labels, "scores": scores,
            "gt_bboxes": item.get("gt_bboxes", []),
            "gt_labels": item.get("gt_labels", []),
            "no_target": item.get("no_target", False),
            "rejection": item.get("rejection", False),
            "total_persons": item.get("total_persons", 0),
        })
        if n % 50 == 0:
            print(f"score {n}/{len(items)}", flush=True)
    return results


def _coco_metric(results, ann_path, subset=None):
    """COCO bbox AP over original category ids; returns the summary
    plus per-class AP (consumed by the d3 length breakdown)."""
    from wedetect_tpu_torch.eval.coco_map import CocoEvaluator
    from wedetect_tpu_torch.eval.grounding_data import _load_coco_json

    images, anns_by_img, cats = _load_coco_json(ann_path)
    cat_ids = {c["id"] for c in cats}
    evaluator = CocoEvaluator(class_ids=sorted(cat_ids))
    by_id = {r["id"]: r for r in results
             if subset is None or r["dataset"] == subset}
    for im in images:
        r = by_id.get(im["id"])
        if r is None:
            continue
        gtb, gtl, crowd, areas = [], [], [], []
        for a in anns_by_img.get(im["id"], []):
            x, y, w, h = a["bbox"]
            gtb.append([x, y, x + w, y + h])
            gtl.append(a["category_id"])
            crowd.append(bool(a.get("iscrowd", 0)))
            areas.append(a.get("area", w * h))
        gt = {"boxes": np.asarray(gtb, np.float64).reshape(-1, 4),
              "labels": np.asarray(gtl, np.int64),
              "iscrowd": np.asarray(crowd, bool),
              "areas": np.asarray(areas, np.float64)}
        keep = np.isin(np.asarray(r["labels"]), sorted(cat_ids))
        evaluator.add_image(gt, np.asarray(r["boxes"])[keep],
                            np.asarray(r["scores"])[keep],
                            np.asarray(r["labels"])[keep])
    out = evaluator.summarize()
    cat_names = {c["id"]: c["name"] for c in cats}
    return out, cat_names


def run_metrics(dataset, results, args):
    """Per-benchmark metric dispatch (reference eval.py:1671-1709)."""
    from wedetect_tpu_torch.eval.grounding_metrics import (
        dod_length_breakdown, grefcoco_metrics, humanref_density_f1)
    from wedetect_tpu_torch.eval.rec import rec_topk_accuracy

    out = {}
    if dataset == "refcoco":
        subsets = sorted({r["dataset"] for r in results})
        for sub in subsets:
            rs = [r for r in results if r["dataset"] == sub]
            out[sub] = rec_topk_accuracy(
                [np.asarray(r["boxes"]) for r in rs],
                [np.asarray(r["gt_bboxes"]).reshape(-1, 4) for r in rs])
    elif dataset in ("coco", "odinw"):
        if dataset == "coco":
            m, _ = _coco_metric(results, args.ann[0])
            m.pop("per_class", None)
            out["coco"] = m
        else:
            spec = json.load(open(args.odinw_spec))
            maps = []
            for name, sub in spec.items():
                m, _ = _coco_metric(results, sub["ann_path"], name)
                m.pop("per_class", None)
                out[name] = m
                maps.append(m["mAP"])
            out["average_mAP"] = float(np.mean(maps))
    elif dataset == "grefcoco":
        for path, sub in zip(args.ann, ("val", "testA", "testB")):
            rs = [dict(pred_boxes=r["boxes"],
                       gt_boxes=np.asarray(r["gt_bboxes"]).reshape(-1, 4),
                       no_target=r["no_target"])
                  for r in results if r["dataset"] == sub]
            out[sub] = grefcoco_metrics(rs)
    elif dataset == "humanref":
        rs = [dict(pred_boxes=r["boxes"],
                   gt_boxes=np.asarray(r["gt_bboxes"]).reshape(-1, 4),
                   total_persons=r["total_persons"],
                   rejection=r["rejection"]) for r in results]
        out["humanref"] = humanref_density_f1(rs)
    elif dataset == "d3":
        for path, sub in zip(args.ann, ("FULL", "PRES", "ABS")):
            m, cat_names = _coco_metric(results, path)
            per_class = m.pop("per_class", {})
            m.update(dod_length_breakdown(per_class, cat_names))
            out[sub] = m
    return out


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """Run the evaluation; rank 0 computes, prints and returns the
    metrics (and writes --out), other ranks return None. timings, when
    given, gets this process's host split (TIMING_KEYS), its item count
    and its wall ms."""
    args = parse_args(argv)
    from wedetect_tpu_torch.eval import dist
    from wedetect_tpu_torch.eval.runner import process_shard

    if not args.random_init and not args.ref_checkpoint:
        raise SystemExit("supply --ref_checkpoint (or --random-init)")
    dist.maybe_initialize(args.device)
    items = build_items(args)
    proposals_map = (json.load(open(args.proposals))
                     if args.proposals else {})
    scorer, args.pad_token_id = load_scorer(
        args.ref_checkpoint, args.batch_queries, args.grid_tokens,
        args.int8_prefill, args.random_init, args.random_size, args.device,
        "bfloat16" if args.bf16 else "float32")

    shard = [items[i] for i in process_shard(len(items))]
    if args.max_items:
        shard = shard[:args.max_items]
    t0 = time.perf_counter()
    results = score_items(shard, scorer, proposals_map, args, timings)
    merged = dist.all_gather_object(results)
    results = [r for part in merged for r in part]
    out = None
    if dist.process_index() == 0:
        with _timed(timings, "metrics_ms"):
            out = run_metrics(args.dataset, results, args)
        print(json.dumps(out, indent=2, default=float))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, default=float)
    wall = time.perf_counter() - t0
    print(f"{len(shard)} items in {wall:.2f} s "
          f"({len(shard) / wall:.2f} items/s)", file=sys.stderr)
    if timings is not None:
        timings.update(items=len(shard), wall_ms=wall * 1e3)
    return out


if __name__ == "__main__":
    main()
