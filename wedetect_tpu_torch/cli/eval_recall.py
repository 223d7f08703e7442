"""Uni proposal-recall evaluation CLI.

Usage (mirrors reference eval_recall/eval_recall.py):

    python -m wedetect_tpu_torch.cli.eval_recall \
        --checkpoint uni_base.pth --ann instances_val2017.json \
        --img-root val2017 [--max-images N]

Computes Recall@100/300 over IoU .5:.95 with the reference's greedy
matcher, on WeDetect-Uni's proposals (score_thr 0, max_per_img
--num-proposals). Runs on the card unless `--device cpu`; several
processes each take a contiguous shard and the proposals are merged.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WeDetect-Uni recall eval "
                                            "(PyTorch)")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--size", default="base")
    p.add_argument("--ann", required=True)
    p.add_argument("--img-root", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--num-proposals", type=int, default=300)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from wedetect_tpu_torch.eval.dist import maybe_initialize

    maybe_initialize(args.device)
    import dataclasses

    import numpy as np

    from wedetect_tpu_torch.data.coco import CocoDetDataset
    from wedetect_tpu_torch.data.loader import EvalLoader
    from wedetect_tpu_torch.eval.dist import all_gather_object
    from wedetect_tpu_torch.eval.recall import (eval_recalls,
                                                summarize_recalls)
    from wedetect_tpu_torch.eval.runner import process_shard
    from wedetect_tpu_torch.models.api import Detector
    from wedetect_tpu_torch.models.wedetect import detect_step

    ds = CocoDetDataset(args.ann, args.img_root)
    if args.random_init or not args.checkpoint:
        det = Detector.from_random(f"uni_{args.size}", device=args.device,
                                   compute_dtype="bfloat16")
    else:
        det = Detector.from_torch_checkpoint(
            args.checkpoint, args.size, uni=True, device=args.device,
            compute_dtype="bfloat16")
    cfg = dataclasses.replace(
        det.cfg, test=dataclasses.replace(
            det.cfg.test, score_thr=0.0,
            max_per_img=args.num_proposals))

    indices = list(process_shard(len(ds)))
    if args.max_images:
        indices = indices[:args.max_images]
    loader = EvalLoader(ds, cfg.img_size, batch_size=args.batch_size,
                        indices=indices)
    gts, props = [], []
    for batch in loader:
        out = detect_step(cfg, det.model, batch["images"], None,
                          batch["scale_factor"], batch["pad_param"],
                          batch["ori_shape"])
        boxes = out.boxes.cpu().numpy()
        scores = out.scores.cpu().numpy()
        valid = out.valid.cpu().numpy()
        for i, idx in enumerate(batch["idxs"]):
            v = valid[i]
            gts.append(ds.gt_arrays(idx)["boxes"])
            props.append(np.concatenate(
                [boxes[i][v], scores[i][v][:, None]], -1))
    merged = all_gather_object((gts, props))
    gts = [g for part in merged for g in part[0]]
    props = [p for part in merged for p in part[1]]
    recalls = eval_recalls(gts, props, proposal_nums=(100, 300))
    summary = summarize_recalls(recalls)
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
