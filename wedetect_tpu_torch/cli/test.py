"""Dataset evaluation CLI (COCO / LVIS bbox mAP).

Usage (mirrors reference test.py + dist_test.sh):

    python -m wedetect_tpu_torch.cli.test \
        --checkpoint wedetect_base.pth --size base \
        --ann data/coco/annotations/instances_val2017.json \
        --img-root data/coco/val2017 \
        --class-texts data/texts/coco_zh_class_texts.json

`--lvis` evaluates with the LVIS fixed-AP protocol (APr/APc/APf),
`--tta` adds the horizontal-flip view, `--dump` writes the raw
predictions (eval/dump.py), `--int8` runs the int8 serving mode.
Runs on the card unless `--device cpu`. Several processes (torchrun,
or WEDETECT_DIST=1 with RANK / WORLD_SIZE) each take a contiguous
shard; the metrics are merged (eval/dist.py).
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WeDetect evaluation "
                                            "(PyTorch)")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--size", default="base")
    p.add_argument("--ann", required=True)
    p.add_argument("--img-root", required=True)
    p.add_argument("--class-texts", default="",
                   help="class-text JSON; falls back to category names")
    p.add_argument("--tokenizer", default="xlm-roberta-base")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--int8", action="store_true",
                   help="dynamic-int8 channel-mixing matmuls "
                        "(serving mode; ops/int8.py)")
    p.add_argument("--tta", action="store_true",
                   help="horizontal-flip test-time augmentation "
                        "(reference test.py --tta)")
    p.add_argument("--lvis", action="store_true",
                   help="LVIS fixed-AP protocol (neg/not-exhaustive "
                        "image domains, per-class cap, APr/c/f)")
    p.add_argument("--out", default="")
    p.add_argument("--dump", default="",
                   help="write raw per-image predictions (boxes/scores/"
                        "labels/embeds, eval/dump.py .npz layout) for "
                        "offline metric recompute — DumpDetResults "
                        "role (reference test.py:29,143)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from wedetect_tpu_torch.eval.dist import maybe_initialize

    maybe_initialize(args.device)
    import numpy as np

    from wedetect_tpu_torch.data.coco import (CocoDetDataset, first_texts,
                                              load_class_texts)
    from wedetect_tpu_torch.eval.runner import evaluate_coco
    from wedetect_tpu_torch.models.api import Detector

    ds = CocoDetDataset(args.ann, args.img_root)
    texts = (first_texts(load_class_texts(args.class_texts))
             if args.class_texts else ds.class_names)
    kw = dict(num_classes=len(texts))
    if args.bf16:
        kw["compute_dtype"] = "bfloat16"
    if args.int8:
        kw["quant_int8"] = True
    if args.random_init or not args.checkpoint:
        det = Detector.from_random(args.size, device=args.device, **kw)
        det.reparameterize(texts, embeds=np.random.default_rng(0)
                           .standard_normal((len(texts),
                                             det.cfg.embed_dims))
                           .astype(np.float32))
    else:
        det = Detector.from_torch_checkpoint(
            args.checkpoint, args.size, tokenizer_path=args.tokenizer,
            device=args.device, **kw)
        det.reparameterize(texts)

    metrics = evaluate_coco(det.cfg, det.model, ds, det._text_embeds,
                            batch_size=args.batch_size,
                            max_images=args.max_images or None,
                            progress=True, lvis=args.lvis, tta=args.tta,
                            dump_path=args.dump or None)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
