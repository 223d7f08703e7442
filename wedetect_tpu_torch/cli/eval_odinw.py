"""ODinW (Object Detection in the Wild) multi-dataset evaluation.

Behavioral spec: reference eval_grounding/eval.py ds_collections
odinw13/odinw35 entries: each sub-dataset is COCO-format with its own
English class list; the headline is mean mAP over sub-datasets. The
port of `wedetect_tpu.cli.eval_odinw`: the port's CocoDetDataset,
Detector (bf16 compute) and eval/runner.evaluate_coco.

Layout expected under --root (the standard ODinW download):
    <root>/<subset>/.../{annotations json}  +  images
Pass --subsets or let the CLI autodiscover the annotation files named
'*test*.json' (else '*valid*.json') under each subset; the pattern
matches the file's name, not its directory's.

    python -m wedetect_tpu_torch.cli.eval_odinw --root data/odinw \\
        --checkpoint wedetect_base.pth --size base

Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ODinW evaluation (PyTorch)")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--size", default="base")
    p.add_argument("--root", required=True)
    p.add_argument("--subsets", nargs="*", default=None)
    p.add_argument("--tokenizer", default="xlm-roberta-base")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def discover(root):
    """Find (name, ann_file, img_root) per subset."""
    out = []
    for sub in sorted(os.listdir(root)):
        subdir = os.path.join(root, sub)
        if not os.path.isdir(subdir):
            continue
        anns = (glob.glob(os.path.join(subdir, "**", "*test*.json"),
                          recursive=True)
                or glob.glob(os.path.join(subdir, "**",
                                          "*valid*.json"),
                             recursive=True))
        if anns:
            out.append((sub, anns[0], os.path.dirname(anns[0])))
    return out


def main(argv=None):
    args = parse_args(argv)
    from wedetect_tpu_torch.eval.dist import maybe_initialize

    maybe_initialize(args.device)
    import numpy as np

    from wedetect_tpu_torch.data.coco import CocoDetDataset
    from wedetect_tpu_torch.eval.runner import evaluate_coco
    from wedetect_tpu_torch.models.api import Detector

    subsets = discover(args.root)
    if args.subsets:
        subsets = [s for s in subsets if s[0] in set(args.subsets)]
    if not subsets:
        raise SystemExit(f"no ODinW subsets found under {args.root}")

    results = {}
    for name, ann, img_root in subsets:
        ds = CocoDetDataset(ann, img_root)
        texts = ds.class_names
        kw = dict(compute_dtype="bfloat16", num_classes=len(texts),
                  device=args.device)
        if args.random_init or not args.checkpoint:
            det = Detector.from_random(args.size, **kw)
            det.reparameterize(texts, embeds=np.random.default_rng(0)
                               .standard_normal((len(texts), 768))
                               .astype(np.float32))
        else:
            det = Detector.from_torch_checkpoint(
                args.checkpoint, args.size,
                tokenizer_path=args.tokenizer, **kw)
            det.reparameterize(texts)
        m = evaluate_coco(det.cfg, det.model, ds, det._text_embeds,
                          batch_size=args.batch_size,
                          max_images=args.max_images or None)
        results[name] = m["mAP"]
        print(f"{name}: mAP {m['mAP']:.4f}", flush=True)
    vals = [v for v in results.values()
            if not (v != v)]  # drop NaN
    results["mean_mAP"] = float(np.mean(vals)) if vals else 0.0
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    return results


if __name__ == "__main__":
    main()
