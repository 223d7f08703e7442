"""Object-retrieval embedding extraction CLI.

Usage (mirrors reference eval_retrieval/extract_embedding.py):

    python -m wedetect_tpu_torch.cli.extract_embedding \
        --checkpoint uni_base.pth --wedetect-checkpoint base.pth \
        --ann ann.json --img-root imgs --class-texts texts.json \
        --out embeddings.npz

Saves per-image proposal embeddings (+ per-proposal BN scale/bias) and
the text-bank embeddings as a pickle; score offline with
`wedetect_tpu_torch.eval.retrieval`. Runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="WeDetect-Uni embedding extraction (PyTorch)")
    p.add_argument("--checkpoint", default="",
                   help="Uni checkpoint for proposals+embeddings")
    p.add_argument("--wedetect-checkpoint", default="",
                   help="detector ckpt providing the text tower")
    p.add_argument("--size", default="base")
    p.add_argument("--ann", required=True)
    p.add_argument("--img-root", required=True)
    p.add_argument("--class-texts", default="")
    p.add_argument("--class-set", default="",
                   choices=("", "coco", "lvis"),
                   help="use the canonical CN/EN retrieval tables "
                        "(data/retrieval_classes.json — the tables "
                        "the reference embeds in extract_embedding.py"
                        ":1324-1587) instead of --class-texts or the "
                        "dataset's names")
    p.add_argument("--lang", default="zh", choices=("zh", "en"),
                   help="language for --class-set (the reference "
                        "protocol encodes the CHINESE names)")
    p.add_argument("--tokenizer", default="xlm-roberta-base")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--out", default="embeddings.npz")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from wedetect_tpu_torch.eval.dist import maybe_initialize

    maybe_initialize(args.device)
    import dataclasses
    import pickle

    import numpy as np

    from wedetect_tpu_torch.data.coco import (CocoDetDataset, first_texts,
                                              load_class_texts)
    from wedetect_tpu_torch.data.loader import EvalLoader
    from wedetect_tpu_torch.eval.runner import process_shard
    from wedetect_tpu_torch.models.api import Detector
    from wedetect_tpu_torch.models.wedetect import (detect_step,
                                                    per_anchor_scale_bias)

    ds = CocoDetDataset(args.ann, args.img_root)
    if args.random_init or not args.checkpoint:
        uni = Detector.from_random(f"uni_{args.size}", device=args.device,
                                   compute_dtype="bfloat16")
    else:
        uni = Detector.from_torch_checkpoint(
            args.checkpoint, args.size, uni=True, device=args.device,
            compute_dtype="bfloat16")
    cfg = dataclasses.replace(
        uni.cfg, test=dataclasses.replace(uni.cfg.test, score_thr=0.0))

    # text embeddings from the WeDetect checkpoint's text tower
    # (reference: extract_embedding.py:1293-1304); class names from a
    # --class-texts file, the canonical --class-set tables (the
    # reference encodes its embedded CHINESE tables,
    # extract_embedding.py:1706-1713), or the dataset
    if args.class_texts:
        texts = first_texts(load_class_texts(args.class_texts))
    elif args.class_set:
        from wedetect_tpu_torch.data.retrieval_classes import (
            load_retrieval_classes)
        texts = load_retrieval_classes(args.class_set, args.lang)
    else:
        texts = ds.class_names
    if args.random_init or not args.wedetect_checkpoint:
        text_embedding = np.random.default_rng(0).standard_normal(
            (len(texts), cfg.embed_dims)).astype(np.float32)
    else:
        det = Detector.from_torch_checkpoint(
            args.wedetect_checkpoint, args.size,
            tokenizer_path=args.tokenizer, device=args.device)
        det.reparameterize(texts)
        text_embedding = det._text_embeds.cpu().numpy()

    # anchors are tracked per kept proposal, so the per-level scale and
    # bias vectors index correctly
    scale_vec, bias_vec = per_anchor_scale_bias(cfg, uni.model)
    indices = list(process_shard(len(ds)))
    if args.max_images:
        indices = indices[:args.max_images]
    loader = EvalLoader(ds, cfg.img_size, batch_size=args.batch_size,
                        indices=indices)
    image_embedding = []
    for batch in loader:
        out = detect_step(cfg, uni.model, batch["images"], None,
                          batch["scale_factor"], batch["pad_param"],
                          batch["ori_shape"])
        out = type(out)(*(x.cpu().numpy() for x in out))
        for i, img_id in enumerate(batch["img_ids"]):
            v = out.valid[i]
            anchors = out.anchors[i][v]
            image_embedding.append({
                "image_id": img_id,
                "embedding": out.embeds[i][v],
                "scale": scale_vec[anchors],
                "bias": bias_vec[anchors],
                "scores": out.scores[i][v],
                "bboxes": out.boxes[i][v],
            })
    payload = {"image_embedding": image_embedding,
               "text_embedding": text_embedding,
               "classnames": texts}
    with open(args.out, "wb") as f:
        pickle.dump(payload, f)
    print(f"saved {len(image_embedding)} images -> {args.out}")
    return payload


if __name__ == "__main__":
    main()
