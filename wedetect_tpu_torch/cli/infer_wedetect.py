"""Demo inference CLI (mirrors reference infer_wedetect.py:58-99):

    python -m wedetect_tpu_torch.cli.infer_wedetect \
        --checkpoint wedetect_base.pth --size base \
        --image demo.jpeg --text "person,dog" --topk 100 --threshold 0.1

With --random-init the detector runs with random weights (smoke mode);
--int8 runs the int8 serving mode (ModelCfg.quant_int8, ops/int8.py).
--output PATH draws the detections into PATH (utils/vis.draw_detections,
captions in --font or a probed CJK font). Unlike the JAX CLI, whose
--output defaults to pred.png, nothing is drawn without --output.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WeDetect demo inference "
                                            "(PyTorch)")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--size", default="base",
                   choices=["tiny", "small", "base", "large"])
    p.add_argument("--image", required=True)
    p.add_argument("--text", required=True,
                   help="comma-separated class prompts")
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--threshold", type=float, default=0.1)
    p.add_argument("--output", default="",
                   help="draw the detections into this image file")
    p.add_argument("--font", default=None,
                   help="TrueType font path for captions (CJK class "
                        "names need one, e.g. simsun.ttc; common system "
                        "CJK fonts are probed when omitted)")
    p.add_argument("--tokenizer", default="xlm-roberta-base")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="dynamic int8 channel-mixing matmuls and convs "
                        "(serving mode; ops/int8.py)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from wedetect_tpu_torch.models.api import Detector

    kw = dict(compute_dtype="bfloat16") if args.bf16 else {}
    if args.int8:
        kw["quant_int8"] = True
    texts = [t.strip() for t in args.text.split(",") if t.strip()]
    if args.random_init or not args.checkpoint:
        det = Detector.from_random(args.size, device=args.device, **kw)
        det.reparameterize(texts, embeds=np.random.default_rng(0)
                           .standard_normal((len(texts), 768))
                           .astype(np.float32))
    else:
        det = Detector.from_torch_checkpoint(
            args.checkpoint, args.size, tokenizer_path=args.tokenizer,
            device=args.device, **kw)
        det.reparameterize(texts)

    r = det([args.image], score_thr=args.threshold, max_dets=args.topk)[0]
    print(f"{len(r['bboxes'])} detections over thr {args.threshold}")
    for b, s, l in zip(r["bboxes"][:10], r["scores"][:10],
                       r["labels"][:10]):
        print(f"  {texts[int(l)]:>12s} {s:.3f} "
              f"[{b[0]:.0f},{b[1]:.0f},{b[2]:.0f},{b[3]:.0f}]")
    if args.output:
        from wedetect_tpu_torch.data.loader import load_image_rgb
        from wedetect_tpu_torch.utils.vis import draw_detections

        img = draw_detections(load_image_rgb(args.image), r["bboxes"],
                              r["scores"], r["labels"], class_names=texts,
                              font_path=args.font)
        img.save(args.output)
        print(f"saved {args.output}")
    return r


if __name__ == "__main__":
    main()
