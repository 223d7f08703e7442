"""WeDetect-Uni proposal generation CLI (mirrors reference
generate_proposal.py:1222-1273):

    python -m wedetect_tpu_torch.cli.generate_proposal \
        --wedetect_uni_checkpoint uni_base.pth --image demo.jpeg \
        --score_thre 0.1 --num_proposals 300

Outputs proposals as {bboxes, scores, embeddings}; --save-npz dumps
them. The detect step runs with score_thr 0 here, so every anchor holds
all its prompts as candidates and the pre-NMS selection takes its dense
branch. --int8 runs the int8 serving mode (ModelCfg.quant_int8,
ops/int8.py). --visualize draws the proposals into --output
(utils/vis.draw_detections, every box as class 0).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WeDetect-Uni proposals "
                                            "(PyTorch)")
    p.add_argument("--wedetect_uni_checkpoint", default="")
    p.add_argument("--image", required=True)
    p.add_argument("--score_thre", type=float, default=0.1)
    p.add_argument("--num_proposals", type=int, default=300)
    p.add_argument("--size", default="",
                   help="base/large; inferred from ckpt name if empty")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--output", default="pred.png")
    p.add_argument("--save-npz", default="")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="dynamic int8 channel-mixing matmuls and convs "
                        "(serving mode; ops/int8.py)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import dataclasses

    import numpy as np

    from wedetect_tpu_torch.models.api import Detector

    size = args.size or ("base" if "base" in args.wedetect_uni_checkpoint
                         else "large" if args.wedetect_uni_checkpoint
                         else "base")
    kw = dict(compute_dtype="bfloat16") if args.bf16 else {}
    if args.int8:
        kw["quant_int8"] = True
    if args.random_init or not args.wedetect_uni_checkpoint:
        det = Detector.from_random(f"uni_{size}", device=args.device, **kw)
    else:
        det = Detector.from_torch_checkpoint(
            args.wedetect_uni_checkpoint, size, uni=True,
            device=args.device, **kw)
    # cap proposals at num_proposals slots
    cfg = det.cfg
    det.cfg = dataclasses.replace(
        cfg, test=dataclasses.replace(cfg.test,
                                      max_per_img=args.num_proposals,
                                      score_thr=0.0))

    r = det([args.image], score_thr=args.score_thre)[0]
    print(f"{len(r['bboxes'])} proposals over thr {args.score_thre} "
          f"(embeddings {r['embeddings'].shape})")
    if args.save_npz:
        np.savez(args.save_npz, bboxes=r["bboxes"], scores=r["scores"],
                 embeddings=r["embeddings"])
        print(f"saved {args.save_npz}")
    if args.visualize:
        from wedetect_tpu_torch.data.loader import load_image_rgb
        from wedetect_tpu_torch.utils.vis import draw_detections

        img = draw_detections(load_image_rgb(args.image), r["bboxes"],
                              r["scores"],
                              np.zeros(len(r["bboxes"]), np.int64))
        img.save(args.output)
        print(f"saved {args.output}")
    return r


if __name__ == "__main__":
    main()
