"""WeDetect-Ref REC demo: Uni proposals + one query -> best box; or
chat / captioning with --generate, of an image or of a video (--video).

    python -m wedetect_tpu_torch.cli.infer_wedetect_ref \
        --ref_checkpoint <hf-dir> --wedetect_uni_checkpoint u.pth \
        --image demo.jpg --query "the red box"
    python -m wedetect_tpu_torch.cli.infer_wedetect_ref \
        --ref_checkpoint <hf-dir> --image demo.jpg \
        --generate "Describe the image." [--int8-decode | --int4-decode]
        [--speculative] [--temperature 0.7] [--int8-prefill]
    python -m wedetect_tpu_torch.cli.infer_wedetect_ref \
        --ref_checkpoint <hf-dir> --video clip.mp4 [--fps 2 | --nframes 8] \
        --generate "Describe the clip."

Port of the JAX package's CLI (reference infer_wedetect_ref.py:13-135):
scoring runs WeDetect-Uni proposals, then RefScorer.score; --generate
runs RefScorer.generate_text (the twin of the stage-1/2 class's
inherited HF .generate()); --video with --generate runs
RefScorer.generate_video_text on any source fetch_video accepts (a
video file, a frame directory or glob, a GIF, an .npy stack), sampled
at --fps or to --nframes. With --generate, --random-init runs a
miniature random Ref with a stub tokenizer (a smoke run); scoring
refuses it, as the JAX CLI does. --int8-prefill runs every prefill's
ViT and decoder matmuls in dynamic int8 (RefScorer(quant_prefill=True),
ops/int8.py), in scoring and generation. --visualize draws the kept
boxes with the query as their caption into --output
(utils/vis.draw_detections).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WeDetect-Ref REC demo "
                                            "(PyTorch)")
    p.add_argument("--ref_checkpoint", default="")
    p.add_argument("--wedetect_uni_checkpoint", default="")
    p.add_argument("--image", default="")
    p.add_argument("--video", default="",
                   help="video source (file/dir/glob/GIF/.npy: "
                        "data/vision_process.fetch_video) for --generate "
                        "video chat; scoring stays image-only, as in the "
                        "reference")
    p.add_argument("--fps", type=float, default=None,
                   help="target sampling fps for --video (smart_nframes; "
                        "default 2.0)")
    p.add_argument("--nframes", type=int, default=None,
                   help="exact frame count for --video (rounded to the "
                        "frame factor)")
    p.add_argument("--query", default="")
    p.add_argument("--score_thre", type=float, default=-1.0,
                   help="<0: top-1 box; >=0: threshold")
    p.add_argument("--num_proposals", type=int, default=100)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--output", default="pred_ref.png")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--generate", default="",
                   help="chat/caption prompt: text generation instead of "
                        "proposal scoring (models/ref_generate)")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--int8-prefill", action="store_true",
                   help="dynamic int8 decoder/ViT prefill matmuls "
                        "(ops/int8.py)")
    p.add_argument("--int8-decode", action="store_true",
                   help="weight-only int8 generation decode (models/quant)")
    p.add_argument("--int4-decode", action="store_true",
                   help="weight-only packed-int4 generation decode "
                        "(models/quant; lossier, validate per checkpoint)")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (greedy only; "
                        "models/ref_speculative)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _gen_scorer(args):
    """(scorer, eos and pad ids) of the generation modes: the miniature
    random Ref under --random-init, else the checkpoint's."""
    from wedetect_tpu_torch.cli._ref_load import load_ref, tiny_random_ref
    from wedetect_tpu_torch.models.ref_api import RefScorer

    if args.random_init:
        cfg, model, tok = tiny_random_ref(args.device)
    else:
        cfg, model, tok = load_ref(args.ref_checkpoint, args.device)
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok,
                       dtype="bfloat16" if args.bf16 else "float32",
                       device=args.device,
                       quantize_decode="int4" if args.int4_decode
                       else args.int8_decode,
                       quant_prefill=args.int8_prefill)
    pad = getattr(tok, "pad_token_id", None)
    return scorer, dict(
        eos_token_id=tok.convert_tokens_to_ids("<|im_end|>"),
        pad_token_id=151643 if pad is None else pad)


def _run_generate(args, img):
    scorer, ids = _gen_scorer(args)
    text = scorer.generate_text(
        img, args.generate, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, speculative=args.speculative, **ids)
    print(text)
    return {"text": text}


def _run_generate_video(args):
    """Video chat: fetch_video frames as one contiguous video span
    through the grounding trunk (RefScorer.generate_video_text)."""
    scorer, ids = _gen_scorer(args)
    text = scorer.generate_video_text(
        args.video, args.generate, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, fps=args.fps, nframes=args.nframes,
        **ids)
    print(text)
    return {"text": text}


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from wedetect_tpu_torch.data.loader import load_image_rgb
    from wedetect_tpu_torch.models.api import Detector
    from wedetect_tpu_torch.models.ref_api import RefScorer

    if args.video:
        if not args.generate:
            raise SystemExit("--video requires --generate (video chat); "
                             "grounding is image-only")
        return _run_generate_video(args)
    if not args.image:
        raise SystemExit("supply --image (or --video with --generate)")
    img = load_image_rgb(args.image)
    if args.generate:
        return _run_generate(args, img)
    if not args.query:
        raise SystemExit("--query is required for proposal scoring")

    # stage 1: Uni proposals
    if args.random_init or not args.wedetect_uni_checkpoint:
        uni = Detector.from_random("uni_base", device=args.device)
    else:
        uni = Detector.from_torch_checkpoint(
            args.wedetect_uni_checkpoint, "base", uni=True,
            device=args.device)
    props = uni([img], score_thr=0.0)[0]
    boxes = props["bboxes"][:args.num_proposals]
    print(f"{len(boxes)} proposals from WeDetect-Uni")

    # stage 2: Ref scoring
    if args.random_init:
        raise SystemExit(
            "random-init Ref requires the full Qwen3-VL config; supply "
            "--ref_checkpoint (HF dir with config.json + weights)")
    from wedetect_tpu_torch.cli._ref_load import load_ref

    cfg, model, tok = load_ref(args.ref_checkpoint, args.device)
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok,
                       dtype="bfloat16" if args.bf16 else "float32",
                       device=args.device, quant_prefill=args.int8_prefill)
    pad = getattr(tok, "pad_token_id", None)
    scores = scorer.score(img, boxes, [args.query],
                          pad_token_id=151643 if pad is None else pad)[0]
    keep = (np.argsort(-scores)[:1] if args.score_thre < 0
            else np.nonzero(scores > args.score_thre)[0])
    for i in keep:
        b = boxes[i]
        print(f"score {scores[i]:.3f} box "
              f"[{b[0]:.0f},{b[1]:.0f},{b[2]:.0f},{b[3]:.0f}]")
    if args.visualize:
        from wedetect_tpu_torch.utils.vis import draw_detections

        out = draw_detections(img, boxes[keep], scores[keep],
                              np.zeros(len(keep), np.int64),
                              class_names=[args.query])
        out.save(args.output)
        print(f"saved {args.output}")
    return {"boxes": boxes[keep], "scores": scores[keep]}


if __name__ == "__main__":
    main()
