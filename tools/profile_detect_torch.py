#!/usr/bin/env python3
"""Where the port's detect step, its Ref scoring, or its Ref SFT step
spends its time on the card.

    python3 tools/profile_detect_torch.py [--ref | --rec | --train
                                           | --det-train | --gen
                                           | --serve]
                                          [--batch N] [--bf16] [--int8]
                                          [--iters 3] [--tokens N]
                                          [--table F]

Detect (the default): full-width WeDetect-Base (640x640, K = 1203,
random weights and random class embeddings, the head calibrated to a
trained checkpoint's score profile by chip_smoke.calibrate_head), then
Detector.__call__ on --batch images. --ref: WeDetect-Ref at ref_2b's
full width (random weights, seed 0), then RefScorer.score (prefix
sharing) on chip_smoke.py's Ref inputs: its seeded 480x640 image, the
top 100 proposals of a random Uni-Base, its 8 queries and stub
tokenizer. --rec: one fused cross-image REC step
(RefScorer.rec_logits -> models/ref.ref_rec_batch_step) on --batch
images (default 8) of chip_smoke.py's grounding set, all of its 480x640
size (one grid bucket of make_grid_buckets(256)), one query and the top
100 Uni-Base proposals an image, ref_2b. --train: one stage-3 SFT step (train/ref_sft.ref_sft_step,
f32, ref_optimizer) at ref_2b's full width on chip_smoke.py's training
sample with the train_ref CLI defaults (--grid-tokens 1024: ViT
L = 4224; decoder L = 2048; 100 proposals); --bf16 does not apply.
--det-train: one detector train_step as chip_smoke.py's det_train
phase builds it (cli/train's builders: WeDetect-Base, 640x640, K = 80,
bf16, random init and text bank; --batch images, default 16, of its
seeded in-memory samples), the batch built beforehand, so the time is
the step's alone (upload, forward, assigner, losses, backward, AdamW).
--gen: one models/ref_generate call of --tokens new tokens (default 16)
at ref_2b (random weights), chip_smoke.py's image and generation
prompt (P = 384), f32 or --bf16. --serve: one 16-step decode chunk of a
GenServer whose --batch slots (default 8) all decode, same model and
prompt. --int8 (detect and --ref): the int8 serving mode, the
detector's ModelCfg.quant_int8 or RefScorer(quant_prefill=True).
The call runs under torch.profiler; the script prints one
JSON line: wall time per call, device busy time per call (the union of
kernel intervals on the card) and so the device's idle share, the
kernels launched a call, and the ops with the most device time.
--table writes the full profiler table to file F. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3   # us -> ms


def detect_call(args, C, dev):
    from wedetect_tpu_torch.configs import TEXT_BASE
    from wedetect_tpu_torch.models.api import Detector

    kw = dict(compute_dtype="bfloat16") if args.bf16 else {}
    det = Detector.from_random("base", seed=0, device=dev,
                               num_classes=C.N_CLASSES,
                               quant_int8=args.int8, **kw)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((C.N_CLASSES, TEXT_BASE.head_out), generator=g,
                    device=dev)
    det.reparameterize([str(i) for i in range(C.N_CLASSES)], embeds=w)
    h, wd = det.cfg.img_size
    b = args.batch or 8
    images = list(torch.randint(
        0, 256, (b, h, wd, 3), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(2)).numpy())
    C.calibrate_head(det, np.stack(images), det._text_embeds,
                     det.cfg.test.score_thr)
    return lambda: det(images), {"batch": b}


def ref_call(args, C, dev):
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    image, boxes = C.ref_inputs(dev)
    cfg = ref_2b()
    scorer = RefScorer(cfg=cfg, model=init_ref_variables(cfg, 0, dev),
                       tokenizer=C.CharTok(),
                       dtype="bfloat16" if args.bf16 else "float32",
                       device=dev, quant_prefill=args.int8)
    return (lambda: scorer.score(image, boxes, C.REF_QUERIES),
            {"proposals": len(boxes), "queries": len(C.REF_QUERIES)})


def rec_call(args, C, dev):
    import tempfile
    from pathlib import Path

    from wedetect_tpu_torch.data.loader import load_image_rgb
    from wedetect_tpu_torch.data.vision_process import make_grid_buckets
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    b = args.batch or C.GROUND_QUERY_BATCH
    size = C.GROUND_SIZES[0]
    with tempfile.TemporaryDirectory() as root:
        _, _, names = C.write_grounding_dataset(Path(root), b, (size, size),
                                                C.EVAL_COCO_CLASSES)
        images = [load_image_rgb(os.path.join(root, n)) for n in names]
    props = C.uni_proposals(dev, images)
    samples = [(im, p, C.REF_QUERIES[i % len(C.REF_QUERIES)])
               for i, (im, p) in enumerate(zip(images, props))]
    cfg = ref_2b()
    buckets = tuple(make_grid_buckets(C.GROUND_GRID_TOKENS,
                                      cfg.vision.patch * cfg.vision.merge))
    scorer = RefScorer(cfg=cfg, model=init_ref_variables(cfg, 0, dev),
                       tokenizer=C.CharTok(), grid_buckets=buckets,
                       query_batch=b,
                       dtype="bfloat16" if args.bf16 else "float32",
                       device=dev)
    return (lambda: scorer.rec_logits(samples),
            {"images": b, "grid_tokens": C.GROUND_GRID_TOKENS})


def train_call(args, C, dev):
    from wedetect_tpu_torch.cli.train_ref import build_step_inputs
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b
    from wedetect_tpu_torch.train.ref_sft import ref_optimizer, ref_sft_step
    from wedetect_tpu_torch.train.train_step import TrainState

    image, boxes = C.ref_inputs(dev)
    cfg = ref_2b()
    b = build_step_inputs(cfg, C.ref_sft_dataset(cfg, image, boxes,
                                                 1024).sample(0),
                          3, (1024, 2048, 4096), 100, 151643)
    model = init_ref_variables(cfg, 0, dev)
    state = TrainState.create(model, ref_optimizer(model,
                                                   base_lr=C.TRAIN_LR))
    gh, gw = b["grid"]
    args_ = (b["patches"], b["input_ids"], b["attn_mask"],
             b["position_ids"], b["visual_start"], b["boxes"], b["ori_wh"],
             b["object_positions"], b["soft_labels"], b["valid"])
    return (lambda: ref_sft_step(cfg, gh, gw, state, *args_),
            {"vit_tokens": gh * gw, "seq_len": int(b["input_ids"].shape[1])})


def det_train_call(args, C, dev):
    from wedetect_tpu_torch.cli import train as CLI
    from wedetect_tpu_torch.train.loop import (TrainLoopCfg,
                                               make_batch_iterator)
    from wedetect_tpu_torch.train.train_step import train_step

    b = args.batch or 16
    cli = CLI.parse_args(["--size", "base", "--batch-size", str(b),
                          "--device", str(dev)])
    cfg = CLI.build_config(cli)
    state, text_encode = CLI.build_state(cli, cfg)
    sample_fn = CLI.make_sample_fn(
        cli, cfg, lambda rng: C.det_raw_sample(rng, cfg.img_size[0]),
        [[f"class {i}"] for i in range(cli.num_classes)])
    batch = next(make_batch_iterator(cfg, TrainLoopCfg(batch_size=b),
                                     sample_fn, text_encode))
    return (lambda: train_step(cfg, state, batch),
            {"batch": b, "num_classes": cfg.num_classes})


def _gen_setup(args, C, dev):
    """ref_2b (random weights, seed 0) in the run's dtype, chip_smoke's
    seeded 480x640 image and its generation prompt."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = ref_2b()
    model = init_ref_variables(cfg, seed=0, device=dev)
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=C.CharTok(),
                       dtype="bfloat16" if args.bf16 else "float32",
                       device=dev)
    g = torch.Generator().manual_seed(3)
    image = torch.randint(0, 256, (480, 640, 3), generator=g,
                          dtype=torch.uint8).numpy()
    return cfg, model, C.gen_prompt(scorer, image, C.GEN_PROMPT, p_pad=384)


def gen_call(args, C, dev):
    cfg, model, b = _gen_setup(args, C, dev)
    n = args.tokens
    return (lambda: C.gen_call(cfg, model, b, n)), {"new_tokens": n}


def serve_call(args, C, dev):
    """One decode chunk of a GenServer whose slots all decode (slots
    --batch, default 8; chunk 16; P = 384)."""
    from wedetect_tpu_torch.models.serve import GenServer

    cfg, model, b = _gen_setup(args, C, dev)
    slots = args.batch or 8
    srv = GenServer(cfg, b["gh"], b["gw"], model, slots=slots,
                    prompt_len=384, max_new=16 * (args.iters + 2),
                    chunk=16, eos_id=C.GEN_EOS, pad_id=C.GEN_PAD)
    for _ in range(slots):
        srv.submit(b["patches"], b["ids"], b["mask"], b["pos"], b["vs"],
                   b["nxt"], boxes_xyxy=b["boxes"], ori_wh=b["ori"])
    srv._admit_queued()
    return (lambda: srv._collect(*srv._dispatch_chunk())), {
        "slots": slots, "chunk": 16}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref", action="store_true",
                   help="profile RefScorer.score instead of the detector")
    p.add_argument("--rec", action="store_true",
                   help="profile one fused cross-image REC step")
    p.add_argument("--train", action="store_true",
                   help="profile one Ref stage-3 SFT step")
    p.add_argument("--det-train", action="store_true",
                   help="profile one detector train step (bf16)")
    p.add_argument("--gen", action="store_true",
                   help="profile one ref_generate call (ref_2b)")
    p.add_argument("--serve", action="store_true",
                   help="profile one GenServer decode chunk (ref_2b)")
    p.add_argument("--tokens", type=int, default=16,
                   help="--gen: new tokens a call")
    p.add_argument("--batch", type=int, default=0,
                   help="images a call (default 8; --det-train 16)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="detect, --ref: the int8 serving mode")
    p.add_argument("--table", default="",
                   help="write the full profiler table to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_detect_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    make = (det_train_call if args.det_train else train_call if args.train
            else ref_call if args.ref else rec_call if args.rec
            else gen_call if args.gen
            else serve_call if args.serve else detect_call)
    call, info = make(args, C, dev)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.iters
    busy = busy_ms(prof.events()) / args.iters
    if args.table:
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=50))
    dtype = ("bf16" if args.det_train or args.bf16 and not args.train
             else "f32")
    name = ("det_train_" if args.det_train else "train_" if args.train
            else "ref_" if args.ref else "rec_" if args.rec
            else "gen_" if args.gen
            else "serve_" if args.serve else "") + dtype \
        + ("_int8" if args.int8 else "")
    top = sorted(prof.key_averages(),
                 key=lambda e: e.self_device_time_total, reverse=True)[:14]
    print(json.dumps({
        "profile": name,
        **info, "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1 - busy / wall) if wall else None,
        "kernels": sum(e.device_type == torch.autograd.DeviceType.CUDA
                       for e in prof.events()) / args.iters,
        "top": [{"op": e.key[:70], "device_ms":
                 e.self_device_time_total / 1e3 / args.iters,
                 "calls": e.count // args.iters} for e in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
