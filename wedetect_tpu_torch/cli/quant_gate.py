"""int4 / int8 decode-quantization quality gate CLI.

Port of `wedetect_tpu/cli/quant_gate.py`. Measures whether weight-only
quantized decode (`models/quant`) is safe to enable for a checkpoint:
first-step logit cosine, greedy-token agreement and REC grounding score
deltas against full precision (`eval/quant_gate`), and with
--calibrate the activation-calibrated int4 fit (`models/quant_calib`)
beside the plain one.

    # a checkpoint (the deployment gate):
    python -m wedetect_tpu_torch.cli.quant_gate --ref_checkpoint <hf-dir> \
        [--image img.jpg] [--bits 4] [--calibrate 8] [--max_new 32]
    # random weights (the mechanics only; gate a real checkpoint before
    # serving it):
    python -m wedetect_tpu_torch.cli.quant_gate --random [--bits 4] ...

Prints one JSON line: the plain (and with --calibrate the calibrated)
gate report. Runs on the card unless given --device cpu. --random is
the JAX CLI's tiny config (heads of 16, which the card's grouped-KV
kernel does not take), so its prefill runs the einsum attention on
either device; a checkpoint runs K2 and K3 on the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="decode-quantization quality gate (PyTorch)")
    p.add_argument("--ref_checkpoint", default="",
                   help="HF checkpoint dir (config + safetensors)")
    p.add_argument("--random", action="store_true",
                   help="tiny random-init model (the mechanics only)")
    p.add_argument("--image", action="append", default=[],
                   help="probe image(s); synthetic if omitted")
    p.add_argument("--bits", type=int, default=4, choices=(4, 8))
    p.add_argument("--calibrate", type=int, default=0, metavar="N",
                   help="also report the int4 fit calibrated on N "
                        "held-out prompts (models/quant_calib)")
    p.add_argument("--n_prompts", type=int, default=8)
    p.add_argument("--max_new", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json_out", default="",
                   help="also write the report JSON here")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def tiny_cfg():
    """The JAX CLI's tiny random Ref config."""
    from wedetect_tpu_torch.nn.qwen3vl import (RefCfg, RefTextCfg,
                                               RefVisionCfg)

    return RefCfg(
        vision=RefVisionCfg(depth=2, hidden=32, heads=4, intermediate=64,
                            patch=4, temporal_patch=2, merge=2,
                            out_hidden=48, num_pos_emb=64,
                            deepstack_idx=(0, 1)),
        text=RefTextCfg(vocab_size=96, hidden=48, layers=2, heads=4,
                        kv_heads=2, head_dim=16, intermediate=96,
                        rope_theta=1000.0, mrope_section=(4, 2, 2)),
        image_token_id=90, vision_start_token_id=91, object_token_id=92)


def random_batches(seed, n_prompts, n_calib):
    """Synthetic prompt, REC and calibration batches over one 8x8-patch
    image, the JAX CLI's layout (its seeded draws, in its order):
    (gh, gw, gen_batch, rec_batch, calib_batches)."""
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_image

    gh = gw = 8
    n_img = (gh // 2) * (gw // 2)
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal(
        (gh * gw, 3 * 2 * 4 * 4)).astype(np.float32)

    def prompt_batch(b, base_tail=4):
        rows = []
        for i in range(b):
            tail = rng.integers(2, 80, base_tail + int(i % 3))
            rows.append(np.concatenate([np.array([1, 91]),
                                        np.full(n_img, 90),
                                        tail]).astype(np.int32))
        p = max(len(r) for r in rows)
        ids = np.zeros((b, p), np.int32)
        mask = np.zeros((b, p), np.int32)
        pos = np.zeros((3, b, p), np.int32)
        next_pos = np.zeros(b, np.int32)
        for r, row in enumerate(rows):
            ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
            pr = get_rope_index_single_image(row, 90, gh, gw, 2)
            pos[:, r, :len(row)] = pr
            next_pos[r] = pr.max() + 1
        return ids, mask, pos, next_pos

    boxes = np.array([[0, 0, 64, 64]], np.float32)
    ori = np.array([64.0, 64.0], np.float32)
    ids, mask, pos, next_pos = prompt_batch(n_prompts)
    gen_batch = (patches, ids, mask, pos, 2, next_pos, boxes, ori)

    # REC probe: <object> slots and random proposals
    n_obj = 6
    rec_rows = [np.concatenate([np.array([1, 91]), np.full(n_img, 90),
                                rng.integers(2, 80, 5),
                                np.full(n_obj, 92)]).astype(np.int32)
                for _ in range(4)]
    lr = max(len(r) for r in rec_rows)
    rids = np.zeros((4, lr), np.int32)
    rmask = np.zeros((4, lr), np.int32)
    rpos = np.zeros((3, 4, lr), np.int32)
    robj = np.zeros((4, n_obj), np.int32)
    for r, row in enumerate(rec_rows):
        rids[r, :len(row)] = row
        rmask[r, :len(row)] = 1
        rpos[:, r, :len(row)] = get_rope_index_single_image(
            row, 90, gh, gw, 2)
        robj[r] = np.nonzero(row == 92)[0][:n_obj]
    xy = rng.uniform(0, 48, (n_obj, 2))
    wh = rng.uniform(8, 16, (n_obj, 2))
    rboxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    rec_batch = (patches, rids, rmask, rpos, 2, rboxes, ori, robj)

    calib_batches = []
    if n_calib:
        cids, cmask, cpos, _ = prompt_batch(n_calib, base_tail=6)
        calib_batches.append(dict(
            grid_h=gh, grid_w=gw, patches=patches, input_ids=cids,
            attn_mask=cmask, position_ids=cpos, visual_start=2,
            boxes_xyxy=boxes, ori_wh=ori))
    return gh, gw, gen_batch, rec_batch, calib_batches


_PROBE_PROMPTS = [
    "Describe this image in detail.",
    "What is the main object in the picture?",
    "List the colors you can see.",
    "Where is the largest object located?",
    "Is there any text in the image?",
    "Count the objects in the image.",
    "What is happening in this scene?",
    "Describe the background of the image.",
]

_CALIB_PROMPTS = [
    "Summarize the contents of this image.",
    "What material are the objects made of?",
    "Describe the lighting in the photo.",
    "Are there any people visible?",
    "What season does this image depict?",
    "Name the most prominent shape.",
    "Estimate how many distinct items appear.",
    "Describe the texture of the surfaces.",
]


def _cycle(prompts, n):
    return (prompts * ((n + len(prompts) - 1) // len(prompts)))[:n]


def calib_requests(image, n):
    """(image, prompt) calibration requests: n of the built-in prompts."""
    return [(image, p) for p in _cycle(_CALIB_PROMPTS, n)]


def scorer_batches(scorer, image, n_prompts, n_calib, pad_id):
    """A scorer's gate batches on one image: the built-in probe prompts
    through its chat template (each padded to a multiple of 128), a grid
    of nine proposals under four queries for the REC probe, and n_calib
    calibration prompts. Returns (gh, gw, gen_batch, rec_batch,
    calib_batches)."""
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_image

    cfg = scorer.cfg
    built = [scorer._build_gen_prompt(image, p, pad_id)
             for p in _cycle(_PROBE_PROMPTS, n_prompts)]
    patches, gh, gw = built[0][0], built[0][1], built[0][2]
    p_pad = max(len(b[3]) for b in built)
    b_n = len(built)
    ids = np.full((b_n, p_pad), pad_id, np.int32)
    mask = np.zeros((b_n, p_pad), np.int32)
    pos = np.zeros((3, b_n, p_pad), np.int32)
    next_pos = np.zeros(b_n, np.int32)
    visual_start = built[0][6]
    w, h = built[0][7], built[0][8]
    for r, bt in enumerate(built):
        bi, bm, bp = bt[3], bt[4], bt[5]
        ids[r, :len(bi)] = bi
        mask[r, :len(bm)] = bm
        pos[:, r, :bp.shape[1]] = bp
        next_pos[r] = bp[:, bm.astype(bool)].max() + 1
    boxes = np.array([[0, 0, w, h]], np.float32)
    ori = np.array([w, h], np.float32)
    gen_batch = (patches, ids, mask, pos, visual_start, next_pos, boxes,
                 ori)

    # REC probe: a grid of proposals and real query sequences
    n_obj = 9
    m = cfg.vision.merge
    n_img = (gh // m) * (gw // m)
    seqs = [scorer.build_sequence(q, n_img, n_obj)
            for q in ("object", "person", "red thing", "background")]
    lr = -(-max(len(s) for s in seqs) // 128) * 128
    rids = np.full((len(seqs), lr), pad_id, np.int32)
    rmask = np.zeros((len(seqs), lr), np.int32)
    rpos = np.zeros((3, len(seqs), lr), np.int32)
    robj = np.zeros((len(seqs), n_obj), np.int32)
    for r, s in enumerate(seqs):
        rids[r, :len(s)] = s
        rmask[r, :len(s)] = 1
        rpos[:, r, :len(s)] = get_rope_index_single_image(
            s, cfg.image_token_id, gh, gw, m)
        robj[r] = np.nonzero(s == cfg.object_token_id)[0][:n_obj]
    g = np.linspace(0, min(w, h) * 2 / 3, 3)
    xy = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    rboxes = np.concatenate(
        [xy, xy + min(w, h) / 3], axis=1).astype(np.float32)[:n_obj]
    rec_batch = (patches, rids, rmask, rpos, visual_start, rboxes, ori,
                 robj)

    calib_batches = []
    for p in _cycle(_CALIB_PROMPTS, n_calib):
        cp, cgh, cgw, ci, cm, cpos, cvs, cw, ch = \
            scorer._build_gen_prompt(image, p, pad_id)
        calib_batches.append(dict(
            grid_h=cgh, grid_w=cgw, patches=cp, input_ids=ci[None],
            attn_mask=cm[None], position_ids=cpos[:, None],
            visual_start=cvs,
            boxes_xyxy=np.array([[0, 0, cw, ch]], np.float32),
            ori_wh=np.array([cw, ch], np.float32)))
    return gh, gw, gen_batch, rec_batch, calib_batches


def _ckpt_setup(args):
    from wedetect_tpu_torch.cli._ref_load import load_ref
    from wedetect_tpu_torch.data.loader import load_image_rgb
    from wedetect_tpu_torch.models.ref_api import RefScorer

    cfg, model, tok = load_ref(args.ref_checkpoint, args.device)
    rng = np.random.default_rng(args.seed)
    if args.image:
        image = load_image_rgb(args.image[0])
    else:
        image = rng.integers(0, 256, (448, 448, 3), np.uint8)
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok,
                       device=args.device)
    pad_id, eos_id = 151643, 151645
    return (cfg, scorer.model) + scorer_batches(
        scorer, image, args.n_prompts, args.calibrate, pad_id) \
        + (eos_id, pad_id)


def _random_setup(args):
    from wedetect_tpu_torch.models.ref import init_ref_variables

    cfg = tiny_cfg()
    model = init_ref_variables(cfg, seed=args.seed, device=args.device)
    model.attn_impl = "einsum"
    return (cfg, model) + random_batches(args.seed, args.n_prompts,
                                         args.calibrate) + (95, 0)


def main(argv=None):
    args = parse_args(argv)
    if not args.random and not args.ref_checkpoint:
        raise SystemExit("supply --ref_checkpoint or --random")
    if args.calibrate and args.bits != 4:
        raise SystemExit("--calibrate applies to --bits 4 only")

    from wedetect_tpu_torch.eval.quant_gate import gate_report
    from wedetect_tpu_torch.models.quant import quantize_decode_params
    from wedetect_tpu_torch.models.quant_calib import calibrate_decode_acts

    setup = _random_setup(args) if args.random else _ckpt_setup(args)
    (cfg, model, gh, gw, gen_batch, rec_batch, calib_batches, eos_id,
     pad_id) = setup
    report = {"bits": args.bits,
              "mode": "random" if args.random else "checkpoint",
              "note": ("random weights: mechanics envelope only — "
                       "gate real checkpoints before deployment"
                       if args.random else None)}
    q = quantize_decode_params(model, bits=args.bits)
    report["plain"] = gate_report(cfg, gh, gw, model, q, gen_batch,
                                  rec_batch, args.max_new, eos_id, pad_id)
    if args.calibrate:
        calib = calibrate_decode_acts(cfg, model, calib_batches)
        qc = quantize_decode_params(model, bits=4, calib=calib)
        report["calibrated"] = gate_report(
            cfg, gh, gw, model, qc, gen_batch, rec_batch, args.max_new,
            eos_id, pad_id)
        report["calib_prompts"] = args.calibrate
    line = json.dumps(report)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
