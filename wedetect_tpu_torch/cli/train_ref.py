"""WeDetect-Ref SFT launcher: stages 1-3 with checkpointing and resume.

Port of `wedetect_tpu/cli/train_ref.py` (the reference's
wedetect_ref/scripts/run_stage{1,2,3}.sh + sft.py / sft_referring.py):
one step per sample sequence on one card, checkpoints carrying the
model, the optimizer state and the step, and `--resume` restoring the
latest one (reference get_last_checkpoint / resume_from_checkpoint,
sft_referring.py:439-443).

Stage schedule (reference run_stage*.sh):
  1: projectors only, lr 1e-3, chat-caption data (LM loss)
  2: LLM unfrozen, lr 1e-5, chat/region data (LM loss)
  3: vision frozen, lr 1e-5, proposals + soft IoU labels (focal loss),
     3-tier LRs (out_proj x10)

Usage:
    python -m wedetect_tpu_torch.cli.train_ref --stage 3 \\
        --ref_checkpoint <hf-dir> --data stage3.json \\
        --proposals props.json --steps 10000 --ckpt-dir runs/ref3 \\
        --resume

Runs on the card (`--device cuda`, the default) through the flash
attention kernels and their backward kernels. Not ported yet: video
samples, multi-card FSDP (`--fsdp` > 1).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WeDetect-Ref SFT")
    p.add_argument("--stage", type=int, required=True, choices=[1, 2, 3])
    p.add_argument("--ref_checkpoint", default="",
                   help="HF checkpoint dir to initialize from")
    p.add_argument("--data", required=True,
                   help="chat json (stages 1-2) or stage-3 json")
    p.add_argument("--proposals", default="",
                   help="per-image proposal json (stage 3)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.0,
                   help="0 = the stage default (1e-3 / 1e-5 / 1e-5)")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--multiscale", action="store_true")
    p.add_argument("--max-proposals", type=int, default=100)
    p.add_argument("--grid-tokens", type=int, default=1024,
                   help="grid bucket token budget")
    p.add_argument("--seq-buckets", type=int, nargs="+",
                   default=[1024, 2048, 4096])
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--fsdp", type=int, default=-1,
                   help="cards to shard over (one card only: -1 or 1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def build_step_inputs(cfg, sample, stage: int, seq_buckets,
                      max_proposals: int, pad_token_id: int):
    """Pad one dataset sample to the step's static shapes (image
    samples; a video sample raises NotImplementedError)."""
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_image
    from wedetect_tpu_torch.train.ref_lm import IGNORE_INDEX

    ids = sample["input_ids"]
    gh, gw = sample["grid"]
    grid_t = int(sample.get("grid_t", 1))
    if grid_t > 1 or (np.asarray(ids) == cfg.video_token_id).any():
        raise NotImplementedError("video SFT samples: not ported yet")
    l = pad_to_bucket(len(ids), seq_buckets)
    ids_p = np.full((1, l), pad_token_id, np.int32)
    ids_p[0, :len(ids)] = ids
    mask = np.zeros((1, l), np.int32)
    mask[0, :len(ids)] = 1
    rope = get_rope_index_single_image(ids, cfg.image_token_id, gh, gw,
                                       cfg.vision.merge)
    pos = np.pad(rope, ((0, 0), (0, l - len(ids))))[:, None]  # (3, 1, L)

    n = max_proposals
    boxes = np.tile(np.array([[0, 0, 1, 1]], np.float32), (n, 1))
    obj_pos = np.full((1, n), -1, np.int32)
    valid = np.zeros((1, n), np.float32)
    soft = np.zeros((1, n), np.float32)
    sb = sample.get("boxes")
    if sb is not None and len(sb):
        k = min(len(sb), n)
        boxes[:k] = sb[:k]
        op = sample.get("object_positions", np.zeros(0, np.int32))[:k]
        obj_pos[0, :len(op)] = op
        valid[0, :len(op)] = 1.0
        if "soft_labels" in sample:
            soft[0, :k] = sample["soft_labels"][:k]
    ori_wh = sample.get("ori_wh", np.array([gw * 16.0, gh * 16.0],
                                           np.float32))

    out = {"patches": sample["patches"], "input_ids": ids_p,
           "attn_mask": mask, "position_ids": pos,
           "visual_start": int(sample["visual_start"]),
           "boxes": boxes, "ori_wh": ori_wh,
           "object_positions": obj_pos, "grid": (gh, gw),
           "grid_t": grid_t}
    if stage == 3:
        out["soft_labels"] = soft
        out["valid"] = valid
    else:
        lab = np.full((1, l), IGNORE_INDEX, np.int32)
        lab[0, :len(ids)] = sample["labels"]
        out["labels"] = lab
    return out


def train_ref_loop(cfg, state, dataset, stage: int, steps: int, *,
                   seq_buckets=(1024, 2048, 4096),
                   max_proposals: int = 100, pad_token_id: int = 151643,
                   log_every: int = 20, ckpt_dir: Optional[str] = None,
                   ckpt_every: int = 500, seed: int = 0, log_fn=None):
    """Run single-sequence SFT steps from state.step to `steps`; returns
    the final state (restore with ckpt.io.restore_train_state before
    calling to resume). Losses are read back only when logged."""
    from wedetect_tpu_torch.train.ref_lm import ref_lm_step
    from wedetect_tpu_torch.train.ref_sft import ref_sft_step

    rng = np.random.default_rng(seed + int(state.step))
    t0 = time.time()
    losses = []
    for step in range(int(state.step), steps):
        sample = dataset.sample(int(rng.integers(len(dataset))))
        b = build_step_inputs(cfg, sample, stage, seq_buckets,
                              max_proposals, pad_token_id)
        gh, gw = b["grid"]
        common = (b["patches"], b["input_ids"], b["attn_mask"],
                  b["position_ids"], b["visual_start"], b["boxes"],
                  b["ori_wh"], b["object_positions"])
        if stage == 3:
            state, metrics = ref_sft_step(cfg, gh, gw, state, *common,
                                          b["soft_labels"], b["valid"])
        else:
            state, metrics = ref_lm_step(cfg, gh, gw, state, *common,
                                         b["labels"], b["grid_t"])
        losses.append(metrics["loss"])
        if (step + 1) % log_every == 0:
            msg = {"step": step + 1, "stage": stage,
                   "loss": float(np.mean([float(x) for x in losses])),
                   "steps_per_s": log_every / max(time.time() - t0, 1e-9)}
            (log_fn or (lambda s, m: print(m, flush=True)))(step, msg)
            losses.clear()
            t0 = time.time()
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            from wedetect_tpu_torch.ckpt.io import save_train_state

            save_train_state(f"{ckpt_dir}/step_{step + 1}", state)
    return state


def main(argv=None):
    args = parse_args(argv)
    if args.fsdp > 1:
        raise NotImplementedError("--fsdp > 1 (multi-card FSDP): not "
                                  "ported yet")
    from wedetect_tpu_torch.ckpt.io import (latest_checkpoint,
                                            restore_train_state,
                                            save_train_state)
    from wedetect_tpu_torch.cli._ref_load import load_ref
    from wedetect_tpu_torch.data.sft_chat import (ChatSftDataset,
                                                  ReferringSftDataset)
    from wedetect_tpu_torch.data.vision_process import make_grid_buckets
    from wedetect_tpu_torch.train.optimizer import (make_lr_schedule,
                                                    with_grad_accum)
    from wedetect_tpu_torch.train.ref_lm import stage_optimizer
    from wedetect_tpu_torch.train.ref_sft import ref_optimizer
    from wedetect_tpu_torch.train.train_step import TrainState

    cfg, model, tok = load_ref(args.ref_checkpoint, device=args.device)
    buckets = make_grid_buckets(total_tokens=args.grid_tokens)
    if args.stage == 3:
        dataset = ReferringSftDataset(
            args.data, args.proposals, tok,
            image_token_id=cfg.image_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            object_token_id=cfg.object_token_id,
            max_proposals=args.max_proposals,
            multiscale=args.multiscale, grid_buckets=buckets,
            patch=cfg.vision.patch, merge=cfg.vision.merge, seed=args.seed)
    else:
        dataset = ChatSftDataset(
            args.data, tok, image_token_id=cfg.image_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            object_token_id=cfg.object_token_id,
            video_token_id=cfg.video_token_id,
            patch=cfg.vision.patch, merge=cfg.vision.merge, seed=args.seed)

    lr = args.lr or {1: 1e-3, 2: 1e-5, 3: 1e-5}[args.stage]
    schedule = make_lr_schedule(lr, args.steps,
                                warmup_steps=args.warmup_steps,
                                schedule="cosine")
    if args.stage == 3:
        tx = ref_optimizer(model, base_lr=lr, lr_schedule=schedule)
    else:
        tx = stage_optimizer(model, args.stage, base_lr=lr,
                             lr_schedule=schedule)
    tx = with_grad_accum(tx, args.grad_accum)
    state = TrainState.create(model, tx)
    if args.resume and args.ckpt_dir:
        last = latest_checkpoint(args.ckpt_dir)
        if last is not None:
            state = restore_train_state(last, state)
            print(f"resumed from {last} at step {state.step}", flush=True)

    pad_id = tok.pad_token_id if tok.pad_token_id is not None else 0
    state = train_ref_loop(
        cfg, state, dataset, args.stage, args.steps,
        seq_buckets=tuple(args.seq_buckets),
        max_proposals=args.max_proposals, pad_token_id=pad_id,
        log_every=args.log_every, ckpt_dir=args.ckpt_dir or None,
        ckpt_every=args.ckpt_every, seed=args.seed)
    if args.ckpt_dir:
        save_train_state(f"{args.ckpt_dir}/step_{args.steps}", state)


if __name__ == "__main__":
    main()
