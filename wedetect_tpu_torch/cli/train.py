"""Detector training CLI.

Port of `wedetect_tpu/cli/train.py`: trains WeDetect / WeDetect-Uni on
COCO-format annotations or webdataset tar shards with the loop of
`train/loop.py`, computing in bf16, on one card or several.

    python -m wedetect_tpu_torch.cli.train \\
        --ann train.json --img-root imgs --size tiny \\
        --steps 5000 --batch-size 16 --ckpt-dir runs/tiny

Several cards: `torchrun --nproc_per_node N -m
wedetect_tpu_torch.cli.train ...` (the process group is joined by
`eval/dist.maybe_initialize`). The ranks form `make_mesh(data=-1,
fsdp=--fsdp)` as the JAX CLI does: the batch of `--batch-size` (global,
divisible by the data axis) is split over "data", BatchNorm and the
loss normalisers see the global batch, and the optimizer state is
sharded over "fsdp" with the parameters and their gradients (ZeRO-3:
`parallel/fsdp.py`, `train/optimizer.py`; with --fsdp above 1 the model
is built on the host and only a rank's slices move to its card; a
random init then draws on the host). Webdataset shards are split
over the data ranks (the JAX CLI splits them over processes; ranks that
differ only on "fsdp" must take the same rows).

Class texts are encoded by the text tower of `--init-checkpoint`, else
by a random bank: one unit vector per prompt list, seeded by a stable
hash of the list (crc32), so a run and its resume see the same bank.
`--device` defaults to `cuda` and raises without a card; `--device cpu`
runs the plain PyTorch path (gloo between the ranks).

`parse_args`, `build_config`, `build_state` and `make_sample_fn` are what
`main` runs; chip_smoke.py builds its training run from them.
"""

from __future__ import annotations

import argparse
import zlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WeDetect training")
    p.add_argument("--size", default="tiny")
    p.add_argument("--ann", default="")
    p.add_argument("--img-root", default="")
    p.add_argument("--wds-shards", default="",
                   help="tar shard glob (alternative to --ann)")
    p.add_argument("--class-texts", default="")
    p.add_argument("--tokenizer", default="xlm-roberta-base")
    p.add_argument("--init-checkpoint", default="",
                   help="torch ckpt to start from")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine", "linear"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per optimizer update")
    p.add_argument("--drop-path", type=float, default=0.0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest step_* under "
                        "--ckpt-dir (model, optimizer state, step)")
    p.add_argument("--weight-decay", type=float, default=0.025)
    p.add_argument("--mosaic-prob", type=float, default=0.0)
    p.add_argument("--mixup-prob", type=float, default=0.0)
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--img-size", type=int, default=0,
                   help="override the config input size (e.g. 320)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--fsdp", type=int, default=1,
                   help="ranks the parameters, gradients and optimizer "
                        "state are sharded over; the data axis takes the "
                        "rest of the world")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _cfg_kw(args) -> Dict:
    extra = ({"img_size": (args.img_size, args.img_size)}
             if args.img_size else {})
    return dict(compute_dtype="bfloat16", num_classes=args.num_classes,
                drop_path_rate=args.drop_path, **extra)


def build_config(args):
    """The run's ModelCfg: `--size` in bf16 with the CLI's class count,
    drop path rate and input size."""
    from wedetect_tpu_torch.configs import get_config

    return get_config(args.size, **_cfg_kw(args))


def random_text_bank(dims: int) -> Callable[[Sequence[str]], np.ndarray]:
    """texts -> (len(texts), dims) unit vectors, seeded by crc32 of the
    list, cached."""
    cache: Dict[Tuple[str, ...], np.ndarray] = {}

    def encode(texts):
        key = tuple(texts)
        if key not in cache:
            seed = zlib.crc32("\x1f".join(key).encode())
            e = np.random.default_rng(seed).standard_normal(
                (len(key), dims)).astype(np.float32)
            cache[key] = e / np.linalg.norm(e, axis=-1, keepdims=True)
        return cache[key]

    return encode


def build_state(args, cfg, mesh=None):
    """(TrainState, text encoder) of the run: the model (from
    `--init-checkpoint` with its text tower, else random from `--seed`
    with the random text bank) on `--device`, the optimizer (AdamW with
    the reference's decay rules, batch-scaled weight decay, the lr
    schedule, gradient accumulation), over `mesh` (rank 0's model
    broadcast to every rank; with an fsdp axis above 1 built and
    broadcast on the host, then sharded onto `--device`), restored from
    the latest checkpoint under `--ckpt-dir` with `--resume`."""
    from wedetect_tpu_torch.ckpt.io import (latest_checkpoint,
                                            restore_train_state)
    from wedetect_tpu_torch.models.wedetect import init_variables
    from wedetect_tpu_torch.train.optimizer import (make_lr_schedule,
                                                    with_grad_accum)
    from wedetect_tpu_torch.train.train_step import TrainState, det_optimizer

    sharded = mesh is not None and mesh.shape["fsdp"] > 1
    where = "cpu" if sharded else args.device
    if args.init_checkpoint:
        from wedetect_tpu_torch.data.tokenizer import TextTokenizer
        from wedetect_tpu_torch.models.api import Detector

        det = Detector.from_torch_checkpoint(
            args.init_checkpoint, args.size, tokenizer_path=args.tokenizer,
            device=where, **_cfg_kw(args))
        if det.text_tower is not None:
            det.text_tower.to(args.device)
        model = det.model
        tok = []            # the tokenizer, loaded at the first batch

        def text_encode(texts):
            if not tok:
                tok.append(TextTokenizer(args.tokenizer))
            return det.encode_texts(*tok[0](texts)).float().cpu().numpy()
    else:
        model = init_variables(cfg, seed=args.seed, device=where)
        text_encode = random_text_bank(cfg.embed_dims)

    schedule = make_lr_schedule(args.lr, args.steps,
                                warmup_steps=args.warmup_steps,
                                schedule=args.lr_schedule)
    tx = with_grad_accum(
        det_optimizer(model, base_lr=args.lr,
                      weight_decay=args.weight_decay,
                      total_batch_size=args.batch_size,
                      lr_schedule=schedule), args.grad_accum)
    if mesh is not None:
        from wedetect_tpu_torch.parallel.mesh import replicate_tree

        replicate_tree(mesh, model.state_dict())
    state = TrainState.create(model, tx, mesh,
                              device=args.device if sharded else None)
    if args.resume and args.ckpt_dir:
        last = latest_checkpoint(args.ckpt_dir)
        if last is not None:
            state = restore_train_state(last, state)
            if mesh is None or mesh.rank == 0:
                print(f"resumed from {last} at step {state.step}",
                      flush=True)
    return state, text_encode


def make_sample_fn(args, cfg, raw_sample: Callable[[np.random.Generator],
                                                   Dict],
                   class_texts: Optional[Sequence[Sequence[str]]]):
    """raw samples (image HWC u8 RGB, gt boxes xyxy, labels) -> the
    loop's samples: random class-text sampling when `class_texts` is
    given (RandomLoadText), letterboxed to cfg.img_size, boxes mapped
    into the letterboxed image."""
    from wedetect_tpu_torch.data.augment import random_load_text
    from wedetect_tpu_torch.ops.letterbox import preprocess_image

    def sample_fn(rng):
        s = raw_sample(rng)
        if class_texts is not None:
            s = random_load_text(s, class_texts, rng,
                                 max_num_samples=args.num_classes)
        img, sf, pad, _ = preprocess_image(s["image"], cfg.img_size)
        boxes = np.asarray(s["gt_bboxes"], np.float32).reshape(-1, 4)
        boxes = boxes * np.array([sf[0], sf[1], sf[0], sf[1]])
        boxes[:, 0::2] += pad[2]
        boxes[:, 1::2] += pad[0]
        texts = s.get("texts") or [str(i) for i in
                                   range(args.num_classes)]
        return {"image": img, "gt_bboxes": boxes,
                "gt_labels": s["gt_labels"],
                "texts": texts[:args.num_classes]}

    return sample_fn


def make_run_mesh(args):
    """The run's mesh over the joined world: `make_mesh(data=-1,
    fsdp=--fsdp)`; raises where --fsdp does not divide the world or the
    data axis does not divide --batch-size."""
    from wedetect_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=-1, fsdp=args.fsdp)
    if args.batch_size % mesh.shape["data"]:
        raise ValueError(f"--batch-size {args.batch_size} (the global "
                         f"batch) does not divide over the data axis of "
                         f"{mesh.shape['data']} ranks")
    return mesh


def main(argv=None):
    args = parse_args(argv)
    from wedetect_tpu_torch import resolve_device
    from wedetect_tpu_torch.data.coco import (CocoDetDataset,
                                              load_class_texts)
    from wedetect_tpu_torch.data.loader import load_image_rgb
    from wedetect_tpu_torch.eval.dist import maybe_initialize
    from wedetect_tpu_torch.train.loop import (TrainLoopCfg,
                                               make_batch_iterator,
                                               run_training)

    maybe_initialize(args.device)
    mesh = make_run_mesh(args)
    resolve_device(args.device)
    cfg = build_config(args)
    class_texts = (load_class_texts(args.class_texts)
                   if args.class_texts else None)
    if args.wds_shards:
        from wedetect_tpu_torch.data.wds import WdsDetDataset

        # each data rank reads its own shards (the ranks of one data
        # index, which differ on "fsdp", take the same rows)
        wds = WdsDetDataset(args.wds_shards, rank=mesh.data_index,
                            world_size=mesh.shape["data"])

        def raw_sample(rng):
            return wds.next_sample()
    else:
        ds = CocoDetDataset(args.ann, args.img_root, test_mode=False)
        if class_texts is None:
            class_texts = [[n] for n in ds.class_names]

        def raw_sample(rng):
            idx = int(rng.integers(len(ds)))
            g = ds.gt_arrays(idx)
            keep = ~g["iscrowd"]
            return {"image": load_image_rgb(ds.items[idx]["path"]),
                    "gt_bboxes": g["boxes"][keep],
                    "gt_labels": g["labels"][keep]}

    state, text_encode = build_state(args, cfg, mesh)
    loop_cfg = TrainLoopCfg(
        steps=args.steps, batch_size=args.batch_size,
        ckpt_dir=args.ckpt_dir or None,
        ckpt_every=args.ckpt_every, mosaic_prob=args.mosaic_prob,
        mixup_prob=args.mixup_prob)
    batches = make_batch_iterator(
        cfg, loop_cfg, make_sample_fn(args, cfg, raw_sample, class_texts),
        text_encode, seed=args.seed, start_batch=state.step, mesh=mesh)
    return run_training(cfg, state, batches, loop_cfg)


if __name__ == "__main__":
    main()
