"""Detector training loop: data pipeline -> train step -> checkpoints.

Port of `wedetect_tpu/train/loop.py`: host threads build each batch's
samples (augmentation, letterbox, per-row text banks) while the card
runs the previous step, since a step's kernels are queued and the loss
stays a device tensor until a log step reads it; a checkpoint every
`ckpt_every` steps (`ckpt/io.py`).

Over a mesh (`parallel/mesh.py`), `loop_cfg.batch_size` is the global
batch: `make_batch_iterator(mesh=)` builds only this rank's rows of it,
from the seeds the one-process loop draws for those rows, so host work
does not grow with the world; `run_training` trains over the state's
mesh (`TrainState.mesh`), logs from rank 0 and writes checkpoints
through `ckpt/io.save_train_state`, which every rank calls.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from wedetect_tpu_torch.configs import ModelCfg
from wedetect_tpu_torch.parallel.mesh import Mesh
from wedetect_tpu_torch.train.train_step import Batch, TrainState, train_step


@dataclasses.dataclass
class TrainLoopCfg:
    steps: int = 1000
    batch_size: int = 16
    log_every: int = 50
    ckpt_every: int = 1000
    ckpt_dir: Optional[str] = None
    mosaic_prob: float = 0.0
    mixup_prob: float = 0.0
    # torch.profiler: a chrome trace of steps
    # [profile_start, profile_start + profile_steps) into profile_dir
    profile_dir: Optional[str] = None
    profile_start: int = 20
    profile_steps: int = 5


def make_batch_iterator(cfg: ModelCfg, loop_cfg: TrainLoopCfg,
                        sample_fn: Callable[[np.random.Generator], Dict],
                        text_embed_fn: Callable[[Sequence[str]],
                                                np.ndarray],
                        seed: int = 0, num_workers: int = 8,
                        start_batch: int = 0,
                        mesh: Optional[Mesh] = None) -> Iterator[Batch]:
    """Static-shape Batches from host samples.

    sample_fn(rng) -> {image (HWC u8 at cfg.img_size), gt_bboxes,
    gt_labels, texts (list of prompt strings)}; each sample is built from
    its own rng, seeded from `seed`'s stream. `start_batch` skips that
    many batches' seeds without building them, so a resumed run reads
    the batches an uninterrupted one would. With `mesh`, each batch is
    this rank's rows (`Mesh.rows`) of the global batch of
    `loop_cfg.batch_size`: the same samples, built from the same seeds.
    """
    h, w = cfg.img_size
    g = cfg.train.max_gt_per_image
    if mesh is not None and loop_cfg.batch_size % mesh.shape["data"]:
        raise ValueError(f"batch_size {loop_cfg.batch_size} does not divide "
                         f"over the data axis of {mesh.shape['data']}")

    def build_one(rng: np.random.Generator) -> Dict:
        from wedetect_tpu_torch.data.augment import (merge_mixed_texts,
                                                     mixup2, mosaic4)

        s = sample_fn(rng)
        if loop_cfg.mosaic_prob and rng.uniform() < loop_cfg.mosaic_prob:
            import cv2

            # remap every part's labels into the union text list
            # before mixing (reference _update_label_text)
            parts = [s] + [sample_fn(rng) for _ in range(3)]
            union, parts = merge_mixed_texts(parts)
            m = mosaic4(parts, img_scale=max(h, w) // 2, rng=rng)
            img = cv2.resize(m["image"], (w, h),
                             interpolation=cv2.INTER_LINEAR)
            r = w / m["image"].shape[1]
            s = {"image": img, "gt_bboxes": m["gt_bboxes"] * r,
                 "gt_labels": m["gt_labels"], "texts": union}
        if loop_cfg.mixup_prob and rng.uniform() < loop_cfg.mixup_prob:
            other = sample_fn(rng)
            union, (s2, other) = merge_mixed_texts([s, other])
            s = mixup2(s2, other, rng)
            s["texts"] = union
        return s

    rng0 = np.random.default_rng(seed)
    for _ in range(start_batch):
        rng0.integers(0, 2**31, loop_cfg.batch_size)
    # no context manager: an abandoned generator would run the pool's
    # __exit__ during interpreter teardown
    pool = cf.ThreadPoolExecutor(num_workers)
    while True:
        seeds = rng0.integers(0, 2**31, loop_cfg.batch_size)
        if mesh is not None:
            seeds = seeds[mesh.rows(len(seeds))]
        futs = [pool.submit(build_one, np.random.default_rng(int(sd)))
                for sd in seeds]
        samples = [f.result() for f in futs]
        images = np.stack([s["image"] for s in samples])
        gtb = np.zeros((len(samples), g, 4), np.float32)
        gtl = np.zeros((len(samples), g), np.int32)
        gtm = np.zeros((len(samples), g), bool)
        # per-row text banks: every sample carries its own (shuffled,
        # sampled) class list. K is the config's static class count; gts
        # whose labels exceed it are dropped (RandomLoadText's unsampled
        # classes)
        k_max = cfg.num_classes
        embs = []
        for i, s in enumerate(samples):
            texts = list(s.get("texts") or [])
            labels = np.asarray(s["gt_labels"])
            boxes = np.asarray(s["gt_bboxes"]).reshape(-1, 4)
            keep = labels < k_max
            labels, boxes = labels[keep], boxes[keep]
            n = min(len(boxes), g)
            gtb[i, :n] = boxes[:n]
            gtl[i, :n] = labels[:n]
            gtm[i, :n] = True
            texts = (texts + [""] * k_max)[:k_max]
            embs.append(text_embed_fn(texts))
        yield Batch(images=images, texts=np.stack(embs), gt_bboxes=gtb,
                    gt_labels=gtl, gt_mask=gtm)


def _profiler(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    return prof


def run_training(cfg: ModelCfg, state: TrainState,
                 batches: Iterator[Batch], loop_cfg: TrainLoopCfg,
                 log_fn: Callable[[int, Dict], None] = None
                 ) -> TrainState:
    """Steps from state.step to loop_cfg.steps, over `state.mesh` where
    the state has one (the batches are then this rank's rows). A log
    line every `log_every` steps: the window's mean loss, and the last
    step's loss parts, num_pos and grad_norm (global values on every
    rank), and the global batch's img/s over the window; the default
    log_fn prints on rank 0 only."""
    mesh = state.mesh
    data = 1 if mesh is None else mesh.shape["data"]
    if log_fn is None:
        log_fn = (lambda s, m: print(m, flush=True)) if (
            mesh is None or mesh.rank == 0) else (lambda s, m: None)
    t0 = time.time()
    window: List[torch.Tensor] = []
    prof = None
    for step in range(int(state.step), loop_cfg.steps):
        if loop_cfg.profile_dir is not None:
            if step == loop_cfg.profile_start:
                prof = _profiler(loop_cfg.profile_dir)
            elif (prof is not None and step
                  == loop_cfg.profile_start + loop_cfg.profile_steps):
                prof = _stop_profiler(prof, loop_cfg.profile_dir)
        batch = next(batches)
        state, metrics = train_step(cfg, state, batch)
        # the loss stays a device tensor: reading it here would wait for
        # the card every step and serialize batch building against it
        window.append(metrics["loss"])
        if (step + 1) % loop_cfg.log_every == 0:
            msg = {"step": step + 1,
                   "loss": float(np.mean([float(x) for x in window])),
                   **{k: float(metrics[k]) for k in
                      ("loss_cls", "loss_bbox", "loss_dfl", "num_pos",
                       "grad_norm")},
                   "img_per_s": len(window) * len(batch.images) * data
                   / max(time.time() - t0, 1e-9)}
            log_fn(step, msg)
            window.clear()
            t0 = time.time()
        if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
            from wedetect_tpu_torch.ckpt.io import save_train_state

            save_train_state(f"{loop_cfg.ckpt_dir}/step_{step + 1}", state)
    if prof is not None:
        _stop_profiler(prof, loop_cfg.profile_dir)
    return state


def _stop_profiler(prof, log_dir: str) -> None:
    prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
