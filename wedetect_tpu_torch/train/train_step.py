"""The train state and the detector's training step.

Port of `wedetect_tpu/train/train_step.py` (reference
YOLOWorldDetector.loss, yolo_world.py:26-33 -> YOLOWorldHead.loss_by_feat,
yolo_world_head.py:436-576). The JAX state carries the step counter,
the params, the batch statistics, the optax state and the
transformation; here the model holds the params and the BN running
statistics (its buffers) and `train/optimizer.Optimizer` its own state,
updating the params in place.

- gt boxes come padded to cfg.train.max_gt_per_image with a validity
  mask (`Batch`, built by `train/loop.make_batch_iterator`).
- text embeddings arrive precomputed, (B, K, C) per row or (K, C); the
  Uni variant (cfg.num_prompts) scores against its own prompt bank.
- the loss is scaled by the global batch size (the reference's
  `num_imgs * world_size`).
- drop path draws its masks from a torch.Generator seeded per step
  (`drop_path_generator`); at rate 0 none is made.

Over a `parallel/mesh.Mesh` (`TrainState.create(..., mesh=)`), each rank
takes its rows of the global batch and the step is the JAX package's
global-view step on a mesh of that shape: BatchNorm's statistics and
drop path's masks are the global batch's (`attach_mesh`), the loss
normalisers are global sums (`train/losses.py`), the gradients are
summed over the data group, and with an fsdp axis above 1 the
parameters, their gradients and the optimizer's state are this rank's
slices (`parallel/fsdp.shard_params`, `train/optimizer.Optimizer.shard`:
ZeRO-3, each unit of the model gathered for its forward and again for
its backward); the BatchNorms' running statistics, buffers, stay whole,
as JAX replicates its batch_stats. The logged loss, num_pos and
grad_norm are the global values on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from wedetect_tpu_torch.configs import ModelCfg
from wedetect_tpu_torch.models.wedetect import _as, _images
from wedetect_tpu_torch.ops.boxes import distance2bbox
from wedetect_tpu_torch.ops.priors import flat_priors_and_strides
from wedetect_tpu_torch.parallel.fsdp import forward_scope
from wedetect_tpu_torch.parallel.mesh import Mesh
from wedetect_tpu_torch.train.assigner import assign
from wedetect_tpu_torch.train.losses import DetLosses, detection_loss
from wedetect_tpu_torch.train.optimizer import Optimizer, make_optimizer

# drop path's per-step seed is DROP_PATH_SEED * 2**32 + step (JAX folds
# the step into PRNGKey(17); the two RNGs draw different masks)
DROP_PATH_SEED = 17


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer
    mesh: Optional[Mesh] = None

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer,
               mesh: Optional[Mesh] = None, device=None) -> "TrainState":
        """The state at step 0; over `mesh`, the model's BatchNorms and
        drop paths take the mesh's data group (`attach_mesh`), an fsdp
        axis above 1 shards the parameters (`parallel/fsdp.shard_params`:
        this rank's slices, and the whole tensors and buffers, moved to
        `device` if given, so a model built on the host never sits whole
        on the card) and the optimizer shards its state, on the
        parameters' devices (`Optimizer.shard`)."""
        if mesh is not None:
            from wedetect_tpu_torch.parallel.fsdp import shard_params

            attach_mesh(model, mesh)
            shard_params(model, mesh, device=device)
            tx.shard(mesh)
        return cls(step=0, model=model, tx=tx, mesh=mesh)


def attach_mesh(model: nn.Module, mesh: Mesh) -> None:
    """Give every train-mode BatchNorm (`nn/layers.BatchNorm2d`) and
    ConvNeXt block (its drop path) the mesh's data group, or none where
    the data axis is 1 (the one-process path)."""
    from wedetect_tpu_torch.nn.convnext import ConvNeXtBlock
    from wedetect_tpu_torch.nn.layers import BatchNorm2d

    group = mesh.data_group if mesh.shape["data"] > 1 else None
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, ConvNeXtBlock)):
            m.group = group


class Batch(NamedTuple):
    """Static-shape training batch (collate output); numpy arrays or
    tensors."""

    images: np.ndarray     # (B, H, W, 3) uint8 RGB (already letterboxed)
    texts: np.ndarray      # (B, K, C) or (K, C) text embeddings
    gt_bboxes: np.ndarray  # (B, G, 4) xyxy in input pixels, zero-padded
    gt_labels: np.ndarray  # (B, G) int32
    gt_mask: np.ndarray    # (B, G) bool


def det_named_params(model: nn.Module):
    """(JAX param path, tensor) of every parameter of a WeDetectModule,
    for the optimizer's decay mask and lr multipliers."""
    from wedetect_tpu_torch.ckpt.convert import jax_param_paths

    paths = jax_param_paths(model.cfg)
    return [(paths[n], p) for n, p in model.named_parameters()]


def det_optimizer(model: nn.Module, **kw) -> Optimizer:
    """`make_optimizer` over the detector's (JAX path, tensor) pairs."""
    return make_optimizer(det_named_params(model), **kw)


def drop_path_generator(cfg: ModelCfg, step: int,
                        device) -> Optional[torch.Generator]:
    """The step's generator for the backbone's drop path masks; None at
    rate 0 (no mask is drawn)."""
    if not cfg.drop_path_rate:
        return None
    return torch.Generator(device=device).manual_seed(
        DROP_PATH_SEED * 2 ** 32 + int(step))


def loss_fn(cfg: ModelCfg, model: nn.Module, batch: Batch,
            generator: Optional[torch.Generator] = None,
            mesh: Optional[Mesh] = None
            ) -> Tuple[torch.Tensor, DetLosses]:
    """The detector's loss on `batch`, with the model in train mode (BN
    on batch statistics, its running statistics updated; drop path from
    `generator`); the model's mode is restored afterwards. Over `mesh`,
    `batch` is this rank's rows and the loss is its share of the global
    batch's (module docstring)."""
    dev = next(model.parameters()).device
    images = _images(batch.images, dev)
    texts = None if cfg.num_prompts else _as(batch.texts, dev,
                                             torch.float32)
    was_training = model.training
    model.train()
    try:
        with forward_scope(model):
            out = model(images, texts, generator=generator)
    finally:
        model.train(was_training)

    priors, strides = flat_priors_and_strides(
        cfg.feat_sizes(tuple(images.shape[2:])), cfg.strides)
    priors = torch.from_numpy(priors).to(dev)
    strides = torch.from_numpy(strides).to(dev)
    pred_bboxes = distance2bbox(priors[None],
                                out.dists.float() * strides[None, :, None])
    t = cfg.train
    group = None if mesh is None else mesh.data_group
    rows = images.shape[0] * (1 if mesh is None else mesh.shape["data"])
    res = assign(pred_bboxes, torch.sigmoid(out.logits), priors,
                 _as(batch.gt_labels, dev), _as(batch.gt_bboxes, dev,
                                                torch.float32),
                 _as(batch.gt_mask, dev, torch.bool),
                 num_classes=out.logits.shape[-1], topk=t.tal_topk,
                 alpha=t.tal_alpha, beta=t.tal_beta, eps=t.tal_eps)
    losses = detection_loss(cfg, out.logits, pred_bboxes, out.dist_logits,
                            res.bboxes, res.scores, res.fg_mask, priors,
                            strides, loss_scale=float(rows), group=group)
    return losses.total, losses


def train_step(cfg: ModelCfg, state: TrainState, batch: Batch
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step, updating `state` in place. Metrics stay on the device:
    loss, loss_cls, loss_bbox, loss_dfl, num_pos and grad_norm (the
    global norm of the gradients before the update)."""
    model = state.model
    dev = next(model.parameters()).device
    model.zero_grad(set_to_none=True)
    total, losses = loss_fn(cfg, model, batch,
                            drop_path_generator(cfg, state.step, dev),
                            state.mesh)
    total.backward()
    grad_norm = state.tx.grad_norm()
    state.tx.step()
    state.step += 1
    parts = torch.stack([total.detach(), losses.cls.detach(),
                         losses.bbox.detach(), losses.dfl.detach()])
    if state.mesh is not None:
        state.mesh.data_group.all_reduce(parts)
    return state, {"loss": parts[0], "loss_cls": parts[1],
                   "loss_bbox": parts[2], "loss_dfl": parts[3],
                   "num_pos": losses.num_pos, "grad_norm": grad_norm}
