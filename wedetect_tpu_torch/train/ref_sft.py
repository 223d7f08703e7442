"""WeDetect-Ref stage-3 SFT: focal loss on proposal scores.

Port of `wedetect_tpu/train/ref_sft.py` (reference
wedetect_ref/sft_referring.py):
- soft labels (:262-278): proposals IoU-matched to gt; gt boxes with no
  proposal above 0.5 are appended as extra proposals; the combined set
  is shuffled; label = max-IoU vs gts where > 0.5 else 0
- loss: sigmoid focal over <object> logits (qwen3vl_referring.py:426-445)
- 3-tier learning rates (:107-198 CustomTrainer.create_optimizer):
  visual tower x0.1, body x1, out_proj x10
- launch: lr 1e-5, vision frozen (scripts/run_stage3.sh)

One step runs the whole `RefModules` forward and backward (the vision
tower's gradient is computed and enters `grad_norm` even when frozen,
as in JAX), so every step runs the flash backward kernels of the ViT
(K3-bwd) and of the decoder (K2-bwd) on the card. The JAX package's
fsdp sharding over a mesh is not ported (one card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wedetect_tpu_torch.ckpt.convert_ref import jax_param_paths
from wedetect_tpu_torch.models.ref import RefModules, sigmoid_focal_loss
from wedetect_tpu_torch.train.optimizer import (Optimizer, Schedule,
                                                global_norm, make_optimizer)
from wedetect_tpu_torch.train.train_step import TrainState


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix (len(a), len(b)) of xyxy boxes (the JAX package's
    eval/coco_map.box_iou_xyxy without crowd columns)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:4] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:4] - b[:, :2], 0, None), -1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def build_soft_labels(gt_boxes: np.ndarray, proposals: np.ndarray,
                      rng: np.random.Generator,
                      iou_thr: float = 0.5
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(proposals', labels): unmatched gts appended, set shuffled,
    label = max IoU vs gts where > iou_thr else 0."""
    proposals = np.asarray(proposals, np.float32).reshape(-1, 4)
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    if len(gt_boxes) == 0:
        return proposals, np.zeros(len(proposals), np.float32)
    ious = box_iou_xyxy(gt_boxes, proposals)
    best_per_gt = ious.max(axis=1) if len(proposals) else \
        np.zeros(len(gt_boxes))
    proposals = np.concatenate(
        [proposals, gt_boxes[best_per_gt < iou_thr]], axis=0)
    proposals = proposals[rng.permutation(len(proposals))]
    ious = box_iou_xyxy(gt_boxes, proposals).max(axis=0)
    labels = np.where(ious > iou_thr, ious, 0.0).astype(np.float32)
    return proposals, labels


def ref_named_params(model: RefModules):
    """(JAX param path, tensor) of every parameter of `model`."""
    paths = jax_param_paths(model.cfg)
    return [(paths[n], p) for n, p in model.named_parameters()]


def ref_optimizer(model: RefModules, base_lr: float = 1e-5,
                  weight_decay: float = 0.0, freeze_vision: bool = True,
                  lr_schedule: Optional[Schedule] = None) -> Optimizer:
    """3-tier LRs; optionally zero out the vision tower entirely
    (stage-3 freezes it — run_stage3.sh)."""
    mults = {"vision": 0.0 if freeze_vision else 0.1, "out_proj": 10.0}
    return make_optimizer(ref_named_params(model), base_lr=base_lr,
                          weight_decay=weight_decay, lr_schedule=lr_schedule,
                          custom_lr_mults=mults)


def ref_sft_step(cfg, grid_h: int, grid_w: int, state: TrainState, patches,
                 input_ids, attn_mask, position_ids, visual_start: int,
                 boxes, ori_wh, object_positions, labels, valid=None
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One stage-3 step, updating `state` in place. labels: (B, N) soft
    IoU targets for the object slots; valid: optional (B, N) 0/1 masking
    proposal-axis padding. Metrics stay on the device: loss, grad_norm
    (over every gradient, the frozen vision tower's included) and
    num_pos."""
    model = state.model
    dev = model.device
    model.zero_grad(set_to_none=True)
    logits = model(patches, input_ids, attn_mask, position_ids, boxes,
                   ori_wh, visual_start, object_positions, grid_h=grid_h,
                   grid_w=grid_w)
    labels = torch.as_tensor(labels, device=dev, dtype=torch.float32)
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).reshape(-1)
    loss = sigmoid_focal_loss(logits.reshape(-1), labels.reshape(-1),
                              valid=valid)
    loss.backward()
    grad_norm = global_norm(state.tx.grads())
    state.tx.step()
    state.step += 1
    return state, {"loss": loss.detach(), "grad_norm": grad_norm,
                   "num_pos": (labels > 0).sum()}
