"""Detection losses: BCE cls, CIoU box, Distribution Focal Loss.

Port of `wedetect_tpu/train/losses.py` (reference yolov8_head.py
loss_by_feat, used via yolo_world_head.py:436-576, with the config
weights loss_cls 0.5 (sigmoid BCE, sum / assigned_sum), loss_bbox 7.5
(CIoU, weighted by each anchor's assigned score sum, / assigned_sum),
loss_dfl 1.5 / 4 (DFL on stride-normalized ltrb targets, weighted, /
assigned_sum); config/wedetect_base.py:82-97).

Every anchor is masked, never gathered: each contributes a term whose
weight may be zero, so the work does not depend on the number of
positives.

Under a data group of several ranks (`group`), each rank holds its rows
of the global batch: the normalisers `assigned_sum` and `num_pos` are
summed over the group (outside autograd), so each rank's loss is its
share of the global batch's loss and the gradients sum over the ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from wedetect_tpu_torch.configs import ModelCfg
from wedetect_tpu_torch.ops.boxes import bbox2distance, bbox_overlaps_aligned


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid BCE (F.binary_cross_entropy_with_logits's
    formula, written out as the JAX package does)."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def dfl_loss(dist_logits: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    """Distribution Focal Loss per element: dist_logits (..., reg_max),
    target (...) continuous in [0, reg_max - 1]; CE to the two adjacent
    bins with linear weights."""
    tl = torch.floor(target)
    tr = tl + 1.0
    wl = tr - target
    wr = target - tl
    logp = F.log_softmax(dist_logits, dim=-1)
    reg_max = dist_logits.shape[-1]
    ce_l = -logp.gather(-1, tl.clamp(0, reg_max - 1).long()[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(0, reg_max - 1).long()[..., None])[..., 0]
    return ce_l * wl + ce_r * wr


class DetLosses(NamedTuple):
    total: torch.Tensor
    cls: torch.Tensor
    bbox: torch.Tensor
    dfl: torch.Tensor
    num_pos: torch.Tensor


def detection_loss(cfg: ModelCfg,
                   cls_logits: torch.Tensor,       # (B, A, K)
                   pred_bboxes: torch.Tensor,      # (B, A, 4) image units
                   dist_logits: torch.Tensor,      # (B, A, 4, reg_max)
                   assigned_bboxes: torch.Tensor,  # (B, A, 4)
                   assigned_scores: torch.Tensor,  # (B, A, K)
                   fg_mask: torch.Tensor,          # (B, A) bool
                   priors_xy: torch.Tensor,        # (A, 2)
                   strides: torch.Tensor,          # (A,)
                   loss_scale: float = 1.0, group=None) -> DetLosses:
    """The combined loss. `loss_scale` is the reference's
    `num_imgs * world_size` factor (yolo_world_head.py:570-576): the
    train step passes the global batch size. `group`: the data group
    (a `parallel/collectives.Group`) over which the normalisers sum."""
    t = cfg.train
    cls_logits = cls_logits.float()
    fg = fg_mask.float()
    if group is not None and group.size > 1:
        sums = group.all_reduce(torch.stack(
            [assigned_scores.sum(), fg.sum()]).detach())
        assigned_sum, num_pos = sums[0].clamp(min=1.0), sums[1]
    else:
        assigned_sum = assigned_scores.sum().clamp(min=1.0)
        num_pos = fg.sum()

    loss_cls = bce_with_logits(cls_logits, assigned_scores).sum()
    loss_cls = loss_cls / assigned_sum * t.loss_cls_weight

    s = strides[None, :, None]
    pb = pred_bboxes.float() / s
    ab = assigned_bboxes.float() / s
    bbox_weight = assigned_scores.sum(-1) * fg                 # (B, A)
    ciou = bbox_overlaps_aligned(pb, ab, iou_mode="ciou")
    loss_bbox = ((1.0 - ciou) * bbox_weight).sum()
    loss_bbox = loss_bbox / assigned_sum * t.loss_bbox_weight

    target_ltrb = bbox2distance(priors_xy[None] / s, ab,
                                max_dis=cfg.reg_max - 1, eps=0.01)
    ldfl = dfl_loss(dist_logits.float(), target_ltrb)          # (B, A, 4)
    loss_dfl = (ldfl * bbox_weight[..., None]).sum()
    loss_dfl = loss_dfl / assigned_sum * t.loss_dfl_weight

    total = (loss_cls + loss_bbox + loss_dfl) * loss_scale
    return DetLosses(total=total, cls=loss_cls, bbox=loss_bbox,
                     dfl=loss_dfl, num_pos=num_pos)


def cov_mse_loss(pred: torch.Tensor, dim: int = 0,
                 eps: float = 1e-6) -> torch.Tensor:
    """Coefficient-of-variation MSE against zero (reference
    dynamic_loss.py:12-38, CoVMSELoss, registered but unused by the
    shipped configs): cov = std / clip(mean, eps) along `dim` with the
    unbiased std; loss = mean(cov^2)."""
    pred = pred.float()
    n = pred.shape[dim]
    mean = pred.mean(dim=dim)
    var = (pred - mean.unsqueeze(dim)).square().sum(dim=dim) / max(n - 1, 1)
    cov = torch.sqrt(var) / mean.clamp(min=eps)
    return cov.square().mean()
